"""Profile-driven analytical access/latency/energy model (DESIGN.md §5;
counterpart of `repro.costmodel.model`).

The numbers come from loadable characterization tables
(`costmodel.profiles`), so the same model retargets to any design point —
the shipped `paper_fpga_45nm` table reproduces the paper's headline
ratios (−53.3% latency, −42% memory accesses, −52.2% energy) within ±3
points on the checked-in measured trace. It models the paper's FPGA/ASIC
datapath, not the card the port runs on.

Model structure (per engine pass at stage s, window of N_s retained
events, grid of P_s pixels, C channels, `vote_taps` bilinear taps):

  accumulate path
    baseline : every event performs read-modify-write on vote_taps x C
               channels; taps serialize on the IWE SRAM ports with an RMW
               turnaround stall (`base_cyc_per_event * base_rmw_stall`
               cycles/event — the one constant calibrated to the paper's
               latency delta, every other input is measured).
    CAMEL    : banked voting (conflict-free, `camel_cyc_per_event`
               cyc/event) + local accumulation + pending merge ->
               effective updates = (1 - merge_reduction) * vote_taps * C
               writes per event.
  blur path
    both     : read IWE group once (C*P_s) + clear (C*P_s writes);
               line-buffer traffic C*P_s writes + C*P_s*taps reads for a
               `taps`-wide vertical window (the per-stage Gaussian width —
               3/5/9 taps).
    baseline : additionally writes blurred images back (C*P_s), then a
               mean pass (P_s reads) and a var/grad pass (C*P_s reads).
  sorting (once per stage entry)
    count (N reads raw + 2N cnt RMW) + scan (2*P_s) + permute (N reads +
    N rank RMW + n_ret perm writes); the baseline skips the
    full-resolution sort (paper §5.1).

Latency (cycles @ `freq_hz`) per pass: event path + blur path + fixed
overhead. Energy: per-access energies and leakage per memory group, logic
power from the profile; E_total = E_mem_dyn + (P_logic + P_leak) * T.
The paper reports the same SoC envelope for both designs, so the shipped
paper profile carries the same logic power on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from . import profiles as profile_io


@dataclasses.dataclass(frozen=True)
class MemGroup:
    """One on-chip memory group (paper Table 5)."""
    e_read_pj: float
    e_write_pj: float
    leak_mw: float
    size_kb: int


_PAPER = profile_io.read_profile_dict("paper_fpga_45nm")


def _grp(d: Dict[str, Dict[str, object]], g: str) -> MemGroup:
    return MemGroup(**d[f"memory.{g}"])


@dataclasses.dataclass(frozen=True)
class HwParams:
    """One hardware design point. The defaults ARE the shipped
    `paper_fpga_45nm` characterization table — `HwParams()` and
    `load_profile("paper_fpga_45nm")` are the same object value."""
    name: str = _PAPER["meta"]["name"]
    freq_hz: float = _PAPER["pipeline"]["freq_hz"]
    iwe: MemGroup = _grp(_PAPER, "iwe")
    raw: MemGroup = _grp(_PAPER, "raw")
    sort: MemGroup = _grp(_PAPER, "sort")
    line: MemGroup = _grp(_PAPER, "line")
    logic_mw_camel: float = _PAPER["logic"]["camel_mw"]
    logic_mw_baseline: float = _PAPER["logic"]["baseline_mw"]
    camel_cyc_per_event: float = _PAPER["pipeline"]["camel_cyc_per_event"]
    base_cyc_per_event: float = _PAPER["pipeline"]["base_cyc_per_event"]
    base_rmw_stall: float = _PAPER["pipeline"]["base_rmw_stall"]
    blur_px_per_cyc: float = _PAPER["pipeline"]["blur_px_per_cyc"]
    pass_overhead_cyc: float = _PAPER["pipeline"]["pass_overhead_cyc"]
    sort_cyc_per_event: float = _PAPER["pipeline"]["sort_cyc_per_event"]
    real_time_bound_s: float = _PAPER["pipeline"]["real_time_bound_s"]
    vote_taps: int = _PAPER["pipeline"]["vote_taps"]
    channels: int = _PAPER["pipeline"]["channels"]


def load_profile(name_or_path: str) -> HwParams:
    """Load + validate a characterization table into an `HwParams`."""
    d = profile_io.read_profile_dict(name_or_path)
    return HwParams(
        name=d["meta"]["name"],
        freq_hz=d["pipeline"]["freq_hz"],
        iwe=_grp(d, "iwe"), raw=_grp(d, "raw"),
        sort=_grp(d, "sort"), line=_grp(d, "line"),
        logic_mw_camel=d["logic"]["camel_mw"],
        logic_mw_baseline=d["logic"]["baseline_mw"],
        camel_cyc_per_event=d["pipeline"]["camel_cyc_per_event"],
        base_cyc_per_event=d["pipeline"]["base_cyc_per_event"],
        base_rmw_stall=d["pipeline"]["base_rmw_stall"],
        blur_px_per_cyc=d["pipeline"]["blur_px_per_cyc"],
        pass_overhead_cyc=d["pipeline"]["pass_overhead_cyc"],
        sort_cyc_per_event=d["pipeline"]["sort_cyc_per_event"],
        real_time_bound_s=d["pipeline"]["real_time_bound_s"],
        vote_taps=d["pipeline"]["vote_taps"],
        channels=d["pipeline"]["channels"],
    )


# ----------------------------------------------------------------------
# per-window accounting
# ----------------------------------------------------------------------


@dataclasses.dataclass
class Account:
    """Access counts per memory group + cycles, for one window."""
    iwe_r: float = 0.0
    iwe_w: float = 0.0
    raw_r: float = 0.0
    raw_w: float = 0.0
    sort_r: float = 0.0
    sort_w: float = 0.0
    line_r: float = 0.0
    line_w: float = 0.0
    cycles: float = 0.0

    @property
    def total_accesses(self) -> float:
        return (self.iwe_r + self.iwe_w + self.raw_r + self.raw_w
                + self.sort_r + self.sort_w + self.line_r + self.line_w)

    def energy_uj(self, hw: HwParams, camel: bool) -> Dict[str, float]:
        t = self.cycles / hw.freq_hz
        mem_dyn_pj = (self.iwe_r * hw.iwe.e_read_pj + self.iwe_w * hw.iwe.e_write_pj
                      + self.raw_r * hw.raw.e_read_pj + self.raw_w * hw.raw.e_write_pj
                      + self.sort_r * hw.sort.e_read_pj + self.sort_w * hw.sort.e_write_pj
                      + self.line_r * hw.line.e_read_pj + self.line_w * hw.line.e_write_pj)
        leak_mw = (hw.iwe.leak_mw + hw.raw.leak_mw + hw.sort.leak_mw
                   + hw.line.leak_mw)
        logic_mw = hw.logic_mw_camel if camel else hw.logic_mw_baseline
        e_mem = mem_dyn_pj * 1e-6                  # pJ -> uJ
        e_logic_leak = (logic_mw + leak_mw) * 1e-3 * t * 1e6  # W*s -> uJ
        return dict(e_mem_rw_uj=e_mem, e_logic_leak_uj=e_logic_leak,
                    e_total_uj=e_mem + e_logic_leak, latency_s=t)


def account_stage(acc: Account, hw: HwParams, *, camel: bool, passes: float,
                  n_ret: float, n_total: float, P: float, taps: int,
                  merge_reduction: float, sort_this_stage: bool) -> None:
    """Accumulate one stage's traffic+cycles into `acc` (in place).

    `taps` is the stage's vertical blur width (3/5/9): a taps-wide window
    reads taps line-buffer entries per output pixel. Fractional `passes`
    are accounted proportionally — the per-pass traffic is identical
    across passes, so a budget allocation of e.g. 2.5 passes costs exactly
    2.5x one pass (no silent rounding).
    """
    C = hw.channels
    # --- sorting (once per stage entry) ---
    if sort_this_stage:
        acc.raw_r += 2 * n_total                     # count + permute reads
        acc.sort_r += 2 * n_total + P                # cnt RMW reads + scan
        acc.sort_w += 2 * n_total + P + n_ret        # cnt/rank writes + perm
        acc.cycles += hw.sort_cyc_per_event * n_total + P

    # --- per-pass traffic: event path (warp + vote + accumulate) ---
    raw_r = n_ret
    iwe_r = iwe_w = 0.0
    if camel:
        ev_cyc = hw.camel_cyc_per_event * n_ret
        iwe_w += (1.0 - merge_reduction) * n_ret * C * hw.vote_taps
    else:
        ev_cyc = hw.base_cyc_per_event * hw.base_rmw_stall * n_ret
        iwe_r += n_ret * C * hw.vote_taps
        iwe_w += n_ret * C * hw.vote_taps
    # --- blur path ---
    iwe_r += C * P                                   # read accumulated imgs
    iwe_w += C * P                                   # clear for next pass
    # a taps-wide vertical window: each pixel enters the line-buffer group
    # once and is read back once per tap row it participates in
    line_w = C * P
    line_r = C * P * taps
    blur_cyc = P / hw.blur_px_per_cyc
    if not camel:
        iwe_w += C * P                               # blurred writeback
        iwe_r += P + C * P                           # mean pass + var/grad
        blur_cyc += 2 * P                            # extra passes
    # accumulate and blur are sequential phases of a pass
    acc.raw_r += passes * raw_r
    acc.iwe_r += passes * iwe_r
    acc.iwe_w += passes * iwe_w
    acc.line_r += passes * line_r
    acc.line_w += passes * line_w
    acc.cycles += passes * (ev_cyc + blur_cyc + hw.pass_overhead_cyc)


def account_window(stage_stats: List[Dict[str, float]], cfg, hw: HwParams,
                   *, camel: bool, n_total: int
                   ) -> Tuple[Account, Dict[str, float]]:
    """Full-window account. `stage_stats` has per-stage dicts with keys
    passes, n_retained, P, taps, merge_reduction; `cfg` is a CmaxConfig
    (only its stage scales are consulted, to find the full-res stage)."""
    acc = Account()
    for si, st in enumerate(stage_stats):
        is_full_res = (si == len(stage_stats) - 1
                       and cfg.stages[si].scale >= 1.0)
        sort_here = camel or not is_full_res   # baseline skips full-res sort
        account_stage(
            acc, hw, camel=camel, passes=st["passes"],
            n_ret=st["n_retained"], n_total=n_total, P=st["P"],
            taps=st["taps"],
            merge_reduction=(st["merge_reduction"] if camel else 0.0),
            sort_this_stage=sort_here)
    return acc, acc.energy_uj(hw, camel)


# ----------------------------------------------------------------------
# per-pass cost estimates (the scheduler's currency)
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PassCost:
    """Cost of one marginal engine pass (or one sort) at a stage."""
    cycles: float
    seconds: float
    energy_uj: float
    accesses: float


def _cost_of(acc: Account, hw: HwParams, camel: bool) -> PassCost:
    e = acc.energy_uj(hw, camel)
    return PassCost(cycles=acc.cycles, seconds=e["latency_s"],
                    energy_uj=e["e_total_uj"], accesses=acc.total_accesses)


def pass_cost(hw: HwParams, *, n_ret: float, P: float, taps: int,
              merge_reduction: float = 0.0, camel: bool = True) -> PassCost:
    """Marginal cost of ONE additional engine pass at a stage — what one
    adaptive iteration costs the budget scheduler."""
    acc = Account()
    account_stage(acc, hw, camel=camel, passes=1.0, n_ret=n_ret, n_total=0,
                  P=P, taps=taps, merge_reduction=merge_reduction,
                  sort_this_stage=False)
    return _cost_of(acc, hw, camel)


def sort_cost(hw: HwParams, *, n_total: float, n_ret: float, P: float,
              camel: bool = True) -> PassCost:
    """Fixed stage-entry cost (the sort) — spent before any iteration."""
    acc = Account()
    account_stage(acc, hw, camel=camel, passes=0.0, n_ret=n_ret,
                  n_total=n_total, P=P, taps=1, merge_reduction=0.0,
                  sort_this_stage=True)
    return _cost_of(acc, hw, camel)
