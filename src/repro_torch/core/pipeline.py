"""CMAX estimation pipeline: warp -> sort -> iterate -> promote (counterpart
of `repro.core.pipeline`).

  for each stage s in {1/4, 1/2, 1}:                     (coarse-to-fine)
      sort_events(...)            # once per stage entry (Alg. 3)
      entry pass: (V_prev, grad)  # Alg. 1 line 2
      residence loop:             # runtime-adaptive (Alg. 1)
          omega <- CG-PR(omega, grad)          # Update(omega, s)
          engine pass: IWE+dIWE -> blur -> (V, grad)     # one pass/iter
          g = (V - V_prev)/|V_prev|
          adaptive:  stay iff g >= tau_s  (else promote / terminate)
          fixed:     stay iff iter < fixed_iters[s]

The reference's `lax.while_loop` is a host loop here, and there is one:
every entry point runs it in masked lockstep (`_run_stage_batched`), the
per-window ones (`estimate_window`, `estimate_sequence`) as batches of one
squeezed back. One engine pass per iteration covers the whole batch,
finished windows keep their carry verbatim, and every iteration reads one
stop flag back from the device (one device->host sync per iteration); the
loop stops when no window is active — the carry-select semantics of the
reference, so a window's result does not depend on the batch it rides in.
Under engine="cuda_batched" each such pass is one call of the engine-pass
kernel for the whole batch; under engine="cuda" it is one launch each of
the tile-accumulation and blur-statistics kernels.

On a card under either kernel engine the lockstep runs on CUDA graphs
(`core.graphs`): one per stage entry (sort, entry pass, the carry's
initial value, the stop test) and one per lockstep pass, captured from the
bodies below after a class's first eager run, so a pass costs one replay
and one read of the stop flag instead of hundreds of eager launches.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..telemetry.spans import step
from . import cgpr
from .contrast import gaussian_taps, stats_to_objective, streaming_stats
from .graphs import stage_graphs, tally
from .iwe import build_iwe
from .sorting import sort_events
from .types import Camera, CmaxConfig, EventWindow, StageConfig


class StageTrace(NamedTuple):
    iters: torch.Tensor        # (...) int32 — update iterations executed
    passes: torch.Tensor       # (...) int32 — engine passes (= iters + 1)
    n_retained: torch.Tensor   # (...) int32 — events retained by Alg. 3
    v_final: torch.Tensor      # (...) f32  — variance at stage exit
    v_entry: torch.Tensor      # (...) f32  — variance at stage entry
    v_history: torch.Tensor    # (..., max_iters) f32 per-iteration variance
    omega_entry: torch.Tensor  # (..., 3) hypothesis at stage entry
    omega_exit: torch.Tensor   # (..., 3) hypothesis at stage exit


class WindowResult(NamedTuple):
    omega: torch.Tensor                 # (..., 3) final estimate
    stages: Tuple[StageTrace, ...]      # one per stage


EnginePass = Callable[[EventWindow, torch.Tensor, torch.Tensor],
                      Tuple[torch.Tensor, torch.Tensor]]


def map_result(fn: Callable[[torch.Tensor], torch.Tensor],
               res: WindowResult) -> WindowResult:
    """Apply `fn` to every tensor of a result."""
    return WindowResult(
        omega=fn(res.omega),
        stages=tuple(StageTrace(*[fn(a) for a in st]) for st in res.stages))


def stack_results(results: List[WindowResult], dim: int = 0
                  ) -> WindowResult:
    """Stack results leaf by leaf along a new axis `dim`."""
    first = results[0]
    return WindowResult(
        omega=torch.stack([r.omega for r in results], dim=dim),
        stages=tuple(
            StageTrace(*[torch.stack([r.stages[si][f] for r in results],
                                     dim=dim)
                         for f in range(len(StageTrace._fields))])
            for si in range(len(first.stages))))


def _fir_cache(stage: StageConfig, dtype):
    cache = {}

    def fir(device: torch.device) -> torch.Tensor:
        if device not in cache:
            cache[device] = gaussian_taps(stage.blur_taps, stage.blur_sigma,
                                          dtype, device=device)
        return cache[device]

    return fir


def make_engine_pass(cam: Camera, stage: StageConfig,
                     dtype=torch.float32, engine: str = "reference", *,
                     capacity: int = 4096, rb: int = 8) -> EnginePass:
    """One full engine pass at stage s: warp+vote+accumulate (IWE & dIWE),
    blur statistics, Eq. 12 objective + gradient. Returns
    fn(ev, weights, omega) -> (variance, grad(..., 3)).

    "reference" is the plain datapath and takes any leading batch axes;
    "cuda" takes one (N,) window or a (B, N) batch, `capacity` being the
    per-tile tap budget its `spilled` counts against; "cuda_batched" takes
    a (B, N) batch, the prologue plus ONE kernel call of row-slab height
    `rb` for the whole batch."""
    if engine == "cuda":
        from ..kernels.ops import fused_engine_pass
        fir = _fir_cache(stage, dtype)

        def tile_engine(ev: EventWindow, weights: torch.Tensor,
                        omega: torch.Tensor):
            v, g, _spilled = fused_engine_pass(
                ev, omega, cam, stage.scale, stage.blur_taps,
                stage.blur_sigma, weights=weights, capacity=capacity,
                fir=fir(ev.device))
            return v, g

        return tile_engine
    if engine == "cuda_batched":
        from ..kernels.ops import batched_engine_pass
        fir = _fir_cache(stage, torch.float32)

        def kernel_engine(ev: EventWindow, weights: torch.Tensor,
                          omega: torch.Tensor):
            v, g, _spilled = batched_engine_pass(
                ev, omega, cam, stage.scale, stage.blur_taps,
                stage.blur_sigma, weights=weights, rb=rb,
                fir=fir(ev.device))
            return v, g

        return kernel_engine
    if engine != "reference":
        raise ValueError(f"unknown engine {engine!r}")
    Hs, Ws = stage.grid(cam)
    fir = _fir_cache(stage, dtype)

    def reference_engine(ev: EventWindow, weights: torch.Tensor,
                         omega: torch.Tensor):
        channels = build_iwe(ev, omega, cam, stage.scale, weights=weights)
        stats = streaming_stats(channels, fir(ev.device))
        return stats_to_objective(stats, Hs * Ws)

    return reference_engine


def make_batched_engine_pass(cam: Camera, stage: StageConfig,
                             cfg: CmaxConfig) -> EnginePass:
    """`make_engine_pass` under `cfg`'s engine settings: fn(ev (B,N),
    weights (B,N), omega (B,3)) -> (variance (B,), grad (B,3))."""
    return make_engine_pass(cam, stage, cfg.dtype, cfg.engine,
                            capacity=cfg.engine_capacity, rb=cfg.engine_rb)


def stage_max_iters(cfg: CmaxConfig, stage_idx: int) -> int:
    """The iterations a window may run at stage `stage_idx`: the stage's
    `max_iters` under the adaptive schedule, else its `fixed_iters`."""
    return int(cfg.stages[stage_idx].max_iters if cfg.adaptive
               else cfg.fixed_iters[stage_idx])


def _masked_select(mask: torch.Tensor, new, old):
    """Per-leaf `where` with a (B,) mask broadcast over trailing axes."""
    if isinstance(new, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    vals = [_masked_select(mask, n, o) for n, o in zip(new, old)]
    return type(new)(*vals) if hasattr(new, "_fields") else type(new)(vals)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [a for sub in tree for a in _leaves(sub)]


class _Lockstep(NamedTuple):
    """One stage's masked lockstep over a (B,·) batch: what the entry pass
    makes and each lockstep pass updates in place. Every tensor is a
    buffer of its own, so a CUDA graph can replay over them."""

    weights: torch.Tensor      # (B, N) f32 Alg. 3 retention of the stage
    n_retained: torch.Tensor   # (B,) int32
    v_entry: torch.Tensor      # (B,) variance at stage entry
    cap: torch.Tensor          # (B,) int32 iterations a window may run
    alpha_floor: torch.Tensor  # (B,) the step at which a window gives up
    rows: torch.Tensor         # (B,) int64 rows of `hist`
    hist: torch.Tensor         # (B, max_iters) per-iteration variance
    carry: tuple               # ((omega, CgprState), v_prev, g, it, done,
                               # alpha)
    active: torch.Tensor       # (B,) bool: the windows the next pass moves
    more: torch.Tensor         # () bool: whether any window is active


def _stop_test(carry, cap: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lockstep's stop test on a carry: which windows stay active,
    and whether any does (on the device, for the host loop to read)."""
    _, _, _, it, done, _ = carry
    active = (~done) & (it < cap)                          # (B,)
    return active, active.any()


def _stage_cap(B: int, max_iters: int, iter_cap: Optional[torch.Tensor],
               dev: torch.device) -> torch.Tensor:
    """(B,) int32 iteration bound of each window at one stage."""
    cap = torch.full((B,), max_iters, dtype=torch.int32, device=dev)
    if iter_cap is not None:
        cap = torch.minimum(cap, torch.as_tensor(iter_cap, device=dev)
                            .to(torch.int32))
    return cap


def _entry_pass(ev: EventWindow, omega: torch.Tensor, tables,
                cap: torch.Tensor, stage: StageConfig, cfg: CmaxConfig,
                stage_idx: int, engine_b: EnginePass) -> _Lockstep:
    """Alg. 1 line 2 for a whole batch: the entry pass under the stage's
    sort `tables` (Alg. 3), the carry's initial value and the stop test.
    CG restarts at each stage, as the hardware does: its history does not
    transfer across resolutions, where the objective changes scale."""
    B = omega.shape[0]
    dev = omega.device
    v_entry, g_entry = engine_b(ev, tables.weights, omega)  # (B,), (B, 3)
    max_iters = stage_max_iters(cfg, stage_idx)
    alpha0 = torch.full((B,), cfg.step_size * stage.step_scale,
                        dtype=cfg.dtype, device=dev)
    ost = cgpr.init_state(3, cfg.dtype, device=dev, batch=(B,))
    # the carry owns its buffers: the caller's omega, the state's shared
    # zeros and v_entry are never updated in place
    carry = ((omega.clone(), cgpr.CgprState(*[a.clone() for a in ost])),
             v_entry.clone(), g_entry,
             torch.zeros((B,), dtype=torch.int32, device=dev),
             torch.zeros((B,), dtype=torch.bool, device=dev), alpha0)
    active, more = _stop_test(carry, cap)
    return _Lockstep(
        weights=tables.weights, n_retained=tables.n_retained,
        v_entry=v_entry, cap=cap, alpha_floor=alpha0 / 64.0,
        rows=torch.arange(B, device=dev),
        hist=torch.full((B, max_iters), float("nan"), dtype=v_entry.dtype,
                        device=dev),
        carry=carry, active=active, more=more)


def _lockstep_pass(st: _Lockstep, ev: EventWindow, stage: StageConfig,
                   cfg: CmaxConfig, engine_b: EnginePass, update) -> None:
    """One lockstep pass, written into `st` in place: CG-PR proposals for
    the whole batch, ONE batched engine pass, the accept/reject select
    (finished windows keep their carry verbatim: masked no-ops) and the
    stop test."""
    (om, ost), v_prev, g, it, done, alpha = st.carry
    with step("propose"):
        om_p, ost_p = update(om, g, ost, alpha)            # all B
    with step("engine"):
        v_p, g_p = engine_b(ev, st.weights, om_p)          # ONE batched pass
    with step("select"):
        rows, hist = st.rows, st.hist
        it_c = it.clamp(0, max(hist.shape[1] - 1, 0)).long()
        hist[rows, it_c] = torch.where(st.active, v_p, hist[rows, it_c])
        improved = v_p > v_prev
        om_n = _masked_select(improved, om_p, om)
        ost_n = _masked_select(improved, ost_p, ost)
        g_n = _masked_select(improved, g_p, g)
        alpha_n = torch.where(improved, alpha, alpha * 0.5)
        if cfg.adaptive:
            g_norm = (v_p - v_prev) / torch.clamp(torch.abs(v_prev),
                                                  min=1e-12)
            done_n = (improved & (g_norm < stage.tau)) | \
                ((~improved) & (alpha_n < st.alpha_floor))
        else:
            done_n = torch.zeros_like(improved)
        v_prev_n = torch.where(improved, v_p, v_prev)
        new = ((om_n, ost_n), v_prev_n, g_n, it + 1, done_n, alpha_n)
        kept = _masked_select(st.active, new, st.carry)
        for buf, val in zip(_leaves(st.carry), _leaves(kept)):
            buf.copy_(val)
        active, more = _stop_test(st.carry, st.cap)
        st.active.copy_(active)
        st.more.copy_(more)


def _stop_sync(more: torch.Tensor) -> bool:
    with step("stop_sync"):
        return bool(more)                      # the one sync of a pass


def _lockstep(entry: Callable[[], _Lockstep],
              lockstep: Callable[[_Lockstep], None]
              ) -> Tuple[_Lockstep, int]:
    """The residence loop's host side: the entry pass, then lockstep
    passes while any window is active, each ending in the one read of the
    stop flag. Returns the final state and the passes run."""
    with step("entry_pass"):
        st = entry()
        more = _stop_sync(st.more)
    n = 1
    while more:
        with step("pass"):
            lockstep(st)
            more = _stop_sync(st.more)
        n += 1
    return st, n


def _stage_result(st: _Lockstep, omega: torch.Tensor, own: bool
                  ) -> Tuple[torch.Tensor, StageTrace]:
    """A stage's estimate and trace from its final lockstep state; `own`
    clones them out of buffers that a later replay overwrites."""
    c = torch.clone if own else (lambda a: a)
    (om, _), v_fin, _, iters, _, _ = st.carry
    om, iters = c(om), c(iters)
    return om, StageTrace(iters=iters, passes=iters + 1,
                          n_retained=c(st.n_retained), v_final=c(v_fin),
                          v_entry=c(st.v_entry), v_history=c(st.hist),
                          omega_entry=omega, omega_exit=om)


def _run_stage_batched(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                       stage: StageConfig, cfg: CmaxConfig, stage_idx: int,
                       engine_b: EnginePass,
                       iter_cap: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, StageTrace]:
    """The residence of a whole (B,·) batch at one stage under Alg. 1 (or
    the fixed schedule), in masked lockstep.

    Update(omega, s) uses accept/reject step control: a proposal that
    decreases the variance is rejected (omega reverts) and the step halves;
    a window gives up and promotes when the step has collapsed to
    alpha0/64. One shared loop iterates until every window is done; each
    iteration is one batched engine pass, which every proposal costs, and
    finished windows keep their carry verbatim (masked no-ops). `iter_cap`,
    when given, is a (B,) int tensor. The entry pass and each pass end in
    the stop test; each opens the step spans of `telemetry.spans.STEP_SPANS`
    under a service's tracer.

    On a card under a kernel engine the loop runs on its class's CUDA
    graphs (`core.graphs`): the class's first run is eager and then
    captures `_entry_pass` (after the sort) and `_lockstep_pass`; every
    later run replays them, with the same bits."""
    B = omega.shape[0]
    cap = _stage_cap(B, stage_max_iters(cfg, stage_idx), iter_cap,
                     omega.device)
    update = cgpr.step if cfg.use_cgpr else cgpr.gradient_ascent_step

    def entry(e: EventWindow, o: torch.Tensor, c: torch.Tensor, tables):
        return _entry_pass(e, o, tables, c, stage, cfg, stage_idx, engine_b)

    def lockstep(st: _Lockstep, e: EventWindow) -> None:
        _lockstep_pass(st, e, stage, cfg, engine_b, update)

    def sort(e: EventWindow, o: torch.Tensor):
        with step("sort"):
            return sort_events(e, o, cam, stage)

    graphs = stage_graphs(ev, omega, cfg, stage_idx)
    if graphs is not None and graphs.captured:
        with graphs.bound(ev, omega, cap):
            st, _ = _lockstep(graphs.replay_entry, graphs.replay_pass)
            return _stage_result(st, omega, own=True)
    tables = sort(ev, omega)
    st, n = _lockstep(lambda: entry(ev, omega, cap, tables),
                      lambda s: lockstep(s, ev))
    if omega.is_cuda:
        tally("eager_passes", stage_idx, n)
    if graphs is not None:
        graphs.capture(ev, omega, cap,
                       lambda e, o, c: entry(e, o, c, sort(e, o)), lockstep)
    return _stage_result(st, omega, own=False)


def _estimate_batch_lockstep(windows: EventWindow, omega0s: torch.Tensor,
                             cfg: CmaxConfig,
                             iter_caps: Optional[torch.Tensor] = None
                             ) -> WindowResult:
    """Whole-batch estimation through the batched engine pass: every engine
    pass of every stage is one batched call covering the full batch."""
    cam = cfg.camera
    omega = omega0s.to(cfg.dtype)
    traces = []
    for si, stage in enumerate(cfg.stages):
        with step("stage", stage=si):
            engine_b = make_batched_engine_pass(cam, stage, cfg)
            omega, tr = _run_stage_batched(
                windows, omega, cam, stage, cfg, si, engine_b,
                iter_cap=None if iter_caps is None else iter_caps[:, si])
        traces.append(tr)
    return WindowResult(omega=omega, stages=tuple(traces))


def _squeeze0(res: WindowResult) -> WindowResult:
    return map_result(lambda a: a[0], res)


def _estimate_window(ev: EventWindow, omega0: torch.Tensor, cfg: CmaxConfig,
                     iter_caps: Optional[torch.Tensor]) -> WindowResult:
    """One window as a batch of one through the lockstep, squeezed back to
    scalar traces."""
    caps = None if iter_caps is None else iter_caps.unsqueeze(0)
    return _squeeze0(_estimate_batch_lockstep(
        ev.map(lambda a: a.unsqueeze(0)), omega0.unsqueeze(0), cfg,
        iter_caps=caps))


def estimate_window(ev: EventWindow, omega0: torch.Tensor,
                    cfg: CmaxConfig) -> WindowResult:
    """Estimate the rotation rate for one (N,) event window (warm-started
    at omega0 (3,))."""
    return _estimate_window(ev, omega0, cfg, None)


def estimate_window_budgeted(ev: EventWindow, omega0: torch.Tensor,
                             iter_caps: torch.Tensor, cfg: CmaxConfig
                             ) -> WindowResult:
    """`estimate_window` under a per-stage iteration allocation.

    `iter_caps` is an (n_stages,) int tensor of caps. The adaptive gain
    test still terminates a stage early; caps >= stage.max_iters reproduce
    `estimate_window` exactly."""
    return _estimate_window(ev, omega0, cfg, iter_caps)


def estimate_batch_budgeted(windows: EventWindow, omega0s: torch.Tensor,
                            iter_caps: torch.Tensor, cfg: CmaxConfig
                            ) -> WindowResult:
    """Batched `estimate_window_budgeted`: `iter_caps` is (B, n_stages)
    int. Per-slot results depend only on that slot's inputs."""
    return _estimate_batch_lockstep(windows, omega0s, cfg,
                                    iter_caps=iter_caps)


def estimate_sequence(windows: EventWindow, omega_init: torch.Tensor,
                      cfg: CmaxConfig) -> Tuple[torch.Tensor, WindowResult]:
    """Sequential estimation over (K, N) windows with warm starts: the one
    stream of `estimate_streams`. Returns (omegas (K,3), stacked
    WindowResult traces)."""
    omegas, res = estimate_streams(windows.map(lambda a: a.unsqueeze(0)),
                                   omega_init.unsqueeze(0), cfg)
    return omegas[0], _squeeze0(res)


def estimate_windows_parallel(windows: EventWindow, omega0s: torch.Tensor,
                              cfg: CmaxConfig) -> WindowResult:
    """Batched estimation of independent (B, N) windows (no warm-start
    chaining), in masked lockstep for every engine."""
    return _estimate_batch_lockstep(windows, omega0s, cfg)


def estimate_batch(windows: EventWindow, omega0s: torch.Tensor,
                   cfg: CmaxConfig) -> WindowResult:
    """Batched estimation of B independent windows — the serving hot path.

    `windows` arrays have shape (B, N) with padded slots carrying
    valid=False; `omega0s` is (B, 3) of per-window warm starts. A window
    that saturates early contributes masked no-ops until the slowest window
    in the batch finishes; per-window iteration counts survive in the
    returned traces."""
    return estimate_windows_parallel(windows, omega0s, cfg)


def estimate_batch_donated(windows: EventWindow, omega0s: torch.Tensor,
                           cfg: CmaxConfig) -> WindowResult:
    """`estimate_batch` under the reference's name for its donated form.

    PyTorch donates no buffer, so this aliases `estimate_batch`: the same
    computation and the same results, bit for bit, with the warm starts
    left as they were. On a card the graphs' static per-class buffers
    (`core.graphs`) take a copy of the batch, so nothing would be gained
    by donating it; the async service's executable is this function where
    the reference's donates its (B, 3) warm-start buffer."""
    return estimate_batch(windows, omega0s, cfg)


def estimate_streams(windows: EventWindow, omega_inits: torch.Tensor,
                     cfg: CmaxConfig) -> Tuple[torch.Tensor, WindowResult]:
    """Warm-start-chained estimation of S independent streams.

    `windows` arrays have shape (S, K, N); `omega_inits` is (S, 3). At each
    of the K window positions the S streams are one lockstep batch, and
    each stream's next warm start is its own estimate. Returns
    (omegas (S, K, 3), traces stacked as (S, K, ...))."""
    omega = omega_inits.to(cfg.dtype)
    results = []
    for k in range(windows.x.shape[1]):
        res = _estimate_batch_lockstep(windows.map(lambda a: a[:, k]),
                                       omega, cfg)
        omega = res.omega
        results.append(res)
    results = stack_results(results, dim=1)
    return results.omega, results


def lockstep_stage_passes(result: WindowResult) -> List[int]:
    """Batched engine passes a lockstep result took at each stage: the
    entry pass plus one per iteration of its slowest window. Axis 0 is the
    batch; any further axes (estimate_streams' window positions) are
    separate lockstep runs."""
    return [int((1 + st.iters.amax(dim=0)).sum()) for st in result.stages]


def lockstep_passes(result: WindowResult) -> int:
    """Batched engine passes a lockstep result took, over all stages."""
    return sum(lockstep_stage_passes(result))


def measured_stage_gains(result: WindowResult) -> np.ndarray:
    """Measured whole-residence variance gain per stage, (B, S) float64:

        (v_final - v_entry) / (|v_entry| + eps)

    Accepts single-window results (scalar traces -> B = 1) and batched
    results ((B,) traces). Runs on harvested host values."""
    cols = []
    for st in result.stages:
        ve = np.atleast_1d(st.v_entry.detach().cpu().numpy()
                           .astype(np.float64))
        vf = np.atleast_1d(st.v_final.detach().cpu().numpy()
                           .astype(np.float64))
        cols.append((vf - ve) / (np.abs(ve) + 1e-12))
    return np.stack(cols, axis=1) if cols else np.zeros((1, 0))
