"""Measured event statistics + the face of the analytical
access/latency/energy model (paper §5, Tables 2/3/5/6; counterpart of
`repro.core.energy`).

The FPGA prototype is evaluated on effective memory accesses, processing
latency and system energy. None of these exist on a GPU runtime, so they
are reproduced pre-silicon: an analytical accounting model driven by
*measured event statistics* that the pipeline produces (active-group
ratios, outlier ratios, pending-hit rates, per-stage pass counts).

The accounting model lives in `repro_torch.costmodel`; this module
re-exports its API (`HwParams`, `Account`, `account_stage`,
`account_window`, `load_profile`, ...), so `HwParams()` here is exactly
`load_profile("paper_fpga_45nm")`. What stays here is what must be
*measured*: `locality_stats`, the stage-wise locality measurement
(Table 2) and the lane-accurate pending-merge simulation (Table 3) over
real event data.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..costmodel.model import (Account, HwParams, MemGroup,  # noqa: F401
                               account_stage, account_window, load_profile,
                               pass_cost, sort_cost)
from .geometry import warp_events
from .sorting import sort_events
from .types import Camera, EventWindow, StageConfig

C_CH = 4      # channels: IWE + dIWE_xyz
T_TAP = 4     # bilinear voting taps (profile key pipeline.vote_taps)


def _prev_active(act: torch.Tensor) -> torch.Tensor:
    """For each group (last axis, scan order) the index of the closest
    active group before it, or -1 when there is none: the exclusive
    forward fill of the active positions, as one cummax."""
    P = act.shape[-1]
    pos = torch.arange(P, dtype=torch.int64, device=act.device)
    idx = torch.where(act, pos, torch.full_like(pos, -1))
    last = torch.cummax(idx, dim=-1).values
    return torch.cat([torch.full_like(last[..., :1], -1), last[..., :-1]],
                     dim=-1)


def locality_stats(ev: EventWindow, omega_sort: torch.Tensor,
                   omega_now: torch.Tensor, cam: Camera, stage: StageConfig
                   ) -> Dict[str, torch.Tensor]:
    """Stage-wise locality statistics (paper Table 2) + pending-merge hit
    simulation (paper Table 3), measured on real event data.

    * active pixel-group ratio = groups with >=1 retained event / retained
    * outlier ratio = retained events whose current-warp group differs from
      their sort-time group (p_act != p_ref)
    * expected update ratio = active + outlier (each active group commits
      once; each outlier commits individually)
    * pending-merge: lane-accurate simulation over the commit stream — for
      each of the 16 lanes (4 taps x 4 ch share the tap address), commits of
      consecutive active groups (in scan order) to the same bank-local
      address coalesce in the pending register.

    Every value is a tensor on the window's device (0-d for one (N,)
    window; leading batch axes carry through): counts int32, ratios f32.
    Nothing is read back to the host."""
    i32 = torch.int32
    tables = sort_events(ev, omega_sort, cam, stage)
    Hs, Ws = stage.grid(cam)
    dev = ev.device
    n_ret = tables.n_retained.clamp(min=1)

    w = warp_events(ev, omega_now, cam, stage.scale)
    p_act_perm = torch.gather(w.p_act, -1, tables.perm)
    outlier = tables.retained & (p_act_perm != tables.p_ref)
    n_out = outlier.sum(-1, dtype=i32)

    act = tables.act
    act_groups = act.sum(-1, dtype=i32)

    # ---- pending-merge over group commits, per tap lane ----
    # active groups in scan order; group g commits tap (dy,dx) at bank-local
    # address floor((y0+dy)/2)*ceil(Ws/2) + floor((x0+dx)/2). Consecutive
    # actives with equal address merge: each active group is compared with
    # the previous active group's address (-2 before the first, which no
    # address equals). The previous active group is the same for every
    # lane, so one fill serves all four.
    gid = torch.arange(Hs * Ws, dtype=i32, device=dev)
    gy, gx = gid // Ws, gid % Ws
    Wb = (Ws + 1) // 2
    addr = torch.stack([((gy + dy) // 2) * Wb + (gx + dx) // 2
                        for dy in (0, 1) for dx in (0, 1)])     # (4, P)
    prev = _prev_active(act)                                   # (..., P)
    lanes = addr.expand(act.shape[:-1] + addr.shape)           # (..., 4, P)
    prev_addr = torch.gather(
        lanes, -1, prev.clamp(min=0).unsqueeze(-2).expand(lanes.shape))
    prev_addr = torch.where(prev.unsqueeze(-2) >= 0, prev_addr,
                            torch.full_like(prev_addr, -2))
    lane_hits = (act.unsqueeze(-2) & (lanes == prev_addr)).sum(-1, dtype=i32)
    # the 4 channels share each tap's address
    hits = (lane_hits * C_CH).sum(-1, dtype=i32)

    group_commits = act_groups * (C_CH * T_TAP)
    outlier_commits = n_out * (C_CH * T_TAP)
    naive_updates = n_ret * (C_CH * T_TAP)
    eff_updates = group_commits + outlier_commits - hits

    return dict(
        n_retained=n_ret,
        active_groups=act_groups,
        active_ratio=act_groups / n_ret,
        outlier_ratio=n_out / n_ret,
        expected_update_ratio=(act_groups + n_out) / n_ret,
        expected_reduction=1.0 - (act_groups + n_out) / n_ret,
        measured_reduction=1.0 - eff_updates / naive_updates,
        eff_updates=eff_updates,
        naive_updates=naive_updates,
    )
