"""Pixel-grouped sorting with stage-aware subsampling (paper Algorithm 3;
counterpart of `repro.core.sorting`).

The hardware's 3-state flow (count / prefix-scan / permute), built from
two stable `torch.sort`s and `searchsorted`, over a whole batch at once
(events (..., N), omega (..., 3)):

  state 1 (count):   stable sort by group id; the start of each group's
                     run (searchsorted) gives cnt[p] as run lengths
  state 2 (scan):    offset[]  = exclusive prefix sum of cnt (the run
                     starts themselves); StagePolicy gives
                     per-group stride/act/budget
  state 3 (permute): group-local rank via
                     arange - offset[gid], retain rank % stride == 0,
                     then a second stable sort packs retained events first
                     (still in pixel-group order) -> perm[]

Sorting runs once per stage entry with the warm-start reference warp; the
retained-event weights are held fixed while the optimizer iterates. Every
output is integer (or 0/1) data, so it is exact on any device and any
batch size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .geometry import warp_events
from .types import Camera, EventWindow, StageConfig


class StagePolicyOut(NamedTuple):
    stride: torch.Tensor   # (..., P) int32 subsample stride per group
    budget: torch.Tensor   # (..., P) int32 retained-event budget per group
    act: torch.Tensor      # (..., P) bool  group activity flag


def stage_policy(cnt: torch.Tensor, keep_ratio: float,
                 max_per_group: Optional[int] = None) -> StagePolicyOut:
    """StagePolicy(cnt[p], s) of Alg. 3: keep-ratio rho_s = s realized as a
    group-local stride round(1/rho); optional per-group hard budget cap
    (disabled by default = paper-faithful)."""
    stride_val = max(1, int(round(1.0 / max(keep_ratio, 1e-6))))
    stride = torch.full_like(cnt, stride_val)
    budget = torch.div(cnt + stride_val - 1, stride_val,
                       rounding_mode="floor")            # ceil(cnt/stride)
    if max_per_group is not None:
        budget = budget.clamp(max=max_per_group)
    act = cnt > 0
    return StagePolicyOut(stride=stride, budget=budget, act=act)


class SortTables(NamedTuple):
    """Stage-local metadata tables (active/offset/perm of Alg. 3) plus the
    streaming side-band signals (p_ref, last_in_pg) and a dense per-event
    weight vector in ORIGINAL event order. Leading batch axes as the
    window's."""

    perm: torch.Tensor        # (..., N) int64: event idx, retained first
    retained: torch.Tensor    # (..., N) bool, in perm order
    p_ref: torch.Tensor       # (..., N) int32 group id per slot (P = none)
    last_in_pg: torch.Tensor  # (..., N) bool, in perm order
    cnt: torch.Tensor         # (..., P) int32 events per group (valid only)
    offset: torch.Tensor      # (..., P+1) int32 exclusive prefix sum of cnt
    act: torch.Tensor         # (..., P) bool group activity
    n_retained: torch.Tensor  # (...) int32
    weights: torch.Tensor     # (..., N) float32, ORIGINAL order: 1 iff kept


def sort_events(ev: EventWindow, omega_ref: torch.Tensor, cam: Camera,
                stage: StageConfig,
                max_per_group: Optional[int] = None) -> SortTables:
    """Algorithm 3 for one stage, using the warm-start reference warp."""
    Hs, Ws = stage.grid(cam)
    P = Hs * Ws
    batch = ev.x.shape[:-1]
    N = ev.n
    dev = ev.device

    w = warp_events(ev, omega_ref, cam, stage.scale)
    # invalid events go to dump bucket P
    key = torch.where(w.in_range, w.p_act,
                      torch.full_like(w.p_act, P)).to(torch.int64)
    key = key.reshape(-1, N)
    nb = key.shape[0]

    # --- state 1: count (from the sorted keys: no atomics, no host sync) ---
    key_s, order1 = torch.sort(key, dim=1, stable=True)
    bounds = torch.arange(P + 1, device=dev).expand(nb, P + 1).contiguous()
    offset = torch.searchsorted(key_s, bounds)   # (nb, P+1) run starts
    cnt = (offset[:, 1:] - offset[:, :-1]).to(torch.int32)

    # --- state 2: offsets (the run starts: exclusive prefix sum) + policy ---
    policy = stage_policy(cnt, stage.keep_ratio, max_per_group)

    # --- state 3: permute (stable sort by group, group-local rank) ---
    rank = (torch.arange(N, device=dev).unsqueeze(0)
            - torch.gather(offset, 1, key_s))
    kc = key_s.clamp(0, P - 1)
    stride_s = torch.gather(policy.stride, 1, kc).to(torch.int64)
    budget_s = torch.gather(policy.budget, 1, kc).to(torch.int64)
    retained_s = ((key_s < P) & (rank % stride_s == 0)
                  & (torch.div(rank, stride_s, rounding_mode="floor")
                     < budget_s))

    # pack retained first, preserving group order (stable sort on a key that
    # sends dropped/invalid events to bucket P)
    key2 = torch.where(retained_s, key_s, torch.full_like(key_s, P))
    _, order2 = torch.sort(key2, dim=1, stable=True)
    perm = torch.gather(order1, 1, order2)
    retained = torch.gather(retained_s, 1, order2)
    p_ref = torch.where(retained, torch.gather(key_s, 1, order2),
                        torch.full_like(key_s, P))

    nxt = torch.cat([p_ref[:, 1:],
                     torch.full((nb, 1), P, dtype=p_ref.dtype, device=dev)],
                    dim=1)
    last_in_pg = retained & (p_ref != nxt)

    n_retained = retained.sum(dim=1).to(torch.int32)
    weights = torch.zeros((nb, N), dtype=torch.float32, device=dev)
    weights.scatter_(1, perm, retained.to(torch.float32))

    r = lambda a: a.reshape(tuple(batch) + tuple(a.shape[1:]))
    return SortTables(perm=r(perm), retained=r(retained),
                      p_ref=r(p_ref.to(torch.int32)),
                      last_in_pg=r(last_in_pg), cnt=r(cnt),
                      offset=r(offset.to(torch.int32)), act=r(policy.act),
                      n_retained=r(n_retained), weights=r(weights))


def retained_window(ev: EventWindow, tables: SortTables) -> EventWindow:
    """Physically reorder the window into perm order with validity =
    retained — the compacted stream."""
    g = lambda a: torch.gather(a, -1, tables.perm)
    return EventWindow(x=g(ev.x), y=g(ev.y), t=g(ev.t), p=g(ev.p),
                       valid=g(ev.valid) & tables.retained)
