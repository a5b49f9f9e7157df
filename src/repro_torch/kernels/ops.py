"""Public wrappers around the engine-pass kernel (counterpart of
`repro.kernels.ops`, batched engine only).

`bin_taps`            : the binning prologue for a whole (B, N) batch —
                        warp, expand the 4 bilinear taps, key each
                        contributing tap by its destination pixel, order the
                        records with one stable sort and take per-pixel CSR
                        offsets from the sorted keys (the Alg.-3
                        count/scan/permute at pixel granularity).
`batched_engine_stats`: prologue + ONE kernel call for the whole batch ->
                        (B, 8) Eq. 12 sums.
`batched_engine_pass` : the same, then Eq. 12 -> (variance (B,), grad (B, 3)).

Unlike the TPU kernel's fixed per-slab capacity, the CSR segments have no
capacity: no tap is dropped at any event count, so the batched engine
equals the `reference` engine at every size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.contrast import gaussian_taps, stats_to_objective
from ..core.geometry import warp_events
from ..core.iwe import TAP_OFFSETS
from ..core.types import Camera, EventWindow
from .megakernel import megakernel_stats


class TapBins(NamedTuple):
    """The kernel's inputs for one batch at one stage grid."""

    x: torch.Tensor        # (B, N) f32 event x
    y: torch.Tensor        # (B, N) f32 event y
    dt: torch.Tensor       # (B, N) f32 t - t_ref
    pw: torch.Tensor       # (B, N) f32 polarity * retention weight
    rec: torch.Tensor      # (B, 4N) int32 tap*N + event, pixel-ordered
    pix_off: torch.Tensor  # (B, P+1) int32 CSR offsets; [:, P] = live taps


def bin_taps(ev: EventWindow, omega: torch.Tensor, weights: torch.Tensor,
             cam: Camera, scale: float) -> TapBins:
    """Pixel-binning prologue for a (B, N) batch under hypotheses (B, 3).

    Taps of events that are out of range or carry zero weight (dropped by
    subsampling, padded, dead windows) have identically zero deltas and go
    to the dump key P, after every live record."""
    Hs, Ws = cam.grid(scale)
    P = Hs * Ws
    B, N = ev.x.shape
    dev = ev.device
    f32 = torch.float32
    w = warp_events(ev, omega, cam, scale)
    dt = ev.t - ev.t_ref.unsqueeze(-1)
    pw = ev.p.to(f32) * weights.to(f32)
    live = w.in_range & (pw != 0.0)
    dump = torch.full_like(w.x0, P)
    key = torch.cat([torch.where(live, (w.y0 + dy) * Ws + (w.x0 + dx), dump)
                     for dy, dx in TAP_OFFSETS], dim=-1)       # (B, 4N)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    # each pixel's run starts where the sorted keys reach it: CSR offsets
    # without atomics or a host sync
    bounds = torch.arange(P + 1, dtype=key.dtype, device=dev)
    pix_off = torch.searchsorted(key_s, bounds.expand(B, P + 1).contiguous())
    c = lambda a: a.to(f32).contiguous()
    return TapBins(x=c(ev.x), y=c(ev.y), dt=c(dt), pw=c(pw),
                   rec=order.to(torch.int32).contiguous(),
                   pix_off=pix_off.to(torch.int32).contiguous())


def batched_engine_stats(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                         scale: float, num_taps: int, sigma: float,
                         weights: Optional[torch.Tensor] = None,
                         rb: int = 8,
                         fir: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full batched engine pass -> (B, 8) Eq. 12 stats: the prologue plus
    one kernel call. `ev` arrays are (B, N) (padded slots valid=False);
    `omega` is (B, 3); `fir` may carry precomputed Gaussian taps."""
    Hs, Ws = cam.grid(scale)
    if weights is None:
        weights = torch.ones_like(ev.x, dtype=torch.float32)
    if fir is None:
        fir = gaussian_taps(num_taps, sigma, torch.float32, device=ev.device)
    omega = omega.to(torch.float32).contiguous()
    bins = bin_taps(ev, omega, weights, cam, scale)
    return megakernel_stats(*bins, omega, fir, H=Hs, W=Ws, rb=rb,
                            scale=scale, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                            cy=cam.cy)


def batched_engine_pass(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                        scale: float, num_taps: int, sigma: float,
                        weights: Optional[torch.Tensor] = None,
                        rb: int = 8, fir: Optional[torch.Tensor] = None):
    """Batched engine pass -> (variance (B,), grad (B, 3))."""
    stats = batched_engine_stats(ev, omega, cam, scale, num_taps, sigma,
                                 weights=weights, rb=rb, fir=fir)
    Hs, Ws = cam.grid(scale)
    return stats_to_objective(stats, Hs * Ws)
