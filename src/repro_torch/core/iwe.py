"""IWE + derivative-image accumulation with bilinear voting (paper Eq. 2/6;
counterpart of `repro.core.iwe`).

Every event contributes to the 4 neighbors of its warped coordinate with
bilinear weights; alongside the IWE we accumulate the three derivative
images dIWE_j = dI/dw_j (j in {x,y,z}) with per-tap analytic deltas.

Sign conventions (see geometry.py): d(x')/dw = -r_x, d(y')/dw = -r_y, so
  d w00/dw = +(1-ay) r_x + (1-ax) r_y        (w00 = (1-ax)(1-ay))
  d w10/dw = -(1-ay) r_x + ax     r_y        (w10 = ax(1-ay))
  d w01/dw = +ay     r_x - (1-ax) r_y        (w01 = (1-ax)ay)
  d w11/dw = -ay     r_x - ax     r_y        (w11 = ax*ay)

`accumulate` is the plain scatter-add datapath of the `reference` engine.
Each pixel sums its contributions in event order on every device: on the
card the scatter runs under PyTorch's deterministic algorithms (a sorted,
sequential accumulation instead of float atomics), so the oracle gives the
same bits on every run. The `cuda_batched` engine never runs it.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from .geometry import WarpOut, warp_events
from .types import Camera, EventWindow

# Channel order everywhere in the codebase:
CH_IWE, CH_DX, CH_DY, CH_DZ = 0, 1, 2, 3
NUM_CHANNELS = 4
NUM_TAPS = 4
# Tap order: (dy, dx) = (0,0), (0,1), (1,0), (1,1)
TAP_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


def tap_weights(ax: torch.Tensor, ay: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) bilinear weights in TAP_OFFSETS order."""
    return torch.stack([
        (1 - ax) * (1 - ay),
        ax * (1 - ay),
        (1 - ax) * ay,
        ax * ay,
    ], dim=-1)


def tap_weight_grads(ax: torch.Tensor, ay: torch.Tensor, rx: torch.Tensor,
                     ry: torch.Tensor) -> torch.Tensor:
    """(..., N, 4, 3) d(weight_tap)/dw using d(x')/dw = -rx,
    d(y')/dw = -ry."""
    cx = torch.stack([(1 - ay), -(1 - ay), ay, -ay], dim=-1)    # (..., N, 4)
    cy = torch.stack([(1 - ax), ax, -(1 - ax), -ax], dim=-1)
    return (cx.unsqueeze(-1) * rx.unsqueeze(-2)
            + cy.unsqueeze(-1) * ry.unsqueeze(-2))


def event_deltas(w: WarpOut, p: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-event, per-tap, per-channel contribution deltas.

    Returns (..., N, 4 taps, 4 channels): [IWE, dIWE_x, dIWE_y, dIWE_z].
    `weights` is an optional per-event retention weight; out-of-range
    events get zero delta."""
    wts = tap_weights(w.ax, w.ay)                       # (..., N, 4)
    gws = tap_weight_grads(w.ax, w.ay, w.rx, w.ry)      # (..., N, 4, 3)
    pe = p.to(wts.dtype)
    if weights is not None:
        pe = pe * weights.to(wts.dtype)
    pe = torch.where(w.in_range, pe, torch.zeros_like(pe))
    iwe_d = pe.unsqueeze(-1) * wts                      # (..., N, 4)
    diwe_d = pe[..., None, None] * gws                  # (..., N, 4, 3)
    return torch.cat([iwe_d.unsqueeze(-1), diwe_d], dim=-1)


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms for the enclosed calls only."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def _scatter_taps(w: WarpOut, vals, grid: Tuple[int, int], n_ch: int,
                  dtype) -> torch.Tensor:
    """Scatter-add per-tap values `vals(ti) -> (..., N, n_ch)` into an
    (..., n_ch, H_s, W_s) stack, tap by tap in TAP_OFFSETS order (each
    pixel sums its contributions in event order, as the reference does)."""
    Hs, Ws = grid
    batch = w.x0.shape[:-1]
    nb = 1
    for d in batch:
        nb *= d
    N = w.x0.shape[-1]
    P = Hs * Ws
    dev = w.x0.device
    img = torch.zeros(nb * n_ch * P, dtype=dtype, device=dev)
    base = (torch.arange(nb, device=dev).view(nb, 1, 1) * n_ch
            + torch.arange(n_ch, device=dev).view(1, 1, n_ch)) * P
    for ti, (dy, dx) in enumerate(TAP_OFFSETS):
        yy = (w.y0 + dy).clamp(0, Hs - 1).reshape(nb, N, 1)
        xx = (w.x0 + dx).clamp(0, Ws - 1).reshape(nb, N, 1)
        idx = (base + yy * Ws + xx).reshape(-1)
        with _deterministic():
            img.index_add_(0, idx, vals(ti).reshape(-1).to(dtype))
    return img.reshape(*batch, n_ch, Hs, Ws)


def accumulate(w: WarpOut, p: torch.Tensor, grid: Tuple[int, int],
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter-add all 16 lanes into a (..., 4, H_s, W_s) channel stack.

    Out-of-range events were already zeroed in `event_deltas`; indices are
    additionally clamped so the scatter itself is always in-bounds."""
    deltas = event_deltas(w, p, weights)                # (..., N, 4, 4)
    return _scatter_taps(w, lambda ti: deltas[..., ti, :], grid,
                         NUM_CHANNELS, deltas.dtype)


def build_iwe(ev: EventWindow, omega: torch.Tensor, cam: Camera,
              scale: float, weights: Optional[torch.Tensor] = None,
              t_ref=None) -> torch.Tensor:
    """Warp + accumulate for one hypothesis per window. Returns
    (..., 4, H_s, W_s)."""
    w = warp_events(ev, omega, cam, scale, t_ref=t_ref)
    return accumulate(w, ev.p, cam.grid(scale), weights=weights)


def build_iwe_only(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                   scale: float, weights: Optional[torch.Tensor] = None,
                   t_ref=None) -> torch.Tensor:
    """IWE channel only (no derivative images): (..., H_s, W_s)."""
    w = warp_events(ev, omega, cam, scale, t_ref=t_ref)
    wts = tap_weights(w.ax, w.ay)
    pe = torch.where(w.in_range, ev.p.to(wts.dtype),
                     torch.zeros_like(wts[..., 0]))
    if weights is not None:
        pe = pe * weights.to(wts.dtype)
    img = _scatter_taps(w, lambda ti: (pe * wts[..., ti]).unsqueeze(-1),
                        cam.grid(scale), 1, wts.dtype)
    return img.squeeze(-3)
