"""CG-PR (Polak-Ribiere conjugate-gradient) ascent — the optimizer run on
the engine's (variance, gradient) outputs (paper §5.1, ref [42];
counterpart of `repro.core.cgpr`).

Nonlinear CG with the PR+ beta (clipped at zero) and a normalized-direction
fixed step per stage:

    beta  = max(0, g_new . (g_new - g_old) / (g_old . g_old))
    d_new = g_new + beta * d_old
    w    += alpha * d_new / (|d_new| + eps)

Every function works on a (..., 3) batch. Dot products are written out as
a fixed-order sum of the three products, so a window's update has the same
bits whatever batch it rides in.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import DeviceLike, resolve


class CgprState(NamedTuple):
    g_prev: torch.Tensor   # (..., 3) previous gradient
    d_prev: torch.Tensor   # (..., 3) previous direction
    first: torch.Tensor    # (...) bool: no history yet -> steepest ascent


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def init_state(dim: int = 3, dtype=torch.float32, device: DeviceLike = None,
               batch: Tuple[int, ...] = ()) -> CgprState:
    """Fresh state (no history) for `batch` windows on `device` (default:
    the card)."""
    dev = resolve(device)
    z = torch.zeros((*batch, dim), dtype=dtype, device=dev)
    return CgprState(g_prev=z, d_prev=z,
                     first=torch.ones(batch, dtype=torch.bool, device=dev))


def direction(g: torch.Tensor, st: CgprState
              ) -> Tuple[torch.Tensor, CgprState]:
    """PR+ conjugate direction for gradient `g` (ascent)."""
    denom = torch.clamp(_dot(st.g_prev, st.g_prev), min=1e-24)
    beta = _dot(g, g - st.g_prev) / denom
    beta = torch.clamp(beta, min=0.0)
    beta = torch.where(st.first, torch.zeros_like(beta), beta)
    d = g + beta.unsqueeze(-1) * st.d_prev
    # safeguard: if d is not an ascent direction, restart with g
    d = torch.where((_dot(d, g) > 0.0).unsqueeze(-1), d, g)
    return d, CgprState(g_prev=g, d_prev=d,
                        first=torch.zeros_like(st.first))


def step(omega: torch.Tensor, g: torch.Tensor, st: CgprState,
         alpha) -> Tuple[torch.Tensor, CgprState]:
    """One CG-PR update of the motion hypothesis; `alpha` is a float or a
    (...) tensor of per-window steps."""
    d, st = direction(g, st)
    nrm = _norm(d)
    alpha = torch.as_tensor(alpha, dtype=omega.dtype, device=omega.device)
    omega = omega + (alpha.unsqueeze(-1) * d) / (nrm + 1e-12).unsqueeze(-1)
    return omega, st


def gradient_ascent_step(omega: torch.Tensor, g: torch.Tensor,
                         st: CgprState, alpha
                         ) -> Tuple[torch.Tensor, CgprState]:
    """Plain normalized gradient ascent (use_cgpr=False fallback)."""
    nrm = _norm(g)
    alpha = torch.as_tensor(alpha, dtype=omega.dtype, device=omega.device)
    omega = omega + (alpha.unsqueeze(-1) * g) / (nrm + 1e-12).unsqueeze(-1)
    return omega, st._replace(g_prev=g, first=torch.zeros_like(st.first))
