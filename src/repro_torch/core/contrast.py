"""Gaussian smoothing + contrast objective and gradient (paper Eq. 3-5,
11-12; counterpart of `repro.core.contrast`).

Two mathematically identical realizations, both kept on purpose:

  * `objective_direct`  — Eq. 11: blur the channel stack, then compute
    Var(I_sigma) and dC/dw_j = 2/P * sum((I_sigma - mean) * D_sigma_j).
  * `objective_streaming` — Eq. 12: only the running sums
    S1 = sum(I), S2 = sum(I^2), G_j = sum(I*D_j), T_j = sum(D_j), which is
    what the engine-pass kernel computes without materializing any
    blurred image.

All functions accept leading batch axes on the channel stack.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import DeviceLike


def gaussian_taps(num_taps: int, sigma: float, dtype=torch.float32,
                  device: DeviceLike = "cpu") -> torch.Tensor:
    """Odd-length normalized Gaussian FIR taps (3/5/9-tap per stage)."""
    if num_taps % 2 != 1:
        raise ValueError(f"FIR must be odd-length, got {num_taps}")
    half = num_taps // 2
    xs = torch.arange(-half, half + 1, dtype=dtype, device=device)
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    return g / torch.sum(g)


def _fir_last_axis(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """'same' k-tap FIR along the last axis with zero padding, as the sum
    of shifted-and-scaled copies (tap 0 first)."""
    k = taps.shape[0]
    half = k // 2
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (half, half))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + taps[i] * xp[..., i:i + n]
    return out


def blur_separable(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable 2D Gaussian on a (..., H, W) stack: horizontal 1-D FIR
    followed by a vertical pass (zero 'same' padding)."""
    h = _fir_last_axis(img, taps)                              # horizontal
    v = _fir_last_axis(h.transpose(-1, -2), taps)              # vertical
    return v.transpose(-1, -2)


def objective_direct(channels: torch.Tensor, taps: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 11 on a (..., 4, H, W) channel stack -> (variance, grad (..., 3)).

    grad_j = 2/P * sum_x (I_sigma(x) - mean) * D_sigma_j(x)."""
    blurred = blur_separable(channels, taps)
    I = blurred[..., 0, :, :]
    D = blurred[..., 1:4, :, :]
    P = I.shape[-1] * I.shape[-2]
    mean = I.mean(dim=(-2, -1), keepdim=True)
    var = ((I - mean) ** 2).mean(dim=(-2, -1))
    grad = (2.0 / P) * ((I - mean).unsqueeze(-3) * D).sum(dim=(-2, -1))
    return var, grad


def streaming_stats(channels: torch.Tensor, taps: torch.Tensor
                    ) -> torch.Tensor:
    """The eight running sums of Eq. 12 as a (..., 8) vector:
    [S1, S2, G_x, G_y, G_z, T_x, T_y, T_z]."""
    blurred = blur_separable(channels, taps)
    I = blurred[..., 0, :, :]
    D = blurred[..., 1:4, :, :]
    S1 = I.sum(dim=(-2, -1))
    S2 = (I * I).sum(dim=(-2, -1))
    G = (I.unsqueeze(-3) * D).sum(dim=(-2, -1))
    T = D.sum(dim=(-2, -1))
    return torch.cat([torch.stack([S1, S2], dim=-1), G, T], dim=-1)


def stats_to_objective(stats: torch.Tensor, num_pixels: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 12: Var = S2/P - (S1/P)^2;  dC/dw_j = 2/P (G_j - S1*T_j/P).

    `stats` is an (..., 8) stack; leading axes broadcast through."""
    P = float(num_pixels)
    S1, S2 = stats[..., 0], stats[..., 1]
    G = stats[..., 2:5]
    T = stats[..., 5:8]
    var = S2 / P - (S1 / P) ** 2
    grad = (2.0 / P) * (G - S1.unsqueeze(-1) * T / P)
    return var, grad


def objective_streaming(channels: torch.Tensor, taps: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 12 path: running sums only."""
    stats = streaming_stats(channels, taps)
    return stats_to_objective(stats,
                              channels.shape[-1] * channels.shape[-2])


def variance_of(img: torch.Tensor, num_taps: int, sigma: float
                ) -> torch.Tensor:
    """Convenience: Var(G_sigma * img) for a bare (H, W) image (the
    population variance of the separable blur, as `jnp.var`)."""
    taps = gaussian_taps(num_taps, sigma, img.dtype, device=img.device)
    return torch.var(blur_separable(img, taps), correction=0)
