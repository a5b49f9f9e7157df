"""Plain PyTorch oracles for the per-window kernel path (counterpart of
`repro.kernels.ref`): the reference datapath of `core/`, restated for the
kernels' interfaces."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.contrast import gaussian_taps, streaming_stats
from ..core.geometry import warp_events
from ..core.iwe import accumulate
from ..core.types import Camera, EventWindow


def iwe_accum_ref(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                  scale: float, weights: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Oracle for `ops.iwe_accum`: the reference scatter-add datapath.
    Returns the (..., 4, H_s, W_s) channel stack."""
    w = warp_events(ev, omega, cam, scale)
    return accumulate(w, ev.p, cam.grid(scale), weights=weights)


def blur_stats_ref(channels: torch.Tensor, num_taps: int,
                   sigma: float) -> torch.Tensor:
    """Oracle for `ops.blur_stats`: the eight running sums of Eq. 12 from
    materialized blurred images. (..., 4, H, W) -> (..., 8)."""
    taps = gaussian_taps(num_taps, sigma, torch.float32,
                         device=channels.device)
    return streaming_stats(channels.to(torch.float32), taps)
