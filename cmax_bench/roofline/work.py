"""The work of one engine pass, counted from what the algorithm needs, and
the least time the chip could do it in.

The count is the pass's, not an implementation's: each retained event's
x, y, t and signed weight are read once (16 bytes), the rate read and the
eight Eq. 12 sums written once per window, and the FLOPs are those of the
warp and the bilinear vote per retained event, the separable blur of the
four images and the eight sums per pixel of the stage grid. What a kernel
reads again (a sorted key, a halo row, a fold-back buffer) is not counted,
so fusing or splitting kernels leaves the work the same.

FLOPs per retained event (counting each add, multiply and divide once):
  warp:  xn, yn (4), dt scaled (1), 1 + xn^2, 1 + yn^2, xn*yn (5), u, v
         (2 x 6), xw, yw (2 x 3), the rows r_x, r_y (6 entries x 2
         products), floor and fraction of xw, yw (4)               = 44
  vote:  4 bilinear weights (2 subtractions, 4 products), 4 x 3 weight
         derivatives (12 x 3), the signed weight times the 16 deltas
         (16), 16 adds into the images (16)                        = 74
FLOPs per pixel of the stage grid with a k-tap blur:
  blur:  4 images x 2 directions x (k multiplies + k - 1 adds)
  sums:  S1 (1), S2 (2), G_x,y,z (6), T_x,y,z (3)                   = 12
"""
from __future__ import annotations

import json
import math
from pathlib import Path

FLOPS_PER_EVENT = 44 + 74
BYTES_PER_EVENT = 16
BYTES_PER_WINDOW = 12 + 8 * 4        # the rate in, the eight sums out


def pass_flops(n_retained: int, pixels: int, taps: int) -> int:
    return (FLOPS_PER_EVENT * n_retained
            + pixels * (4 * 2 * (2 * taps - 1) + 12))


def pass_bytes(n_retained: int) -> int:
    return BYTES_PER_EVENT * n_retained + BYTES_PER_WINDOW


def peaks(device_name: str) -> dict:
    """The table's row for the card, or None when the table has none."""
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f).get(device_name)


def pass_bound_s(n_retained: int, height: int, width: int, scale: float,
                 taps: int, peak: dict) -> float:
    """The least seconds one window's engine pass needs at one stage:
    the larger of its FLOPs at the f32 peak and its bytes at the HBM
    bandwidth."""
    pixels = int(math.ceil(scale * height)) * int(math.ceil(scale * width))
    return max(pass_flops(n_retained, pixels, taps) / peak["f32_flops_per_s"],
               pass_bytes(n_retained) / peak["hbm_bytes_per_s"])
