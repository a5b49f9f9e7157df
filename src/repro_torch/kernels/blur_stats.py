"""Streaming separable Gaussian blur + on-the-fly Eq. 12 statistics: a batch
of four-channel stacks [IWE, dIWE_x, dIWE_y, dIWE_z] in, the eight running
sums [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz] of each blurred stack out, without
writing a blurred image.

Replaces `src/repro/kernels/blur_stats.py::blur_stats_streaming`, the
row-block-grid Pallas TPU kernel. The CUDA C++ source is
`csrc/blur_stats.cu` (sm_90a); its header comment states the design.

  * The TPU kernel carries a line buffer and the sums from grid step to grid
    step. On the card a one-warp block stages a (column strip, row band) of
    the stack in shared memory and streams down its rows keeping the line
    buffer in registers; the last block of a window to finish adds the
    blocks' sums in a fixed order: one launch per call.
  * It reads the unpadded (B, 4, H, W) stack with bounds masks: the TPU
    kernel's zero padding to (Hp, Wp), lane-aligned to 128, is not needed.
  * Every sum has a fixed order and `launch_config` depends on (H, W, k)
    only: results are bitwise equal run to run and a window's sums do not
    depend on its batch or slot.

`launch_config` is the one owner of the kernel's geometry (grid, shared
memory). `blur_stats_streaming_plain` is the same function in plain
PyTorch: the wrapper runs it for CPU tensors only, and `chip_smoke.py` holds
the kernel against it on the card. `blur_stats_streaming.launches` counts
launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..core.contrast import streaming_stats
from .megakernel import SMEM_LIMIT

STRIP = 64          # output columns of a warp: two per lane
TARGET_ITEMS = 128  # (strip, band) items a window aims for


class BlurLaunch(NamedTuple):
    """The kernel's geometry at one (H, W, k)."""

    pad: int               # staged halo columns each side of a strip
    seg: int               # floats staged per channel and row
    n_strips: int          # column strips of STRIP columns
    n_bands: int           # row bands of `band_rows` output rows
    band_rows: int
    smem: int              # dynamic shared memory of a block (bytes)

    @property
    def items(self) -> int:
        """(strip, band) items of a window: one one-warp block each."""
        return self.n_strips * self.n_bands

    def grid(self, batch: int):
        """(blocks per window, windows): a window's blocks never depend on
        the batch size."""
        return (self.items, batch)


def launch_config(H: int, W: int, k: int) -> BlurLaunch:
    """Geometry of the kernel at an H x W grid with k taps.

    A one-warp block owns a (strip, band) item: STRIP columns (two a lane)
    by `band_rows` rows, whose rows, halo included, it stages in shared
    memory. The bands are cut so that a window has about TARGET_ITEMS
    items, but no band is shorter than max(4, (k - 1) // 2) rows, which
    bounds the halo rows' extra horizontal FIR at 3x. Nothing depends on
    the batch size, so neither do a window's bits."""
    if k < 1 or k % 2 == 0:
        raise ValueError(f"blur_stats_streaming: k must be odd; got {k}")
    pad = -(-(k // 2) // 4) * 4           # 16-byte aligned halo
    seg = STRIP + 2 * pad
    n_strips = -(-W // STRIP)
    min_rows = max(4, (k - 1) // 2)
    n_bands = max(1, min(-(-TARGET_ITEMS // n_strips), H // min_rows))
    band_rows = -(-H // n_bands)
    n_bands = -(-H // band_rows)
    smem = (band_rows + k - 1) * 4 * seg * 4
    return BlurLaunch(pad=pad, seg=seg, n_strips=n_strips, n_bands=n_bands,
                      band_rows=band_rows, smem=smem)


def blur_stats_streaming_plain(channels: torch.Tensor, taps: torch.Tensor,
                               *, rb: int = 16) -> torch.Tensor:
    """Plain PyTorch version: separable zero-padded blur, then the eight
    sums. (..., 4, H, W) -> (..., 8). `rb` does not change the function."""
    del rb
    return streaming_stats(channels.to(torch.float32), taps)


def _bind(lib):
    if getattr(lib, "_blur_stats_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_stats_launch.argtypes = [p] * 5 + [i] * 11 + [p]
    lib.blur_stats_launch.restype = ctypes.c_int
    lib.blur_stats_error_string.argtypes = [ctypes.c_int]
    lib.blur_stats_error_string.restype = ctypes.c_char_p
    lib._blur_stats_bound = True
    return lib


#: (device index, stream) -> int32 tickets, one a window, for the kernel's
#: last-block sum. Zeroed once; every launch leaves them at zero, so the
#: calls on one stream (which run in turn) share them, and calls on two
#: streams never do. A launch captured into a CUDA graph zeroes tickets of
#: its own inside the graph instead: a graph may replay on any stream.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _tickets(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(B, dtype=torch.int32, device=dev)
    t = _TICKETS.get((dev.index, stream))
    if t is None or t.numel() < B:
        t = torch.zeros(max(B, 64), dtype=torch.int32, device=dev)
        _TICKETS[(dev.index, stream)] = t
    return t


def blur_stats_streaming(channels: torch.Tensor, taps: torch.Tensor, *,
                         rb: int = 16) -> torch.Tensor:
    """Eq. 12 sums of the blurred stacks: (..., 4, H, W) f32 channels +
    (k,) FIR taps -> (..., 8) f32 [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz].

    CUDA tensors launch the kernel (or raise); CPU tensors run
    `blur_stats_streaming_plain`. `rb`, the TPU kernel's rows per grid
    step, is kept for the callers' signature; the card's geometry comes
    from `launch_config(H, W, k)` alone."""
    dev = channels.device
    if dev.type == "cpu":
        return blur_stats_streaming_plain(channels, taps, rb=rb)
    if dev.type != "cuda":
        raise ValueError(f"blur_stats_streaming: unsupported device {dev}")
    if channels.dim() < 3 or channels.shape[-3] != 4:
        raise ValueError("blur_stats_streaming: channels must be "
                         f"(..., 4, H, W); got {tuple(channels.shape)}")
    k = taps.shape[0]
    for name, t in (("channels", channels), ("taps", taps)):
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"blur_stats_streaming: {name} must be a contiguous float32 "
                f"tensor on {dev}; got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if taps.dim() != 1 or k % 2 != 1 or k > 15:
        raise ValueError(f"blur_stats_streaming: taps must be (k,) with odd "
                         f"k <= 15; got {tuple(taps.shape)}")
    lead = channels.shape[:-3]
    H, W = channels.shape[-2:]
    B = math.prod(lead)
    cfg = launch_config(H, W, k)
    if cfg.smem > SMEM_LIMIT:
        raise ValueError(f"blur_stats_streaming: k={k} needs {cfg.smem} "
                         f"bytes of shared memory per block, above the "
                         f"{SMEM_LIMIT} a block may use")
    out = torch.empty(lead + (8,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    vec = int(W % 4 == 0 and channels.data_ptr() % 16 == 0)

    from . import _build
    lib = _bind(_build.load("blur_stats"))
    partial = torch.empty((B, cfg.items, 8), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _tickets(dev, stream, B)
        err = lib.blur_stats_launch(
            channels.data_ptr(), taps.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), out.data_ptr(), B, H, W, k, cfg.n_strips,
            cfg.n_bands, cfg.band_rows, cfg.pad, cfg.seg, cfg.smem, vec,
            stream)
    if err != 0:
        msg = lib.blur_stats_error_string(err).decode()
        raise RuntimeError(f"blur_stats_streaming launch failed: {msg} "
                           f"({err})")
    _build.count_launch(blur_stats_streaming)
    return out


blur_stats_streaming.launches = 0
