"""Streaming separable Gaussian blur + on-the-fly Eq. 12 statistics: a batch
of four-channel stacks [IWE, dIWE_x, dIWE_y, dIWE_z] in, the eight running
sums [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz] of each blurred stack out, without
writing a blurred image.

Replaces `src/repro/kernels/blur_stats.py::blur_stats_streaming`, the
row-block-grid Pallas TPU kernel. The CUDA C++ source is
`csrc/blur_stats.cu` (sm_90a); its header comment states the design.

  * The TPU kernel carries a line buffer and the sums from grid step to grid
    step. CUDA blocks run in no order, so each (row block, window) block
    loads its k//2 halo rows itself and a second kernel sums the per-block
    partials in row-block order.
  * It reads the unpadded (B, 4, H, W) stack with bounds masks: the TPU
    kernel's zero padding to (Hp, Wp), lane-aligned to 128, is not needed.
  * Every sum has a fixed order: results are bitwise equal run to run and a
    window's sums do not depend on its batch or slot.
  * Bound on the card: bytes (the stack is read once; 16k + 12 operations
    per pixel are far below the card's float32 rate).

`blur_stats_streaming_plain` is the same function in plain PyTorch: the
wrapper runs it for CPU tensors only, and `chip_smoke.py` holds the kernel
against it on the card. `blur_stats_streaming.launches` counts launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.contrast import streaming_stats
from .megakernel import SMEM_LIMIT


def blur_stats_streaming_plain(channels: torch.Tensor, taps: torch.Tensor,
                               *, rb: int = 16) -> torch.Tensor:
    """Plain PyTorch version: separable zero-padded blur, then the eight
    sums. (..., 4, H, W) -> (..., 8). `rb` only tiles the kernel's grid and
    does not change the function."""
    del rb
    return streaming_stats(channels.to(torch.float32), taps)


def _bind(lib):
    if getattr(lib, "_blur_stats_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.blur_stats_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.blur_stats_launch.restype = ctypes.c_int
    lib.blur_stats_error_string.argtypes = [ctypes.c_int]
    lib.blur_stats_error_string.restype = ctypes.c_char_p
    lib.blur_stats_smem_bytes.argtypes = [i, i, i]
    lib.blur_stats_smem_bytes.restype = ctypes.c_long
    lib._blur_stats_bound = True
    return lib


def blur_stats_streaming(channels: torch.Tensor, taps: torch.Tensor, *,
                         rb: int = 16) -> torch.Tensor:
    """Eq. 12 sums of the blurred stacks: (..., 4, H, W) f32 channels +
    (k,) FIR taps -> (..., 8) f32 [S1, S2, Gx, Gy, Gz, Tx, Ty, Tz].

    CUDA tensors launch the kernel (or raise); CPU tensors run
    `blur_stats_streaming_plain`."""
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
    if taps.dim() != 1 or k % 2 != 1:
        raise ValueError(f"blur_stats_streaming: taps must be (k,) with odd "
                         f"k; got {tuple(taps.shape)}")
    lead = channels.shape[:-3]
    H, W = channels.shape[-2:]
    B = math.prod(lead)

    from . import _build
    lib = _bind(_build.load("blur_stats"))
    smem = lib.blur_stats_smem_bytes(W, rb, k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"blur_stats_streaming: a {W}-wide block of {rb} "
                         f"rows with k={k} needs {smem} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may use")
    out = torch.empty(lead + (8,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    partial = torch.empty((B, math.ceil(H / rb), 8), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blur_stats_launch(channels.data_ptr(), taps.data_ptr(),
                                    partial.data_ptr(), out.data_ptr(),
                                    B, H, W, rb, k, stream)
    if err != 0:
        msg = lib.blur_stats_error_string(err).decode()
        raise RuntimeError(f"blur_stats_streaming launch failed: {msg} "
                           f"({err})")
    blur_stats_streaming.launches += 1
    return out


blur_stats_streaming.launches = 0
