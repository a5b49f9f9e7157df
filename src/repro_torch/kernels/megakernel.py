"""Batched CMAX engine-pass kernel: the whole engine pass for a batch of
windows — warp (Alg. 2) -> bilinear vote into IWE + dIWE -> separable
Gaussian blur -> Eq. 12 eight-sum statistics — in one call.

Replaces `src/repro/kernels/megakernel.py::megakernel_stats`, the fused
(batch, row-slab)-grid Pallas TPU kernel. The CUDA C++ source is
`csrc/megakernel.cu` (sm_90a); its header comment states the design.

  * Inputs are the binning prologue's pixel-ordered tap records with CSR
    offsets and sorted keys (`ops.bin_taps`), not the TPU kernel's
    fixed-capacity slab bins: there is no capacity and no tap is ever
    dropped.
  * One call is four launches: pack the event fields; vote each pixel once
    (records in parallel, then each pixel's run in record order) into a
    (B, 4, H, W) scratch; blur and sum per row slab; sum the slab partials
    in slab order. `launch_config` chooses the grid from the stage shape
    alone.
  * Every reduction has a fixed order and no grid depends on the batch:
    results are bitwise equal run to run and a window's stats do not depend
    on its batch or slot.
  * A tap's integer pixel is the prologue's; the kernel recomputes only
    the subpixel fractions and Jacobians (and is built with --fmad=false).

`megakernel_stats_plain` is the same function in plain PyTorch: the
wrapper runs it for CPU tensors only, and `chip_smoke.py` holds the kernel
against it on the card. `megakernel_stats.launches` counts calls that
launched the kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.contrast import streaming_stats

SMEM_LIMIT = 232448   # bytes of shared memory one Hopper block may use
MAX_VOTE_PIXELS = 256  # threads of a vote block (csrc/megakernel.cu)
MIN_VOTE_BLOCKS = 32   # vote blocks per window the pixel range aims for


class LaunchConfig(NamedTuple):
    """The kernel's grid for one stage shape."""

    vote_pixels: int   # pixels (and records' range) per vote block
    vote_blocks: int   # vote blocks per window
    n_slabs: int       # blur / stats blocks per window (rb rows each)
    smem: int          # dynamic shared memory of a slab block (bytes)


def launch_config(H: int, W: int, k: int, rb: int) -> LaunchConfig:
    """Grid of the kernel at an H x W stage grid, k blur taps and `rb`
    output rows per slab. The vote's pixel range is the largest power of two
    up to MAX_VOTE_PIXELS that still gives each window MIN_VOTE_BLOCKS
    blocks (at least 32 pixels), so the coarse stages fill the card too.
    Nothing depends on the batch size, so a window's bits do not either
    (the vote's range would not change them anyway: each pixel sums its
    records in record order whatever block it is in)."""
    P = H * W
    vote_pixels = MAX_VOTE_PIXELS
    while vote_pixels > 32 and -(-P // vote_pixels) < MIN_VOTE_BLOCKS:
        vote_pixels //= 2
    return LaunchConfig(vote_pixels=vote_pixels,
                        vote_blocks=-(-P // vote_pixels),
                        n_slabs=-(-H // rb), smem=16 * (rb + k - 1) * W)


def _warp_parts(ex, ey, edt, wx, wy, wz, scale, fx, fy, cx, cy):
    """The Alg. 2 warp of geometry.warp_events, op for op."""
    xn = (ex - cx) / fx
    yn = (ey - cy) / fy
    Bq = 1.0 + xn * xn
    Dq = 1.0 + yn * yn
    XY = xn * yn
    u = fx * (XY * wx - Bq * wy + yn * wz)
    v = fy * (Dq * wx - XY * wy - xn * wz)
    xw = scale * (ex - edt * u)
    yw = scale * (ey - edt * v)
    sdt = scale * edt
    rx = (sdt * fx * XY, -sdt * fx * Bq, sdt * fx * yn)
    ry = (sdt * fy * Dq, -sdt * fy * XY, -sdt * fy * xn)
    return xw, yw, rx, ry


def megakernel_stats_plain(x, y, dt, pw, rec, pix_off, key, omega, fir, *,
                           H: int, W: int, rb: int, scale: float, fx: float,
                           fy: float, cx: float, cy: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same records, the same
    per-tap arithmetic and per-pixel summation order, through a
    scatter-add and `streaming_stats`. Returns (B, 8). `rb` only tiles the
    kernel's grid and does not change the function. Each record's pixel is
    found from the CSR offsets, not read from `key` as the kernel reads it,
    so a key that disagreed with the offsets would show as a mismatch."""
    del rb, key
    B, N = x.shape
    P = H * W
    M = rec.shape[1]
    dev = x.device
    off = pix_off.to(torch.int64)
    j = torch.arange(M, device=dev).expand(B, M).contiguous()
    live = j < off[:, P:P + 1]
    pix = torch.searchsorted(off, j, right=True) - 1
    pix = torch.where(live, pix, torch.zeros_like(pix))
    code = rec.to(torch.int64)
    tap = torch.div(code, N, rounding_mode="floor")
    e = code - tap * N
    dy, dx = tap // 2, tap % 2
    row = torch.div(pix, W, rounding_mode="floor")
    col = pix - row * W

    g = lambda a: torch.gather(a, 1, e)
    wx, wy, wz = omega[:, 0:1], omega[:, 1:2], omega[:, 2:3]
    xw, yw, rx, ry = _warp_parts(g(x), g(y), g(dt), wx, wy, wz, scale, fx,
                                 fy, cx, cy)
    ax = xw - (col - dx).to(xw.dtype)
    ay = yw - (row - dy).to(yw.dtype)
    is_dx, is_dy = dx == 1, dy == 1
    wxa = torch.where(is_dx, ax, 1.0 - ax)
    wya = torch.where(is_dy, ay, 1.0 - ay)
    wt = wxa * wya
    cxc = torch.where(is_dx, -wya, wya)
    cyc = torch.where(is_dy, -wxa, wxa)
    epw = torch.where(live, g(pw), torch.zeros_like(wt))
    deltas = torch.stack([epw * wt,
                          epw * (cxc * rx[0] + cyc * ry[0]),
                          epw * (cxc * rx[1] + cyc * ry[1]),
                          epw * (cxc * rx[2] + cyc * ry[2])], dim=-1)
    deltas = torch.where(live.unsqueeze(-1), deltas,
                         torch.zeros_like(deltas))

    base = (torch.arange(B, device=dev).view(B, 1, 1) * 4
            + torch.arange(4, device=dev).view(1, 1, 4)) * P
    idx = base + pix.unsqueeze(-1)
    img = torch.zeros(B * 4 * P, dtype=torch.float32, device=dev)
    img.index_add_(0, idx.reshape(-1), deltas.reshape(-1))
    return streaming_stats(img.view(B, 4, H, W), fir)


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(
            f"megakernel_stats: {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {dev}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _bind(lib):
    if getattr(lib, "_megakernel_bound", False):
        return lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.megakernel_stats_launch.argtypes = [p] * 13 + [i] * 7 + [f] * 5 + [p]
    lib.megakernel_stats_launch.restype = ctypes.c_int
    lib.megakernel_error_string.argtypes = [ctypes.c_int]
    lib.megakernel_error_string.restype = ctypes.c_char_p
    lib.megakernel_smem_bytes.argtypes = [i, i, i]
    lib.megakernel_smem_bytes.restype = ctypes.c_long
    lib.megakernel_max_vote_pixels.argtypes = []
    lib.megakernel_max_vote_pixels.restype = ctypes.c_int
    lib._megakernel_bound = True
    return lib


def megakernel_stats(x, y, dt, pw, rec, pix_off, key, omega, fir, *, H: int,
                     W: int, rb: int, scale: float, fx: float, fy: float,
                     cx: float, cy: float) -> torch.Tensor:
    """Engine-pass stats for a batch: records from `ops.bin_taps` + per-window
    hypotheses (B, 3) + FIR taps (k,) -> (B, 8) [S1,S2,Gx,Gy,Gz,Tx,Ty,Tz].

    CUDA tensors launch the kernel (or raise); CPU tensors run
    `megakernel_stats_plain`."""
    dev = x.device
    if dev.type == "cpu":
        return megakernel_stats_plain(
            x, y, dt, pw, rec, pix_off, key, omega, fir, H=H, W=W, rb=rb,
            scale=scale, fx=fx, fy=fy, cx=cx, cy=cy)
    if dev.type != "cuda":
        raise ValueError(f"megakernel_stats: unsupported device {dev}")
    B, N = x.shape
    k = fir.shape[0]
    P = H * W
    f32, i32 = torch.float32, torch.int32
    for name, t in (("x", x), ("y", y), ("dt", dt), ("pw", pw)):
        _check(name, t, f32, (B, N), dev)
    _check("rec", rec, i32, (B, 4 * N), dev)
    _check("pix_off", pix_off, i32, (B, P + 1), dev)
    _check("key", key, i32, (B, 4 * N), dev)
    _check("omega", omega, f32, (B, 3), dev)
    _check("fir", fir, f32, (k,), dev)
    if 4 * N >= 2 ** 31:
        raise ValueError(f"megakernel_stats: N={N} events overflow the "
                         "int32 tap records")

    from . import _build
    lib = _bind(_build.load("megakernel"))
    cfg = launch_config(H, W, k, rb)
    if cfg.smem > SMEM_LIMIT:
        raise ValueError(f"megakernel_stats: a {W}-wide slab of {rb} rows "
                         f"with k={k} needs {cfg.smem} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block may use")
    out = torch.empty((B, 8), dtype=f32, device=dev)
    if B == 0:
        return out
    ev4 = torch.empty((B, N, 4), dtype=f32, device=dev)
    img = torch.empty((B, 4, H, W), dtype=f32, device=dev)
    partial = torch.empty((B, cfg.n_slabs, 8), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.megakernel_stats_launch(
            x.data_ptr(), y.data_ptr(), dt.data_ptr(), pw.data_ptr(),
            rec.data_ptr(), pix_off.data_ptr(), key.data_ptr(),
            omega.data_ptr(), fir.data_ptr(), ev4.data_ptr(), img.data_ptr(),
            partial.data_ptr(), out.data_ptr(), B, N, H, W, rb, k,
            cfg.vote_pixels, scale, fx, fy, cx, cy, stream)
    if err != 0:
        msg = lib.megakernel_error_string(err).decode()
        raise RuntimeError(f"megakernel_stats launch failed: {msg} ({err})")
    _build.count_launch(megakernel_stats)
    return out


megakernel_stats.launches = 0
