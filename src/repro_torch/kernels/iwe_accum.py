"""Tile-partitioned IWE / dIWE accumulation: each spatial tile's packed tap
records (local pixel, four channel deltas) in, the tile's (P_TILE, 4) f32
partial image out,

    tile[p, c] = sum over slots e of [pix_local[e] == p] * delta[e, c].

Replaces `src/repro/kernels/iwe_accum.py::tile_accumulate`, the
one-grid-step-per-tile Pallas TPU kernel (an MXU one-hot product). The
CUDA C++ source is `csrc/iwe_accum.cu` (sm_90a); its header comment states
the design.

  * Same contract as the TPU kernel plus a leading window axis:
    (B, T, CAP) int32 pix_local with -1 for an empty slot, and
    (B, T, CAP, 4) f32 or bf16 deltas -> (B, T, P_TILE, 4) f32. Slots may
    be in any order; accumulation is always f32.
  * One block per tile sorts the tile's slots by pixel in shared memory
    (a stable counting sort, in chunks), then one thread per pixel adds its
    run in slot order: no float atomics, bitwise equal to the plain version,
    run to run and whatever batch a window is in.

`tile_accumulate_plain` is the same function in plain PyTorch (a scatter-add
in slot order): the wrapper runs it for CPU tensors only, and
`chip_smoke.py` holds the kernel against it on the card.
`tile_accumulate.launches` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.iwe import _deterministic

_DELTA_TYPES = (torch.float32, torch.bfloat16)


def tile_accumulate_plain(pix_local: torch.Tensor, deltas: torch.Tensor, *,
                          p_tile: int) -> torch.Tensor:
    """Plain PyTorch version: every slot's deltas scatter-added (in f32, in
    slot order) into its tile's pixel; empty slots (-1) and pixels outside
    [0, p_tile) add nothing, as in the one-hot product.
    (B, T, CAP) + (B, T, CAP, 4) -> (B, T, P_TILE, 4)."""
    B, T, cap = pix_local.shape
    dev = pix_local.device
    pix = pix_local.to(torch.int64)
    hit = (pix >= 0) & (pix < p_tile)
    base = torch.arange(B * T, device=dev).view(B, T, 1) * (p_tile + 1)
    # misses go to a dump row past each tile's pixels
    idx = base + torch.where(hit, pix, torch.full_like(pix, p_tile))
    out = torch.zeros((B * T * (p_tile + 1), 4), dtype=torch.float32,
                      device=dev)
    with _deterministic():
        out.index_add_(0, idx.reshape(-1),
                       deltas.reshape(-1, 4).to(torch.float32))
    return out.view(B, T, p_tile + 1, 4)[:, :, :p_tile]


def _bind(lib):
    if getattr(lib, "_tile_accumulate_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_accumulate_launch.argtypes = [p, p, i, p, i, i, i, p]
    lib.tile_accumulate_launch.restype = ctypes.c_int
    lib.tile_accumulate_error_string.argtypes = [ctypes.c_int]
    lib.tile_accumulate_error_string.restype = ctypes.c_char_p
    lib.tile_accumulate_max_pixels.argtypes = []
    lib.tile_accumulate_max_pixels.restype = ctypes.c_int
    lib.tile_accumulate_smem_bytes.argtypes = [ctypes.c_int]
    lib.tile_accumulate_smem_bytes.restype = ctypes.c_long
    lib._tile_accumulate_bound = True
    return lib


def tile_accumulate(pix_local: torch.Tensor, deltas: torch.Tensor, *,
                    p_tile: int) -> torch.Tensor:
    """Tile partials: (B, T, CAP) int32 local pixels (-1 = empty) +
    (B, T, CAP, 4) f32 or bf16 deltas -> (B, T, P_TILE, 4) f32.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    `tile_accumulate_plain`."""
    dev = pix_local.device
    if dev.type == "cpu":
        return tile_accumulate_plain(pix_local, deltas, p_tile=p_tile)
    if dev.type != "cuda":
        raise ValueError(f"tile_accumulate: unsupported device {dev}")
    if pix_local.dim() != 3 or pix_local.dtype != torch.int32 \
            or pix_local.device != dev or not pix_local.is_contiguous():
        raise ValueError(
            "tile_accumulate: pix_local must be a contiguous (B, T, CAP) "
            f"int32 tensor on {dev}; got {pix_local.dtype} "
            f"{tuple(pix_local.shape)} on {pix_local.device}")
    if deltas.dtype not in _DELTA_TYPES \
            or tuple(deltas.shape) != tuple(pix_local.shape) + (4,) \
            or deltas.device != dev or not deltas.is_contiguous():
        raise ValueError(
            "tile_accumulate: deltas must be a contiguous (B, T, CAP, 4) "
            f"float32 or bfloat16 tensor on {dev}; got {deltas.dtype} "
            f"{tuple(deltas.shape)} on {deltas.device}")
    slot_bytes = 4 * deltas.element_size()
    if deltas.data_ptr() % slot_bytes:
        raise ValueError(f"tile_accumulate: deltas must start on a "
                         f"{slot_bytes}-byte boundary (one slot)")

    from . import _build
    lib = _bind(_build.load("iwe_accum"))
    if not 0 < p_tile <= lib.tile_accumulate_max_pixels():
        raise ValueError(f"tile_accumulate: p_tile={p_tile} is outside "
                         f"(0, {lib.tile_accumulate_max_pixels()}]")
    B, T, cap = pix_local.shape
    out = torch.empty((B, T, p_tile, 4), dtype=torch.float32, device=dev)
    if B * T == 0 or cap == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tile_accumulate_launch(
            pix_local.data_ptr(), deltas.data_ptr(),
            int(deltas.dtype == torch.bfloat16), out.data_ptr(), B * T, cap,
            p_tile, stream)
    if err != 0:
        msg = lib.tile_accumulate_error_string(err).decode()
        raise RuntimeError(f"tile_accumulate launch failed: {msg} ({err})")
    _build.count_launch(tile_accumulate)
    return out


tile_accumulate.launches = 0
