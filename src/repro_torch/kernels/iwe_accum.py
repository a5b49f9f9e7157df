"""Tile-partitioned IWE / dIWE accumulation: each spatial tile's tap records
(local pixel, four channel deltas) in, the tile's (P_TILE, 4) f32 partial
image out,

    tile[p, c] = sum over slots e of [pix_local[e] == p] * delta[e, c].

Replaces `src/repro/kernels/iwe_accum.py::tile_accumulate`, the
one-grid-step-per-tile Pallas TPU kernel (an MXU one-hot product). The
CUDA C++ source is `csrc/iwe_accum.cu` (sm_90a); its header comment states
the design.

  * The TPU kernel's contract, on runs: (B, L) int32 pix_local (-1 = an
    empty slot) and (B, L, 4) f32 or bf16 deltas with (B, T + 1) int32
    `offsets`, tile t of window b reading the slots
    [offsets[b, t], offsets[b, t + 1]) of the flattened (B * L) slots (each
    window's first slot, b * L, folded in) -> (B, T, P_TILE, 4) f32. A run
    has any length: this is the per-window engine's layout
    (`ops.pack_tiles`), in which no tap is beyond a capacity. The TPU
    kernel's packed (B, T, CAP) slots are the case
    offsets[b, t] = (b * T + t) * CAP. Slots may be in any order within a
    run; accumulation is always f32.
  * `offsets`, flattened, is non-decreasing and within [0, B * L]. The
    plain version checks it; the kernel reads what it is given, so the
    wrapper checks only its shape (a check of its values would sync the
    host with the card on every pass).
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


def tile_accumulate_plain(pix_local: torch.Tensor, deltas: torch.Tensor,
                          offsets: torch.Tensor, *, p_tile: int
                          ) -> torch.Tensor:
    """Plain PyTorch version: every slot's deltas scatter-added (in f32, in
    slot order) into its run's tile's pixel; empty slots (-1), pixels
    outside [0, p_tile) and slots in no run add nothing, as in the one-hot
    product. (B, L) + (B, L, 4) with (B, T + 1) `offsets` ->
    (B, T, P_TILE, 4)."""
    dev = pix_local.device
    B, T = offsets.shape[0], offsets.shape[1] - 1
    flat = offsets.reshape(-1).to(torch.int64)
    if flat.numel() and (bool((flat[1:] < flat[:-1]).any())
                         or int(flat[0]) < 0
                         or int(flat[-1]) > pix_local.numel()):
        raise ValueError("tile_accumulate: offsets must be non-decreasing "
                         f"and within [0, {pix_local.numel()}]")
    # the run each slot is in: k = b (T + 1) + t, where t = T past the
    # window's last run
    k = torch.searchsorted(flat, torch.arange(pix_local.numel(), device=dev),
                           right=True) - 1
    tile = torch.where((k >= 0) & (k % (T + 1) < T), k - k // (T + 1), B * T)
    pix = pix_local.reshape(-1).to(torch.int64)
    hit = (pix >= 0) & (pix < p_tile) & (tile < B * T)
    # misses go to a dump row past each tile's pixels, or past the last
    # tile's
    idx = tile * (p_tile + 1) + torch.where(hit, pix, p_tile)
    out = torch.zeros(((B * T + 1) * (p_tile + 1), 4), dtype=torch.float32,
                      device=dev)
    with _deterministic():
        out.index_add_(0, idx, deltas.reshape(-1, 4).to(torch.float32))
    return out[:B * T * (p_tile + 1)].view(B, T, p_tile + 1, 4)[
        :, :, :p_tile]


def _bind(lib):
    if getattr(lib, "_tile_accumulate_bound", False):
        return lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tile_accumulate_runs_launch.argtypes = [p, p, p, i, p, i, i, i, p]
    lib.tile_accumulate_runs_launch.restype = ctypes.c_int
    lib.tile_accumulate_error_string.argtypes = [ctypes.c_int]
    lib.tile_accumulate_error_string.restype = ctypes.c_char_p
    lib.tile_accumulate_max_pixels.argtypes = []
    lib.tile_accumulate_max_pixels.restype = ctypes.c_int
    lib.tile_accumulate_smem_bytes.argtypes = [ctypes.c_int]
    lib.tile_accumulate_smem_bytes.restype = ctypes.c_long
    lib._tile_accumulate_bound = True
    return lib


def tile_accumulate(pix_local: torch.Tensor, deltas: torch.Tensor,
                    offsets: torch.Tensor, *, p_tile: int) -> torch.Tensor:
    """Tile partials: (B, L) int32 local pixels (-1 = empty) + (B, L, 4)
    f32 or bf16 deltas, in runs of (B, T + 1) int32 `offsets` ->
    (B, T, P_TILE, 4) f32.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    `tile_accumulate_plain`."""
    dev = pix_local.device
    if dev.type == "cpu":
        return tile_accumulate_plain(pix_local, deltas, offsets=offsets,
                                     p_tile=p_tile)
    if dev.type != "cuda":
        raise ValueError(f"tile_accumulate: unsupported device {dev}")
    if pix_local.dim() != 2 or pix_local.dtype != torch.int32 \
            or pix_local.device != dev or not pix_local.is_contiguous():
        raise ValueError(
            "tile_accumulate: pix_local must be a contiguous (B, L) int32 "
            f"tensor on {dev}; got {pix_local.dtype} "
            f"{tuple(pix_local.shape)} on {pix_local.device}")
    if deltas.dtype not in _DELTA_TYPES \
            or tuple(deltas.shape) != tuple(pix_local.shape) + (4,) \
            or deltas.device != dev or not deltas.is_contiguous():
        raise ValueError(
            "tile_accumulate: deltas must be a contiguous (B, L, 4) float32 "
            f"or bfloat16 tensor on {dev}; got {deltas.dtype} "
            f"{tuple(deltas.shape)} on {deltas.device}")
    if offsets.dim() != 2 or offsets.shape[0] != pix_local.shape[0] \
            or offsets.shape[1] < 2 or offsets.dtype != torch.int32 \
            or offsets.device != dev or not offsets.is_contiguous():
        raise ValueError(
            "tile_accumulate: offsets must be a contiguous (B, T + 1) int32 "
            f"tensor on {dev} with B = {pix_local.shape[0]}; got "
            f"{offsets.dtype} {tuple(offsets.shape)} on {offsets.device}")
    if pix_local.numel() >= 2 ** 31:
        raise ValueError("tile_accumulate: more slots than int32 offsets "
                         "address")
    slot_bytes = 4 * deltas.element_size()
    if deltas.data_ptr() % slot_bytes:
        raise ValueError(f"tile_accumulate: deltas must start on a "
                         f"{slot_bytes}-byte boundary (one slot)")

    from . import _build
    lib = _bind(_build.load("iwe_accum"))
    if not 0 < p_tile <= lib.tile_accumulate_max_pixels():
        raise ValueError(f"tile_accumulate: p_tile={p_tile} is outside "
                         f"(0, {lib.tile_accumulate_max_pixels()}]")
    B, T = offsets.shape[0], offsets.shape[1] - 1
    out = torch.empty((B, T, p_tile, 4), dtype=torch.float32, device=dev)
    if B == 0 or pix_local.shape[1] == 0:
        return out.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tile_accumulate_runs_launch(
            pix_local.data_ptr(), deltas.data_ptr(), offsets.data_ptr(),
            int(deltas.dtype == torch.bfloat16), out.data_ptr(), B, T,
            p_tile, stream)
    if err != 0:
        msg = lib.tile_accumulate_error_string(err).decode()
        raise RuntimeError(f"tile_accumulate launch failed: {msg} ({err})")
    _build.count_launch(tile_accumulate)
    return out


tile_accumulate.launches = 0
