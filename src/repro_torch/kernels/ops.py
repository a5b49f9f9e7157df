"""Public wrappers around the port's kernels (counterpart of
`repro.kernels.ops`).

Per-window engine (`"cuda"`, counterpart of `"pallas"`):

`pack_tiles`          : warp + tap expansion + stable tile sort and each
                        tile's run of taps (the Alg.-3 analogue at tile
                        granularity).
`iwe_accum`           : `pack_tiles`, then ONE `tile_accumulate` launch over
                        the runs and the reassembly of the tiles.
`blur_stats`          : the streaming blur/statistics kernel on a channel
                        stack.
`fused_engine_pass`   : `iwe_accum` -> `blur_stats` -> Eq. 12.

Each takes one window or a (B, N) batch: the batch is one launch per kernel.

Batched engine (`"cuda_batched"`, counterpart of `"pallas_batched"`):

`bin_taps`            : the binning prologue for a whole (B, N) batch —
                        warp, expand the 4 bilinear taps, key each
                        contributing tap by its destination pixel, order the
                        records with one stable sort and take per-pixel CSR
                        offsets from the sorted keys (the Alg.-3
                        count/scan/permute at pixel granularity); the
                        sorted keys go to the kernel too.
`batched_engine_stats`: prologue + ONE kernel call for the whole batch ->
                        `BatchedEngineOut((B, 8) Eq. 12 sums, spilled)`.
`batched_engine_pass` : the same, then Eq. 12 -> (variance (B,),
                        grad (B, 3), spilled (B,)).

Unlike the TPU megakernel's fixed per-slab capacity, the CSR segments have
no capacity: no tap is dropped at any event count, so the batched engine
equals the `reference` engine at every size. The per-window engine's tile
kernel reads each tile's whole run of taps, so it is exact at any capacity
too: the TPU's per-tile capacity is only the budget its `spilled` counts
the taps beyond.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.contrast import gaussian_taps, stats_to_objective
from ..core.geometry import warp_events
from ..core.iwe import TAP_OFFSETS, event_deltas
from ..core.types import Camera, EventWindow
from ..telemetry.spans import step
from .blur_stats import blur_stats_streaming
from .iwe_accum import tile_accumulate
from .megakernel import megakernel_stats


class IweAccumOut(NamedTuple):
    channels: torch.Tensor   # (..., 4, H_s, W_s) f32
    spilled: torch.Tensor    # (...) int32: taps beyond the tile capacity


class TilePack(NamedTuple):
    """The tile-accumulation kernel's inputs for a (B, N) batch: each
    window's taps sorted by tile, and each tile's run of them."""

    pix: torch.Tensor       # (B, 4N) int32 local pixel, tile-major; -1 past
                            # the runs (out-of-range taps)
    deltas: torch.Tensor    # (B, 4N, 4) f32 or bf16, in the same order
    offsets: torch.Tensor   # (B, T + 1) int32: tile t of window b is the
                            # run [offsets[b, t], offsets[b, t + 1]) of the
                            # flattened (B * 4N) taps
    cnt: torch.Tensor       # (B, T) int64 in-range taps per tile


def pack_tiles(ev: EventWindow, omega: torch.Tensor, cam: Camera,
               scale: float, weights: Optional[torch.Tensor] = None,
               tile: Tuple[int, int] = (8, 128),
               dtype=torch.float32) -> TilePack:
    """The `iwe_accum` prologue for a (B, N) batch under hypotheses (B, 3):
    warp, per-tap deltas, tile id and local pixel of each tap, a stable sort
    by tile, and per-tile counts and run offsets from the sorted keys (no
    host sync). Out-of-range taps sort to key T, past every run.

    A tap is valid when its event is in range, whatever its weight, as the
    reference counts it: zero-weight taps are in their tile's run and count
    in `cnt`."""
    Hs, Ws = cam.grid(scale)
    TH, TW = tile
    nty, ntx = -(-Hs // TH), -(-Ws // TW)
    T = nty * ntx
    B, N = ev.x.shape
    dev = ev.device

    w = warp_events(ev, omega, cam, scale)
    deltas = event_deltas(w, ev.p, weights).to(dtype)      # (B, N, 4, 4)
    # the 4 taps as independent contributions, tap-major: (B, 4N)
    ty = torch.cat([w.y0 + dy for dy, _ in TAP_OFFSETS], dim=-1)
    tx = torch.cat([w.x0 + dx for _, dx in TAP_OFFSETS], dim=-1)
    dv = deltas.transpose(1, 2).reshape(B, 4 * N, 4)
    valid = w.in_range.repeat(1, 4)
    tile_id = torch.where(valid, (ty // TH) * ntx + tx // TW, T)
    pix_local = torch.where(valid, (ty % TH) * TW + tx % TW, -1)

    tid_s, order = torch.sort(tile_id, dim=-1, stable=True)  # tile-major
    pix_s = torch.gather(pix_local, 1, order)
    dv_s = torch.gather(dv, 1, order.unsqueeze(-1).expand(B, 4 * N, 4))
    # each tile's run starts where the sorted keys reach it
    bounds = torch.searchsorted(
        tid_s, torch.arange(T + 1, dtype=tid_s.dtype, device=dev)
        .expand(B, T + 1).contiguous())
    cnt = bounds[:, 1:] - bounds[:, :T]                      # (B, T)
    offsets = bounds + torch.arange(B, device=dev).unsqueeze(-1) * (4 * N)
    return TilePack(pix=pix_s.to(torch.int32), deltas=dv_s,
                    offsets=offsets.to(torch.int32), cnt=cnt)


def iwe_accum(ev: EventWindow, omega: torch.Tensor, cam: Camera,
              scale: float, weights: Optional[torch.Tensor] = None,
              tile: Tuple[int, int] = (8, 128), capacity: int = 1024,
              dtype=torch.float32) -> IweAccumOut:
    """Warp + bilinear vote + tile-partitioned accumulation of one (N,)
    window or a (B, N) batch under hypotheses (3,) or (B, 3).

    The kernel reads each tile's whole run of taps, so the channels are
    exact, and the same bits, at any `capacity`: it is only the per-tile
    tap budget that `spilled` counts the taps beyond, as the reference
    counts them. `dtype` is the deltas' type (f32 or bf16); accumulation
    is always f32."""
    if ev.x.dim() == 1:
        out = iwe_accum(ev.map(lambda a: a.unsqueeze(0)), omega.unsqueeze(0),
                        cam, scale,
                        None if weights is None else weights.unsqueeze(0),
                        tile=tile, capacity=capacity, dtype=dtype)
        return IweAccumOut(out.channels[0], out.spilled[0])
    Hs, Ws = cam.grid(scale)
    TH, TW = tile
    nty, ntx = -(-Hs // TH), -(-Ws // TW)
    B = ev.x.shape[0]
    with step("pack_tiles"):
        pack = pack_tiles(ev, omega, cam, scale, weights, tile, dtype)
    with step("tile_accumulate"):
        tiles = tile_accumulate(pack.pix, pack.deltas, p_tile=TH * TW,
                                offsets=pack.offsets)
        # reassemble (B, T, P_TILE, 4) -> (B, 4, nty*TH, ntx*TW), cropped
        # (contiguous: where one tile spans the width, the reshape is a
        # channels-last view)
        channels = tiles.reshape(B, nty, ntx, TH, TW, 4) \
            .permute(0, 5, 1, 3, 2, 4).reshape(B, 4, nty * TH, ntx * TW)[
                ..., :Hs, :Ws].contiguous()
    spilled = (pack.cnt - capacity).clamp(min=0).sum(-1).to(torch.int32)
    return IweAccumOut(channels=channels, spilled=spilled)


def blur_stats(channels: torch.Tensor, num_taps: int, sigma: float,
               rb: int = 16, fir: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Streaming separable Gaussian + Eq. 12 running sums of a
    (..., 4, H, W) channel stack -> (..., 8) f32 [S1,S2,Gx,Gy,Gz,Tx,Ty,Tz].
    `fir` may carry precomputed Gaussian taps."""
    if fir is None:
        fir = gaussian_taps(num_taps, sigma, torch.float32,
                            device=channels.device)
    return blur_stats_streaming(channels.to(torch.float32).contiguous(), fir,
                                rb=rb)


def fused_engine_pass(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                      scale: float, num_taps: int, sigma: float,
                      weights: Optional[torch.Tensor] = None,
                      tile: Tuple[int, int] = (8, 128),
                      capacity: int = 1024,
                      fir: Optional[torch.Tensor] = None):
    """Per-window engine pass: accumulate + streaming stats -> (variance,
    grad (..., 3), spilled) for one (N,) window or a (B, N) batch."""
    acc = iwe_accum(ev, omega, cam, scale, weights=weights, tile=tile,
                    capacity=capacity)
    Hs, Ws = cam.grid(scale)
    with step("blur_stats"):
        stats = blur_stats(acc.channels, num_taps, sigma, fir=fir)
    var, grad = stats_to_objective(stats, Hs * Ws)
    return var, grad, acc.spilled


class BatchedEngineOut(NamedTuple):
    stats: torch.Tensor     # (B, 8) f32 Eq. 12 running sums per window
    spilled: torch.Tensor   # (B,) int32 contributing taps dropped: always
                            # zero, the CSR segments have no capacity


# One int32 zero per device, made once: `spilled` is a (B,) view of it, so
# an engine pass adds no allocation and no launch for a result that its
# callers drop. The view has stride 0, so writing to it (B > 1) raises.
_ZERO: dict = {}


def _no_spill(device: torch.device, B: int) -> torch.Tensor:
    z = _ZERO.get(device)
    if z is None:
        z = torch.zeros(1, dtype=torch.int32, device=device)
        if z.is_cuda:
            # finished before any stream of any thread reads it
            torch.cuda.current_stream(device).synchronize()
        z = _ZERO.setdefault(device, z)
    return z.expand(B)


class TapBins(NamedTuple):
    """The kernel's inputs for one batch at one stage grid."""

    x: torch.Tensor        # (B, N) f32 event x
    y: torch.Tensor        # (B, N) f32 event y
    dt: torch.Tensor       # (B, N) f32 t - t_ref
    pw: torch.Tensor       # (B, N) f32 polarity * retention weight
    rec: torch.Tensor      # (B, 4N) int32 tap*N + event, pixel-ordered
    pix_off: torch.Tensor  # (B, P+1) int32 CSR offsets; [:, P] = live taps
    key: torch.Tensor      # (B, 4N) int32 each record's pixel (sorted; P
                           # past the live records)


def bin_taps(ev: EventWindow, omega: torch.Tensor, weights: torch.Tensor,
             cam: Camera, scale: float) -> TapBins:
    """Pixel-binning prologue for a (B, N) batch under hypotheses (B, 3).

    Taps of events that are out of range or carry zero weight (dropped by
    subsampling, padded, dead windows) have identically zero deltas and go
    to the dump key P, after every live record."""
    Hs, Ws = cam.grid(scale)
    P = Hs * Ws
    B, N = ev.x.shape
    dev = ev.device
    f32 = torch.float32
    w = warp_events(ev, omega, cam, scale)
    dt = ev.t - ev.t_ref.unsqueeze(-1)
    pw = ev.p.to(f32) * weights.to(f32)
    live = w.in_range & (pw != 0.0)
    dump = torch.full_like(w.x0, P)
    key = torch.cat([torch.where(live, (w.y0 + dy) * Ws + (w.x0 + dx), dump)
                     for dy, dx in TAP_OFFSETS], dim=-1)       # (B, 4N)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    # each pixel's run starts where the sorted keys reach it: CSR offsets
    # without atomics or a host sync
    bounds = torch.arange(P + 1, dtype=key.dtype, device=dev)
    pix_off = torch.searchsorted(key_s, bounds.expand(B, P + 1).contiguous())
    c = lambda a: a.to(f32).contiguous()
    return TapBins(x=c(ev.x), y=c(ev.y), dt=c(dt), pw=c(pw),
                   rec=order.to(torch.int32).contiguous(),
                   pix_off=pix_off.to(torch.int32).contiguous(),
                   key=key_s.to(torch.int32).contiguous())


def batched_engine_stats(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                         scale: float, num_taps: int, sigma: float,
                         weights: Optional[torch.Tensor] = None,
                         rb: int = 8,
                         fir: Optional[torch.Tensor] = None
                         ) -> BatchedEngineOut:
    """Full batched engine pass -> (B, 8) Eq. 12 stats and (B,) spilled
    taps (zeros), as the reference returns them: the prologue plus one
    kernel call. `ev` arrays are (B, N) (padded slots valid=False);
    `omega` is (B, 3); `fir` may carry precomputed Gaussian taps."""
    Hs, Ws = cam.grid(scale)
    if weights is None:
        weights = torch.ones_like(ev.x, dtype=torch.float32)
    if fir is None:
        fir = gaussian_taps(num_taps, sigma, torch.float32, device=ev.device)
    omega = omega.to(torch.float32).contiguous()
    with step("bin_taps"):
        bins = bin_taps(ev, omega, weights, cam, scale)
    with step("megakernel"):
        stats = megakernel_stats(*bins, omega, fir, H=Hs, W=Ws, rb=rb,
                                 scale=scale, fx=cam.fx, fy=cam.fy,
                                 cx=cam.cx, cy=cam.cy)
    return BatchedEngineOut(stats=stats, spilled=_no_spill(ev.device,
                                                          ev.x.shape[0]))


def batched_engine_pass(ev: EventWindow, omega: torch.Tensor, cam: Camera,
                        scale: float, num_taps: int, sigma: float,
                        weights: Optional[torch.Tensor] = None,
                        rb: int = 8, fir: Optional[torch.Tensor] = None):
    """Batched engine pass -> (variance (B,), grad (B, 3), spilled (B,))."""
    out = batched_engine_stats(ev, omega, cam, scale, num_taps, sigma,
                               weights=weights, rb=rb, fir=fir)
    Hs, Ws = cam.grid(scale)
    var, grad = stats_to_objective(out.stats, Hs * Ws)
    return var, grad, out.spilled
