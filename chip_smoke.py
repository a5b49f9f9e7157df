"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, all at once), holds each kernel against its plain PyTorch
version at its path's full shapes, drives both estimation paths at the
paper's size, and times the kernels. Phases:

  1. device     the card's name, capability (must be 9.0), power limit;
  2. kernels    each kernel against its plain version at every stage's
                shapes (B=8 POSTER windows of 40,000 events, 2,500
                features), bitwise equal on a rerun, and each window's B=1
                result bitwise equal to its slot of the B=8 batch:
                  megakernel_stats: variance rtol=1e-4, max-normalized
                    gradient atol=1e-4;
                  tile_accumulate: at capacity 4096 and at the zero-spill
                    capacity, f32 and bf16 deltas: tiles bitwise equal to
                    the plain version (both sum each pixel in slot order);
                    iwe_accum's `spilled` equal to the count from the
                    per-tile tap counts, its channels (kernel + fold-back)
                    rtol=atol=1e-4 of the reference scatter;
                  blur_stats_streaming: on those channel stacks, the sums
                    within 1e-3 of each window's largest, variance
                    rtol=1e-4, max-normalized gradient atol=1e-4 (its
                    launch geometry and compiler report are printed);
  3. main path  estimate_streams on 8 streams x 4 windows at 240x180 with
                engine="cuda_batched": launch counts equal the lockstep
                engine passes (the passes per stage, from the stage
                traces, are printed and must add up to the launches),
                and the first window of each stream agrees
                with the port's `reference` engine on the card (omega
                atol=5e-4, v_final rtol=1e-3);
  4. per-window estimate_sequence of one stream of 4 windows and
     path       estimate_batch of 8 windows with engine="cuda" at
                engine_capacity=4096: each new kernel's launches equal the
                engine passes taken, RMSE vs omega_true < 0.5 rad/s, the
                first windows agree with the reference engine as in 3;
  5. serve      the serving layer: 8 streams x 4 ragged windows of 20,000
                to 40,000 events (the POSTER windows of 3, each cut by
                `ragged_lengths`) served by AsyncBatchedEstimationService
                (pow2 classes 32,768 and 65,536, max_batch 8, 2 batches in
                flight, the threaded dispatch executor) under cuda_batched:
                every response ok and bitwise equal to the workload's
                batch-1 chain, RMSE vs omega_true < 0.5 rad/s, megakernel
                launches equal to the served batches' lockstep passes, no
                per-window kernel launched, a second batch submitted while
                the first still ran; the synchronous service gives the same
                bits; then 2 streams x 2 windows under engine="cuda", whose
                two kernels' launches equal its passes. Windows/s, latency,
                batches, classes built and padding are printed;
  6. timing     each kernel's time per launch (CUDA events; the blur kernel
                at B=8 and at B=1, the estimate_sequence path), its prologue's,
                its plain version's and, where one PyTorch call computes the
                same function, that call's, against the bound set by the
                bytes and operations the function needs.

The second-to-last line is the `kernels` JSON object and the last line is
{"ok": true, "device": {...}}. Any failed phase raises and the script exits
non-zero without that line. It needs no network, imports no JAX, and exits
non-zero without a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS = 67e12             # H100 SXM float32 rate outside tensor cores
# float operations per live tap record in the kernel's vote (warp, bilinear
# weight and derivative coefficients, four channel updates), counted from
# csrc/megakernel.cu
TAP_FLOPS = 60

B_WINDOWS = 8
N_EVENTS = 40000
N_FEATURES = 2500
STREAMS, WINDOWS_PER_STREAM = 8, 4
SERVE_EVENTS = (20000, 40000)  # ragged window lengths of the [serve] phase
CAPACITY = 4096               # the "cuda" engine's default per-tile budget
TILE = (8, 128)
P_TILE = TILE[0] * TILE[1]


def ptxas_entries(log: str) -> dict:
    """{entry function: its lines of the compiler's report (registers,
    shared memory, spills)} from an `nvcc -Xptxas -v` log."""
    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = entries.setdefault(m.group(1), [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.strip())
    return entries


def blur_geometry(cfg) -> str:
    """The blur kernel's launch geometry at one stage, in words."""
    return (f"{cfg.n_strips} strips of 64 columns x {cfg.n_bands} bands of "
            f"{cfg.band_rows} rows per window: {cfg.items} one-warp blocks, "
            f"{cfg.smem} B shared each")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3, hold: bool = True) -> float:
    """Mean ms per call of `fn` from CUDA events over `reps` calls.

    With `hold`, the device first spins for longer than the host needs to
    enqueue the calls, so the events time the device's work even where the
    host enqueues slower than the device runs (small launches); a call that
    syncs with the host is still timed at the host's pace. Without it, the
    time is the pace at which a caller issuing the calls sees them finish.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        # ~2e9 spin cycles per second at the card's clock, at most 1 s
        torch.cuda._sleep(int(min(2 * host_s * reps, 1.0) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rmse(est: np.ndarray, ref: np.ndarray) -> float:
    e = np.linalg.norm(est - ref, axis=-1)
    return float(np.sqrt((e ** 2).mean()))


def tile_counts(T, ev, omega, cam, scale):
    """(B, n_tiles) in-range taps per 8x128 tile, counted with bincount
    straight from the warp (independent of the prologue's sort)."""
    Hs, Ws = cam.grid(scale)
    ntx = -(-Ws // TILE[1])
    n_tiles = -(-Hs // TILE[0]) * ntx
    w = T.warp_events(ev, omega, cam, scale)
    cols = []
    for b in range(ev.x.shape[0]):
        ids = [((w.y0[b] + dy) // TILE[0]) * ntx + (w.x0[b] + dx) // TILE[1]
               for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
        ids = torch.cat(ids)[w.in_range[b].repeat(4)]
        cols.append(torch.bincount(ids.long(), minlength=n_tiles))
    return torch.stack(cols)


def zero_spill_capacity(cnt) -> int:
    """The smallest power of two at or above the largest tile count."""
    return 1 << max(int(cnt.max()) - 1, 0).bit_length()


def check_window_kernels(T, ops, ref, tile_accumulate, tile_accumulate_plain,
                         blur_stats_streaming, blur_stats_streaming_plain,
                         blur_launch_config, cfg, first, om_b):
    """Phase 2 for the per-window engine's two kernels; returns what the
    timing phase needs per stage and the largest errors."""
    cam = cfg.camera
    rows, err_tile, err_blur = [], 0.0, 0.0
    for st in cfg.stages:
        Hs, Ws = st.grid(cam)
        weights = T.sort_events(first, om_b, cam, st).weights
        cnt = tile_counts(T, first, om_b, cam, st.scale)
        zero_cap = zero_spill_capacity(cnt)
        packs = {}
        for cap in sorted({CAPACITY, zero_cap}):
            for dtype in (torch.float32, torch.bfloat16):
                pack = ops.pack_tiles(first, om_b, cam, st.scale, weights,
                                      tile=TILE, capacity=cap, dtype=dtype)
                check(torch.equal(pack.cnt, cnt),
                      "the prologue's tile counts differ from bincount's")
                out = tile_accumulate(pack.pix, pack.deltas, p_tile=P_TILE)
                again = tile_accumulate(pack.pix, pack.deltas,
                                        p_tile=P_TILE)
                plain = tile_accumulate_plain(pack.pix, pack.deltas,
                                              p_tile=P_TILE)
                torch.cuda.synchronize()
                err = float((out - plain).abs().max())
                err_tile = max(err_tile, err)
                same = bool(torch.equal(out, plain))
                slot_ok = all(torch.equal(tile_accumulate(
                    pack.pix[i:i + 1].contiguous(),
                    pack.deltas[i:i + 1].contiguous(), p_tile=P_TILE)[0],
                    out[i]) for i in range(B_WINDOWS))
                occupied = int(torch.minimum(
                    cnt, torch.tensor(cap, device=cnt.device)).sum())
                print(f"[kernels] tile_accumulate s={st.scale} capacity "
                      f"{cap} {str(dtype)[6:]} B={B_WINDOWS} tiles "
                      f"{pack.pix.shape[1]} occupied slots {occupied}: max "
                      f"abs err {err:.3e}, plain bitwise {same}, rerun "
                      f"bitwise {bool(torch.equal(out, again))}, B=1 == slot "
                      f"bitwise {slot_ok}")
                check(bool(torch.isfinite(out).all()), "non-finite tiles")
                check(same, "tile_accumulate differs from its plain version")
                check(bool(torch.equal(out, again)),
                      "tile_accumulate rerun is not bitwise equal")
                check(slot_ok, "tile_accumulate B=1 differs from its slot")
                packs[(cap, dtype)] = (pack, occupied)

        acc = ops.iwe_accum(first, om_b, cam, st.scale, weights=weights,
                            tile=TILE, capacity=CAPACITY)
        spilled = (cnt - CAPACITY).clamp(min=0).sum(-1)
        n_taps = int(cnt.sum())
        print(f"[kernels] iwe_accum s={st.scale} capacity {CAPACITY}: "
              f"spilled {int(acc.spilled.sum())} of {n_taps} in-range taps "
              f"({acc.spilled.sum().item() / max(n_taps, 1):.3f}); "
              f"zero-spill capacity {zero_cap} (largest tile "
              f"{int(cnt.max())})")
        check(torch.equal(acc.spilled.long(), spilled),
              "spilled differs from the per-tile counts")
        scatter = ref.iwe_accum_ref(first, om_b, cam, st.scale, weights)
        torch.testing.assert_close(acc.channels, scatter, rtol=1e-4,
                                   atol=1e-4)

        ch = acc.channels
        taps = T.gaussian_taps(st.blur_taps, st.blur_sigma,
                               device=ch.device)
        out = blur_stats_streaming(ch, taps)
        again = blur_stats_streaming(ch, taps)
        plain = blur_stats_streaming_plain(ch, taps)
        torch.cuda.synchronize()
        # T_x, T_y, T_z vanish (each derivative image sums to ~0), so the
        # sums are held to each window's largest sum
        rel = float(((out - plain).abs()
                     / plain.abs().amax(-1, keepdim=True)).max())
        err_blur = max(err_blur, float((out - plain).abs().max()))
        v, g = T.stats_to_objective(out, Hs * Ws)
        vp, gp = T.stats_to_objective(plain, Hs * Ws)
        rel_v = float(((v - vp).abs() / vp.abs()).max())
        err_g = float(((g - gp).abs() / gp.abs().max()).max())
        slot_ok = all(torch.equal(blur_stats_streaming(
            ch[i:i + 1], taps)[0], out[i]) for i in range(B_WINDOWS))
        geom = blur_geometry(blur_launch_config(Hs, Ws, st.blur_taps))
        print(f"[kernels] blur_stats_streaming s={st.scale} k={st.blur_taps} "
              f"grid {Hs}x{Ws} B={B_WINDOWS} ({geom}): sums err {rel:.3e} of "
              f"the "
              f"largest, var rel err {rel_v:.3e}, grad err {err_g:.3e}, "
              f"rerun bitwise {bool(torch.equal(out, again))}, B=1 == slot "
              f"bitwise {slot_ok}")
        check(bool(torch.isfinite(out).all()), "non-finite blur stats")
        check(rel <= 1e-3, f"blur sums err {rel} > 1e-3 of the largest")
        check(rel_v <= 1e-4, f"blur variance rel err {rel_v} > 1e-4")
        check(err_g <= 1e-4, f"blur normalized gradient err {err_g} > 1e-4")
        check(bool(torch.equal(out, again)),
              "blur_stats_streaming rerun is not bitwise equal")
        check(slot_ok, "blur_stats_streaming B=1 differs from its slot")
        rows.append(dict(stage=st, weights=weights, zero_cap=zero_cap,
                         packs=packs, channels=ch, taps=taps, geometry=geom,
                         spilled_share=acc.spilled.sum().item()
                         / max(n_taps, 1)))
    return rows, err_tile, err_blur


def time_window_kernels(T, ops, tile_accumulate, tile_accumulate_plain,
                        blur_stats_streaming, blur_stats_streaming_plain,
                        cfg, first, om_b, rows, card):
    """Phase 5 for the per-window engine's two kernels: per-stage rows."""
    cam = cfg.camera
    tile_rows, blur_rows = [], []
    for r in rows:
        st = r["stage"]
        Hs, Ws = st.grid(cam)
        timed = {}
        for (cap, dtype), (pack, occupied) in r["packs"].items():
            kern = cuda_ms(lambda: tile_accumulate(
                pack.pix, pack.deltas, p_tile=P_TILE), reps=20)
            slots = pack.pix.numel()
            n_out = pack.pix.shape[0] * pack.pix.shape[1] * P_TILE
            delta_bytes = 16 if dtype == torch.float32 else 8
            # every slot's pixel id, the deltas of the occupied slots, the
            # tile partials; 4 adds per occupied slot
            nbytes = slots * 4 + occupied * delta_bytes + n_out * 16
            flops = occupied * 4
            timed[(cap, dtype)] = (kern, nbytes, flops, slots, n_out)
        pack, occupied = r["packs"][(CAPACITY, torch.float32)]
        kern, nbytes, flops, slots, n_out = timed[(CAPACITY, torch.float32)]
        plain = cuda_ms(lambda: tile_accumulate_plain(
            pack.pix, pack.deltas, p_tile=P_TILE), reps=5, warmup=1)
        plain_out = tile_accumulate_plain(pack.pix, pack.deltas,
                                          p_tile=P_TILE)
        # one PyTorch call for the same function: index_add_ of the packed
        # deltas (float atomics: not deterministic). An empty slot's deltas
        # are zero, so it adds its zeros to pixel (slot mod P_TILE) of its
        # own tile, spread out rather than piled onto one address.
        dev = pack.pix.device
        slot = torch.arange(pack.pix.shape[2], device=dev) % P_TILE
        idx = torch.where(pack.pix >= 0, pack.pix.long(), slot) \
            + torch.arange(pack.pix.shape[0] * pack.pix.shape[1],
                           device=dev).view(pack.pix.shape[:2] + (1,)) \
            * P_TILE
        idx = idx.reshape(-1)
        flat = pack.deltas.reshape(-1, 4)
        lib_out = torch.zeros((n_out, 4), device=dev).index_add_(0, idx, flat)
        torch.testing.assert_close(lib_out.view_as(plain_out), plain_out,
                                   rtol=1e-4, atol=1e-4)
        lib = cuda_ms(lambda: torch.zeros(
            (n_out, 4), device=dev).index_add_(0, idx, flat), reps=20)
        pro = cuda_ms(lambda: ops.pack_tiles(
            first, om_b, cam, st.scale, r["weights"], tile=TILE,
            capacity=CAPACITY), reps=10, hold=False)
        whole = cuda_ms(lambda: ops.iwe_accum(
            first, om_b, cam, st.scale, weights=r["weights"], tile=TILE,
            capacity=CAPACITY), reps=10, hold=False)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        other = {f"ms_cap{cap}_{str(dt)[6:]}": v[0]
                 for (cap, dt), v in timed.items()}
        row = dict(scale=st.scale, capacity=CAPACITY, ms=kern,
                   plain_ms=plain, library_ms=lib, prologue_ms=pro,
                   iwe_accum_ms=whole, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops, zero_spill_capacity=r[
                       "zero_cap"], spilled_share=r["spilled_share"],
                   **other)
        tile_rows.append(row)
        variants = ", ".join(f"{k[3:]} {v * 1e3:.1f} us"
                             for k, v in other.items())
        print(f"[timing] tile_accumulate s={st.scale} B={B_WINDOWS} "
              f"capacity {CAPACITY}: kernel {kern * 1e3:.1f} us/launch "
              f"({variants}), prologue {pro * 1e3:.1f} us, whole iwe_accum "
              f"{whole * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
              f"index_add_ {lib * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
              f"({row['bound_by']}: {nbytes} B, {flops} flop) = "
              f"{100 * bound / kern:.2f}% of bound reached, on {card}")

        ch, taps, k = r["channels"], r["taps"], st.blur_taps
        one = ch[:1]
        kern = cuda_ms(lambda: blur_stats_streaming(ch, taps), reps=50)
        kern_1 = cuda_ms(lambda: blur_stats_streaming(one, taps), reps=50)
        plain = cuda_ms(lambda: blur_stats_streaming_plain(ch, taps),
                        reps=10, warmup=2)
        P = Hs * Ws
        row = dict(scale=st.scale, k=k, geometry=r["geometry"], ms=kern,
                   plain_ms=plain, library_ms=None, ms_b1=kern_1)
        for B, tag in ((B_WINDOWS, ""), (1, "_b1")):
            nbytes = B * (4 * P * 4 + 32) + k * 4
            flops = B * P * (16 * k + 12)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS * 1e3
            row.update({f"bound_ms{tag}": max(t_bytes, t_ops),
                        f"bound_by{tag}": "bytes" if t_bytes >= t_ops
                        else "operations", f"bytes{tag}": nbytes,
                        f"flops{tag}": flops})
        blur_rows.append(row)
        for B, tag in ((B_WINDOWS, ""), (1, "_b1")):
            t, bound = row[f"ms{tag}"], row[f"bound_ms{tag}"]
            print(f"[timing] blur_stats_streaming s={st.scale} k={k} B={B}: "
                  f"kernel {t * 1e3:.1f} us/launch, bound "
                  f"{bound * 1e3:.2f} us ({row[f'bound_by{tag}']}: "
                  f"{row[f'bytes{tag}']} B, {row[f'flops{tag}']} flop) = "
                  f"{100 * bound / t:.2f}% of bound reached, on {card}")
        print(f"[timing] blur_stats_streaming s={st.scale} k={k} "
              f"B={B_WINDOWS}: plain {plain * 1e3:.1f} us; geometry "
              f"{r['geometry']}")
    return tile_rows, blur_rows


def serve_chain(wl, wins, omega_hint):
    """The workload's own batch-1 chain over one stream's windows (the
    reference of the serving contracts): omega of each window, bitwise."""
    state = np.asarray(omega_hint, np.float32)
    out = []
    for w in wins:
        b = wl.bucket_of(w)
        data, sb, _ = wl.make_batch([w], [state], b, 1)
        res = wl.executable(b, 1)(data, sb)
        _, state, _, _ = wl.harvest(res, False)(0)
        out.append(state)
    return out


def serve_phase(cfg, seqs, counted, dev, card):
    """Phase 5: the serving layer on the card. Returns the launches of each
    kernel in its drain and the printed numbers."""
    from repro_torch.core.pipeline import lockstep_passes
    from repro_torch.data import events
    from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                          AsyncDispatchExecutor,
                                          BatchedEstimationService,
                                          MonotonicClock)
    from repro_torch.serving import CmaxWorkload

    class PassCounting(CmaxWorkload):
        """Adds up the lockstep engine passes of every batch it harvests."""
        passes = 0

        def harvest(self, result, track_gain):
            self.passes += lockstep_passes(result)
            return super().harvest(result, track_gain)

    class OverlapExecutor(AsyncDispatchExecutor):
        """The threaded executor, noting at each submit how many batches
        it was handed have not finished on the device yet."""

        def __init__(self):
            super().__init__()
            self.unfinished, self.peak = [], 0

        def submit(self, *args):
            h = super().submit(*args)
            self.unfinished = [u for u in self.unfinished
                               if not self.done(u)] + [h]
            self.peak = max(self.peak, len(self.unfinished))
            return h

    policy = events.pow2_policy(min_bucket=16384)
    lo, hi = SERVE_EVENTS
    check(policy.classes(lo, hi) == (32768, 65536),
          f"classes {policy.classes(lo, hi)}")
    streams = {}
    for s, (wins, om_true, _) in enumerate(seqs):
        lens = events.ragged_lengths(WINDOWS_PER_STREAM, lo, hi, seed=s)
        streams[f"s{s}"] = (events.ragged_from_sequence(wins, lens),
                            om_true.cpu().numpy())
    n_win = sum(len(w) for w, _ in streams.values())

    def submit_all(svc):
        for sid, (wins, om_true) in streams.items():
            for k, w in enumerate(wins):
                svc.submit(sid, w, omega_hint=om_true[0] if k == 0 else None)

    def drain(svc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = svc.drain()
        torch.cuda.synchronize()
        return rs, time.perf_counter() - t0

    wl = PassCounting(cfg, policy=policy, device=dev)
    ex = OverlapExecutor()
    svc = AsyncBatchedEstimationService(workload=wl, max_batch=8,
                                        max_in_flight=2,
                                        clock=MonotonicClock(), executor=ex)
    submit_all(svc)
    for fn in counted:
        fn.launches = 0
    rs, wall = drain(svc)
    launches = {fn.__name__: fn.launches for fn in counted}
    served_passes = wl.passes
    ex.close()
    check(len(rs) == n_win and all(r.status == "ok" for r in rs),
          f"{len(rs)} responses, statuses {sorted({r.status for r in rs})}")
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, (wins, om_true) in streams.items():
        for k, om in enumerate(serve_chain(wl, wins, om_true[0])):
            check(np.array_equal(by[(sid, k)].omega, om),
                  f"served omega of {sid}/{k} differs from its batch-1 "
                  f"chain: {by[(sid, k)].omega} vs {om}")
    est = np.stack([[by[(sid, k)].omega for k in range(WINDOWS_PER_STREAM)]
                    for sid in streams])
    truth = np.stack([om_true for _, om_true in streams.values()])
    err = rmse(est, truth)
    lats = sorted(r.latency for r in rs)
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(0.99 * len(lats)))]
    lengths = [w.n for wins, _ in streams.values() for w in wins]
    print(f"[serve] async: {n_win} windows ({STREAMS} streams x "
          f"{WINDOWS_PER_STREAM}, {min(lengths)}-{max(lengths)} events, "
          f"all submitted at once), {cfg.camera.width}x{cfg.camera.height}, "
          f"engine {cfg.engine}, classes "
          f"{policy.classes(lo, hi)}: {wall:.3f} s, {n_win / wall:.2f} "
          f"windows/s; latency p50 {1e3 * p50:.1f} ms, p99 {1e3 * p99:.1f} "
          f"ms; batches {svc.stats['batches']}, compiles (classes built) "
          f"{svc.stats['compiles']}, padded_slot_frac "
          f"{svc.padded_slot_frac:.3f}; most batches unfinished at a submit "
          f"{ex.peak}; on {card}")
    print(f"[serve] async: RMSE vs omega_true {err:.4f} rad/s; every omega "
          f"bitwise equal to its batch-1 chain; launches {launches}, "
          f"lockstep passes of the served batches {served_passes}")
    check(err < 0.5, f"served RMSE vs omega_true {err} >= 0.5 rad/s")
    check(launches["megakernel_stats"] == served_passes > 0,
          f"megakernel launches {launches['megakernel_stats']} != served "
          f"passes {served_passes}")
    check(launches["tile_accumulate"] == launches["blur_stats_streaming"]
          == 0, "the cuda_batched drain launched a per-window kernel")
    check(ex.peak >= 2, f"at most {ex.peak} batch unfinished at a submit: "
          "the executor did not overlap")

    sync = BatchedEstimationService(workload=wl, max_batch=8)
    submit_all(sync)
    wl.passes = 0
    rs_sync, wall_sync = drain(sync)
    sync_passes = wl.passes
    for r in rs_sync:
        check(np.array_equal(r.omega, by[(r.stream_id, r.seq)].omega),
              f"sync service omega of {r.stream_id}/{r.seq} differs")
    print(f"[serve] sync: {n_win} windows in {wall_sync:.3f} s, "
          f"{n_win / wall_sync:.2f} windows/s, batches "
          f"{sync.stats['batches']}, lockstep passes {sync_passes}; every "
          f"omega bitwise equal to the async service's; on {card}")
    print(f"[serve] ms per lockstep pass: async {1e3 * wall / served_passes:.3f}"
          f", sync {1e3 * wall_sync / sync_passes:.3f}")

    wcfg = dataclasses.replace(cfg, engine="cuda", engine_capacity=CAPACITY)
    wwl = PassCounting(wcfg, policy=policy, device=dev)
    wsvc = AsyncBatchedEstimationService(workload=wwl, max_batch=8,
                                         max_in_flight=2)
    few = {sid: (wins[:2], om_true) for sid, (wins, om_true)
           in list(streams.items())[:2]}
    for sid, (wins, om_true) in few.items():
        for k, w in enumerate(wins):
            wsvc.submit(sid, w, omega_hint=om_true[0] if k == 0 else None)
    for fn in counted:
        fn.launches = 0
    wrs, wwall = drain(wsvc)
    wlaunches = {fn.__name__: fn.launches for fn in counted}
    wpasses = wwl.passes
    wsvc.executor.close()
    check(len(wrs) == 4 and all(r.status == "ok" for r in wrs),
          "the cuda-engine drain did not serve every window")
    wby = {(r.stream_id, r.seq): r for r in wrs}
    for sid, (wins, om_true) in few.items():
        for k, om in enumerate(serve_chain(wwl, wins, om_true[0])):
            check(np.array_equal(wby[(sid, k)].omega, om),
                  f"cuda-engine omega of {sid}/{k} differs from its chain")
    print(f"[serve] engine cuda: 4 windows (2 streams x 2) in {wwall:.3f} s, "
          f"{4 / wwall:.2f} windows/s, batches {wsvc.stats['batches']}; "
          f"launches {wlaunches}, lockstep passes {wpasses}; every omega "
          f"bitwise equal to its batch-1 chain; on {card}")
    check(wlaunches["tile_accumulate"] == wlaunches["blur_stats_streaming"]
          == wpasses > 0, f"cuda-engine launches {wlaunches} != passes "
          f"{wpasses}")
    check(wlaunches["megakernel_stats"] == 0,
          "the cuda drain launched the batched kernel")
    return dict(
        launches={"megakernel_stats": launches["megakernel_stats"],
                  "tile_accumulate": wlaunches["tile_accumulate"],
                  "blur_stats_streaming": wlaunches["blur_stats_streaming"]},
        windows_per_s=n_win / wall, sync_windows_per_s=n_win / wall_sync,
        passes=served_passes, sync_passes=sync_passes,
        p50_ms=1e3 * p50, p99_ms=1e3 * p99, batches=svc.stats["batches"],
        compiles=svc.stats["compiles"],
        padded_slot_frac=svc.padded_slot_frac, peak_unfinished=ex.peak,
        rmse=err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import repro_torch.core as T
    from repro_torch.configs import cmax_camel
    from repro_torch.core.pipeline import (lockstep_passes,
                                           lockstep_stage_passes)
    from repro_torch.data import events
    from repro_torch.kernels import (_build, blur_stats_streaming,
                                     blur_stats_streaming_plain, megakernel,
                                     ops, tile_accumulate,
                                     tile_accumulate_plain)
    from repro_torch.kernels import ref as kernel_ref
    from repro_torch.kernels.blur_stats import launch_config as blur_launch
    counted = (megakernel.megakernel_stats, tile_accumulate,
               blur_stats_streaming)

    # ---- 1. device ----
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    card = card_line()
    print(f"[device] {name} capability {cap[0]}.{cap[1]} "
          f"count {torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {card}")
    check(cap == (9, 0), f"capability {cap} is not 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] nvcc for sm_90a: {time.perf_counter() - t0:.1f} s")
    cfg = cmax_camel.CONFIG
    cam = cfg.camera
    for kname, log in _build.BUILD_LOG.items():
        if kname == "blur_stats":
            continue
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {kname}: {line.strip()}")
    # the blur kernel is built for every odd k: its report is printed once
    # for each k the stages launch
    blur_entries = ptxas_entries(_build.BUILD_LOG.get("blur_stats", ""))
    for st in cfg.stages:
        tag = f"blur_stats_kernelILi{st.blur_taps}EE"
        for entry, lines in blur_entries.items():
            if tag in entry:
                print(f"[build] blur_stats: blur_stats_kernel<{st.blur_taps}>"
                      f" (s={st.scale}): {'; '.join(lines)}")

    check(cfg.engine == "cuda_batched", "CONFIG does not use cuda_batched")
    specs = [dataclasses.replace(events.POSTER, n_windows=WINDOWS_PER_STREAM,
                                 events_per_window=N_EVENTS,
                                 n_features=N_FEATURES, jerk_prob=0.0,
                                 seed=events.POSTER.seed + s)
             for s in range(STREAMS)]
    seqs = [events.make_sequence(sp, device=dev) for sp in specs]
    streams = T.EventWindow(*[torch.stack([getattr(q[0], f) for q in seqs])
                              for f in ("x", "y", "t", "p", "valid")])
    om_true = torch.stack([q[1] for q in seqs])          # (S, K, 3)
    om_init = torch.stack([q[2][0] for q in seqs])       # (S, 3) IMU start
    first = streams.map(lambda a: a[:B_WINDOWS, 0].contiguous())
    om_b = om_init[:B_WINDOWS].contiguous()

    # ---- 2. kernels against their plain versions on the card ----
    stage_inputs = []
    max_abs_err = 0.0
    for st in cfg.stages:
        Hs, Ws = st.grid(cam)
        weights = T.sort_events(first, om_b, cam, st).weights
        bins = ops.bin_taps(first, om_b, weights, cam, st.scale)
        fir = T.gaussian_taps(st.blur_taps, st.blur_sigma, device=dev)
        kw = dict(H=Hs, W=Ws, rb=cfg.engine_rb, scale=st.scale, fx=cam.fx,
                  fy=cam.fy, cx=cam.cx, cy=cam.cy)
        out = megakernel.megakernel_stats(*bins, om_b, fir, **kw)
        again = megakernel.megakernel_stats(*bins, om_b, fir, **kw)
        plain = megakernel.megakernel_stats_plain(*bins, om_b, fir, **kw)
        torch.cuda.synchronize()
        v, g = T.stats_to_objective(out, Hs * Ws)
        vp, gp = T.stats_to_objective(plain, Hs * Ws)
        rel_v = float(((v - vp).abs() / vp.abs()).max())
        gs = float(gp.abs().max())
        err_g = float(((g - gp).abs() / gs).max())
        err = float((out - plain).abs().max())
        max_abs_err = max(max_abs_err, err)
        slot_ok = True
        for i in range(B_WINDOWS):
            one = ops.batched_engine_stats(
                first.map(lambda a: a[i:i + 1]), om_b[i:i + 1], cam,
                st.scale, st.blur_taps, st.blur_sigma,
                weights=weights[i:i + 1], rb=cfg.engine_rb, fir=fir)
            slot_ok &= bool(torch.equal(one[0], out[i]))
        live = int(bins.pix_off[:, -1].sum())
        print(f"[kernels] s={st.scale} k={st.blur_taps} grid {Hs}x{Ws} "
              f"B={B_WINDOWS} N={N_EVENTS} live taps {live}: var rel err "
              f"{rel_v:.3e}, grad err {err_g:.3e}, stats max abs err "
              f"{err:.3e}, rerun bitwise {bool(torch.equal(out, again))}, "
              f"B=1 == slot bitwise {slot_ok}")
        check(bool(torch.isfinite(out).all()), "non-finite kernel stats")
        check(rel_v <= 1e-4, f"variance rel err {rel_v} > 1e-4")
        check(err_g <= 1e-4, f"normalized gradient err {err_g} > 1e-4")
        check(bool(torch.equal(out, again)), "rerun is not bitwise equal")
        check(slot_ok, "B=1 result differs from its slot in B=8")
        stage_inputs.append((st, bins, fir, kw, live))
    window_rows, err_tile, err_blur = check_window_kernels(
        T, ops, kernel_ref, tile_accumulate, tile_accumulate_plain,
        blur_stats_streaming, blur_stats_streaming_plain, blur_launch, cfg,
        first, om_b)

    # ---- 3. the main path ----
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oms, res = T.estimate_streams(streams, om_init, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = megakernel.megakernel_stats.launches
    check(tile_accumulate.launches == blur_stats_streaming.launches == 0,
          "the cuda_batched path launched a per-window kernel")
    passes = lockstep_passes(res)
    main_stage_passes = lockstep_stage_passes(res)
    n_win = STREAMS * WINDOWS_PER_STREAM
    check(tuple(oms.shape) == (STREAMS, WINDOWS_PER_STREAM, 3),
          f"omega shape {tuple(oms.shape)}")
    check(bool(torch.isfinite(oms).all()), "non-finite estimates")
    err_true = rmse(oms.cpu().numpy(), om_true.cpu().numpy())
    iters = [st.iters.float().mean().item() for st in res.stages]
    print(f"[main] estimate_streams {STREAMS} streams x {WINDOWS_PER_STREAM} "
          f"windows, {N_EVENTS} events, 240x180, engine cuda_batched: "
          f"{wall:.3f} s, {n_win / wall:.2f} windows/s on {card}")
    print(f"[main] RMSE vs omega_true {err_true:.4f} rad/s; mean "
          f"iterations per stage "
          f"{[round(i, 2) for i in iters]}; lockstep passes {passes}, "
          f"kernel launches {launches}; lockstep passes per stage "
          f"{main_stage_passes} (from the stage traces)")
    check(launches > 0, "the main path launched no kernel")
    check(sum(main_stage_passes) == launches,
          f"per-stage passes {main_stage_passes} do not add up to the "
          f"launches {launches}")
    check(launches == passes,
          f"kernel launches {launches} != lockstep passes {passes}")
    # the tracking bar of tests/test_adaptive_pipeline.py
    check(err_true < 0.5, f"RMSE vs omega_true {err_true} >= 0.5 rad/s")

    ref_cfg = dataclasses.replace(cfg, engine="reference")
    ref = T.estimate_batch(streams.map(lambda a: a[:, 0]), om_init, ref_cfg)
    d_om = float((ref.omega - oms[:, 0]).abs().max())
    worst_v = 0.0
    for st_r, st_k in zip(ref.stages, res.stages):
        vk = st_k.v_final[:, 0]
        worst_v = max(worst_v, float(((vk - st_r.v_final).abs()
                                      / st_r.v_final.abs()).max()))
        diff = torch.nonzero(st_r.iters != st_k.iters[:, 0]).flatten()
        for s in diff.tolist():
            print(f"[main] stream {s}: iterations differ from the reference "
                  f"engine ({int(st_k.iters[s, 0])} vs {int(st_r.iters[s])})")
    print(f"[main] first window of each stream vs reference engine: omega "
          f"max abs diff {d_om:.3e}, v_final max rel diff {worst_v:.3e}")
    # how far rounding alone moves the estimate: the reference engine again,
    # with the warm start moved by one part in 1e7 (not a pass/fail bar)
    ref_p = T.estimate_batch(streams.map(lambda a: a[:, 0]),
                             om_init * (1 + 1e-7), ref_cfg)
    print(f"[main] reference engine, warm start perturbed by 1e-7 "
          f"(relative): omega moves by "
          f"{float((ref_p.omega - ref.omega).abs().max()):.3e}")
    check(d_om <= 5e-4, f"omega differs from reference by {d_om}")
    check(worst_v <= 1e-3, f"v_final differs from reference by {worst_v}")

    # ---- 4. the per-window path ----
    wcfg = dataclasses.replace(cfg, engine="cuda", engine_capacity=CAPACITY)
    one_stream = streams.map(lambda a: a[0])
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oms_seq, res_seq = T.estimate_sequence(one_stream, om_init[0], wcfg)
    torch.cuda.synchronize()
    wall_seq = time.perf_counter() - t0
    seq_launches = (tile_accumulate.launches, blur_stats_streaming.launches)
    seq_passes = sum(int(st.passes.sum()) for st in res_seq.stages)
    check(megakernel.megakernel_stats.launches == 0,
          "the cuda path launched the batched kernel")
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_w = T.estimate_batch(first, om_b, wcfg)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    b_launches = (tile_accumulate.launches, blur_stats_streaming.launches)
    b_passes = lockstep_passes(res_w)
    window_launches = [a + b for a, b in zip(seq_launches, b_launches)]
    # a sequence of single windows takes each window's passes
    window_stage_passes = [
        int(st.passes.sum()) + n for st, n in zip(
            res_seq.stages, lockstep_stage_passes(res_w))]
    err_seq = rmse(oms_seq.cpu().numpy(), om_true[0].cpu().numpy())
    err_b = rmse(res_w.omega.cpu().numpy(), om_true[:B_WINDOWS, 0].cpu()
                 .numpy())
    print(f"[window] estimate_sequence 1 stream x {WINDOWS_PER_STREAM} "
          f"windows, {N_EVENTS} events, 240x180, engine cuda, capacity "
          f"{CAPACITY}: {wall_seq:.3f} s, "
          f"{WINDOWS_PER_STREAM / wall_seq:.2f} windows/s on {card}; "
          f"passes {seq_passes}, launches (tile_accumulate, "
          f"blur_stats_streaming) {seq_launches}; RMSE vs omega_true "
          f"{err_seq:.4f} rad/s")
    print(f"[window] estimate_batch {B_WINDOWS} windows, engine cuda: "
          f"{wall_b:.3f} s, {B_WINDOWS / wall_b:.2f} windows/s on {card}; "
          f"lockstep passes {b_passes}, launches {b_launches}; RMSE vs "
          f"omega_true {err_b:.4f} rad/s; mean iterations per stage "
          f"{[round(t.iters.float().mean().item(), 2) for t in res_w.stages]}")
    print(f"[window] passes per stage, sequence + batch: "
          f"{window_stage_passes} (from the stage traces; launches of each "
          f"per-window kernel {window_launches[0]})")
    check(all(sum(window_stage_passes) == n for n in window_launches),
          f"per-stage passes {window_stage_passes} do not add up to the "
          f"launches {window_launches}")
    check(seq_launches == (seq_passes, seq_passes),
          f"estimate_sequence launches {seq_launches} != passes {seq_passes}")
    check(b_launches == (b_passes, b_passes),
          f"estimate_batch launches {b_launches} != passes {b_passes}")
    check(megakernel.megakernel_stats.launches == 0,
          "the cuda path launched the batched kernel")
    check(bool(torch.isfinite(oms_seq).all())
          and bool(torch.isfinite(res_w.omega).all()), "non-finite omega")
    check(err_seq < 0.5 and err_b < 0.5,
          f"RMSE vs omega_true {err_seq}, {err_b} >= 0.5 rad/s")
    # first windows against the reference engine (stream s, window 0)
    ref_om = ref.omega[:B_WINDOWS]
    d_om_w = max(float((res_w.omega - ref_om).abs().max()),
                 float((oms_seq[0] - ref_om[0]).abs().max()))
    worst_v_w = 0.0
    for st_r, st_b, st_s in zip(ref.stages, res_w.stages, res_seq.stages):
        vr_b = st_r.v_final[:B_WINDOWS]
        for vk, vr in ((st_b.v_final, vr_b), (st_s.v_final[0], vr_b[0])):
            worst_v_w = max(worst_v_w,
                            float(((vk - vr).abs() / vr.abs()).max()))
        diff = st_r.iters[:B_WINDOWS] != st_b.iters
        for s_ in torch.nonzero(diff).flatten().tolist():
            print(f"[window] stream {s_}: iterations differ from the "
                  f"reference engine ({int(st_b.iters[s_])} vs "
                  f"{int(st_r.iters[s_])})")
    print(f"[window] first windows vs reference engine: omega max abs diff "
          f"{d_om_w:.3e}, v_final max rel diff {worst_v_w:.3e}")
    check(d_om_w <= 5e-4, f"cuda omega differs from reference by {d_om_w}")
    check(worst_v_w <= 1e-3,
          f"cuda v_final differs from reference by {worst_v_w}")

    # ---- 5. serving ----
    served = serve_phase(cfg, seqs, counted, dev, card)

    # ---- 6. timing ----
    per_stage = []
    for st, bins, fir, kw, live in stage_inputs:
        P = kw["H"] * kw["W"]
        k = st.blur_taps
        kern = cuda_ms(lambda: megakernel.megakernel_stats(*bins, om_b, fir,
                                                            **kw), reps=50)
        plain = cuda_ms(lambda: megakernel.megakernel_stats_plain(
            *bins, om_b, fir, **kw), reps=5, warmup=1)
        weights = T.sort_events(first, om_b, cam, st).weights
        pro = cuda_ms(lambda: ops.bin_taps(first, om_b, weights, cam,
                                           st.scale), reps=20, hold=False)
        # bytes the function needs: x, y, dt, pw of the events with live
        # taps, each live record, the CSR offsets, omega, taps, the output.
        # The kernel also reads each live record's sorted key, which the
        # function does not need (the offsets give each record's pixel):
        # that is the kernel's own traffic, printed apart, not in the bound
        nbytes = (live // 4) * 16 + live * 4 + B_WINDOWS * (P + 1) * 4 \
            + B_WINDOWS * 12 + k * 4 + B_WINDOWS * 32
        key_bytes = live * 4
        flops = live * TAP_FLOPS + B_WINDOWS * P * (16 * k + 12)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        row = dict(scale=st.scale, k=k, ms=kern, plain_ms=plain,
                   prologue_ms=pro, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops, key_bytes=key_bytes)
        per_stage.append(row)
        print(f"[timing] s={st.scale} k={k} B={B_WINDOWS}: kernel "
              f"{kern * 1e3:.1f} us/pass, prologue {pro * 1e3:.1f} us/pass, "
              f"plain {plain * 1e3:.1f} us/pass, bound {bound * 1e3:.2f} us "
              f"({row['bound_by']}: {nbytes} B, {flops} flop) = "
              f"{100 * bound / kern:.2f}% of bound reached; the kernel also "
              f"reads {key_bytes} B of sorted keys "
              f"({key_bytes / HBM_BYTES_PER_S * 1e6:.2f} us), on {card}")

    tile_rows, blur_rows = time_window_kernels(
        T, ops, tile_accumulate, tile_accumulate_plain, blur_stats_streaming,
        blur_stats_streaming_plain, cfg, first, om_b, window_rows, card)

    at = f"s=1 stage, B={B_WINDOWS}, N={N_EVENTS}"
    full, tile_full, blur_full = per_stage[-1], tile_rows[-1], blur_rows[-1]
    kernels = [dict(
        name="megakernel_stats", route="cuda",
        source="src/repro_torch/kernels/csrc/megakernel.cu",
        replaces="src/repro/kernels/megakernel.py:184",
        launches=launches, passes_per_stage=main_stage_passes,
        max_abs_err=max_abs_err, ms=full["ms"],
        plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
        bound_by=full["bound_by"], library_ms=None, at=at,
        per_stage=per_stage), dict(
        name="tile_accumulate", route="cuda",
        source="src/repro_torch/kernels/csrc/iwe_accum.cu",
        replaces="src/repro/kernels/iwe_accum.py:54",
        launches=window_launches[0],
        passes_per_stage=window_stage_passes, max_abs_err=err_tile,
        ms=tile_full["ms"], plain_ms=tile_full["plain_ms"],
        bound_ms=tile_full["bound_ms"], bound_by=tile_full["bound_by"],
        library_ms=tile_full["library_ms"],
        at=f"{at}, capacity {CAPACITY}, f32", per_stage=tile_rows), dict(
        name="blur_stats_streaming", route="cuda",
        source="src/repro_torch/kernels/csrc/blur_stats.cu",
        replaces="src/repro/kernels/blur_stats.py:93",
        launches=window_launches[1],
        passes_per_stage=window_stage_passes, max_abs_err=err_blur,
        ms=blur_full["ms"], plain_ms=blur_full["plain_ms"],
        bound_ms=blur_full["bound_ms"], bound_by=blur_full["bound_by"],
        library_ms=None, at=f"{at}, {blur_full['geometry']}",
        per_stage=blur_rows)]
    for kern in kernels:
        kern["serve_launches"] = served["launches"][kern["name"]]
    for kern in kernels:
        check(kern["launches"] > 0,
              f"{kern['name']} was launched no time on its path")
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
