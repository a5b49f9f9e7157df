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
  6. energy     `locality_stats` (Table 2 ratios, Table 3 pending merge) of
                every window of 3 at every stage, under its traced entry
                and exit omega: the pending hits equal a host loop of the
                reference's forward fill, the reference's invariants hold,
                and the counts equal the CPU's wherever both devices warp
                every event to the same pixel; the mean ratios per stage and
                the cost model's modelled FPGA reductions are printed;
  7. grid       `estimate_batch_sharded` (the 8 windows of 2) and
                `estimate_streams_sharded` (the streams of 3) on a grid of
                one entry and of two data-parallel entries that both name
                cuda:0: bitwise equal to the local paths, megakernel
                launches equal to the shards' lockstep passes;
  8. serve-grid the [serve] harness at 2 streams x 4 windows under
                `CmaxWorkload(mesh=two entries on cuda:0)`, async and sync:
                every omega bitwise equal to the batch-1 chain, even batch
                classes;
  9. examples   examples/torch_quickstart.py and torch_serve_batch.py at
                their default sizes: RMSE vs ground truth < 0.5 rad/s;
 10. timing     each kernel's time per launch (CUDA events; the blur kernel
                at B=8 and at B=1, the estimate_sequence path), its prologue's,
                its plain version's and, where one PyTorch call computes the
                same function, that call's, against the bound set by the
                bytes and operations the function needs;
 11. lm         the LM decode-serving path, which runs none of the kernels
                above (their launch counts must stay 0): llama3.2-1b's
                published config (bf16, 16 layers, d_model 2048, vocab
                128,256, random weights from a seeded generator on the card)
                served by LMDecodeWorkload — 4 streams x 3 chunks of 8-48
                tokens, chunk_policy(min_bucket=16), max_len 256, max_batch 4
                — through the async service (threaded executor) and the
                sync one: every served token sequence and every stream's
                final KV cache bitwise equal to the workload's batch-1
                chain, async == sync, and one batch's logits bitwise equal
                on the caller's stream and on a worker stream. Tokens/s, ms
                per decode step, batches, padding and peak memory are
                printed, and one decode step's pace, its device time under
                `torch.profiler` (idle share, launches, the costliest
                kernels). Then an f32 copy of the config: 8 decode steps
                reproduce `forward`'s logits (rtol 2e-2, atol 2e-3, the
                reference's bar, greedy tokens equal); and each of the ten
                SMOKE configs, built from one seed on the CPU and copied to
                the card, decodes 8 tokens within that bar of the CPU;
 12. train      single-card LM training, which runs none of the CMAX
                kernels either (their launch counts must stay 0):
                llama3.2-1b's published config (bf16, from a seeded
                generator on the card) trained through `train.loop.train`
                for 6 steps (AdamW with f32 moments, remat "full", seq 1024,
                global batch 8 in 2 microbatches, `data/lm.py::batches`
                seed 0, no checkpoint): every loss finite, every parameter
                changed, the optimizer at step 6. Ms per step (median of
                steps 2-6), tokens/s, model FLOPs and their share of 989
                TFLOP/s bf16, peak memory, and one more step's device time
                and idle share under `torch.profiler`. Then the bf16 loss
                and unembedding gradient against an f32 copy's on one batch
                (rtol 2e-2; the gradient as a relative L2 norm); each SMOKE
                config's train step on the card against the CPU (rtol 5e-4,
                atol 5e-5); examples/torch_fault_tolerant_train.py on the
                card (2 restarts, last checkpoint restored bitwise) and
                `python -m repro_torch.launch.train --arch llama3.2-1b
                --smoke --steps 8`, in a checkpoint directory emptied
                before the phase and after it. The LM helpers of 11 and 12
                run the served and checked models under
                `torch.inference_mode()`;
 13. train-dist multi-device training on an NCCL world of one rank (a TCP
                rendezvous on 127.0.0.1, destroyed after the phase), no
                CMAX kernel: llama3.2-1b trained as in 12 through
                `train.loop.train` on a (1, 1) ("data", "model") grid with
                FSDP, DTensor parameters and optimizer state: each loss
                within rtol 5e-4 of 12's (bitwise or not, printed), ms per
                step beside 12's, peak memory, one step's idle share under
                `torch.profiler` and its collectives (`StepCommMode`). One
                MoE layer of deepseek-moe-16b's published config (0.57 B
                parameters) forward and backward on 8 x 1024 tokens
                through `moe_apply_ep` against the dense `moe_apply`, in
                bf16 (bar 0.05) and f32 (bar 2e-4). The elastic round trip
                at llama3.2-1b's SMOKE size in bf16: the grid's step-3
                checkpoint restored onto one card and onto the grid
                bitwise, back again bitwise, and the single-card loop
                resumed from it within rtol 5e-4 of the grid's losses
                (checkpoints under build/train_dist, emptied before and
                after). With two cards, `launch.train` under torchrun on
                2 ranks; with one, a line saying why the multi-rank
                arithmetic rests on the CPU tests.
 14. recurrent  the recurrent sequence forms at full width in 13's world
                and on its (1, 1) grid, no CMAX kernel: xlstm-1.3b's
                published config (48 mLSTM / sLSTM layers, d_model 2048,
                4 heads, vocab 50,304, bf16, seeded) trained through
                `train.loop.train` on the card (AdamW, remat "full", seq
                256 — train_4k's 4,096 cut for sLSTM's loop over time —
                global batch 8 in 2 microbatches, 3 steps, no checkpoint),
                then on the grid with FSDP: each grid loss within rtol
                5e-4 of the card's; ms per step of both, peak memory, one
                card step's idle share and launches under the profiler.
                recurrentgemma-9b's published config (38 layers, d_model
                4096, bf16, ~18 GB) prefilled through `make_prefill_step`
                at 1 x 2,048 tokens plainly and on the grid: logits within
                rtol 5e-4 / atol 5e-5, greedy next tokens equal; ms of each.
 15. roofline   `roofline.HW().hbm_per_chip` within 2% of the card's
                `total_memory`; the dry run (`launch.dryrun`, a fake
                (1, 1) mesh, fake tensors, in a CPU subprocess) of 12's
                cell: its flops within 25% of 12's model flops with
                remat's re-forward, its args + temp within 0.5-2x of 12's
                peak memory, its roofline bound and `mfu_upper` against
                12's ms per step; the decode roofline at 11's size beside
                11's step; 10's share of each kernel's bound (through
                `roofline.kernel_roofline`) equal to a recount from its
                printed bytes and flops; the dry-run CLI
                on llama3.2-1b x train_4k x the 16x16 mesh and the report
                over it (both exit 0, the cell "ok"). No CMAX kernel.

The second-to-last line is the `kernels` JSON object and the last line is
{"ok": true, "device": {...}}. Any failed phase raises and the script exits
non-zero without that line. It needs no network, imports no JAX, and exits
non-zero without a CUDA card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

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


def kernel_bound_ms(flops: float, nbytes: float):
    """(bound in ms, "bytes" or "operations") of a CMAX kernel's work:
    `roofline.kernel_roofline` on the card's HBM rate and its float32 peak
    (these kernels run outside the tensor cores). The bound is flops over
    the roofline's rate, i.e. the larger of bytes / rate and flops /
    peak."""
    from repro_torch import roofline as roof
    hw = dataclasses.replace(roof.default_hw(), peak_flops=roof.F32_FLOPS)
    r = roof.kernel_roofline(flops, nbytes, hw=hw)
    by = ("bytes" if r["arithmetic_intensity"] <= r["ridge_point"]
          else "operations")
    return flops / r["roofline_flops"] * 1e3, by


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
    from repro_torch import roofline as roof
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
            costs = roof.cuda_tile_costs(
                slots, occupied, n_out,
                delta_bytes=16 if dtype == torch.float32 else 8)
            timed[(cap, dtype)] = (kern, int(costs["hbm_bytes"]),
                                   int(costs["flops"]), slots, n_out)
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
        bound, bound_by = kernel_bound_ms(flops, nbytes)
        other = {f"ms_cap{cap}_{str(dt)[6:]}": v[0]
                 for (cap, dt), v in timed.items()}
        row = dict(scale=st.scale, capacity=CAPACITY, ms=kern,
                   plain_ms=plain, library_ms=lib, prologue_ms=pro,
                   iwe_accum_ms=whole, bound_ms=bound, bound_by=bound_by,
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
            costs = roof.cuda_blur_costs(B, P, k)
            bound, bound_by = kernel_bound_ms(costs["flops"],
                                              costs["hbm_bytes"])
            row.update({f"bound_ms{tag}": bound, f"bound_by{tag}": bound_by,
                        f"bytes{tag}": int(costs["hbm_bytes"]),
                        f"flops{tag}": int(costs["flops"])})
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


def shard_passes(result, n: int) -> int:
    """Lockstep engine passes of a result whose leading axis ran as `n`
    equal shards, each in lockstep on its own."""
    from repro_torch.core.pipeline import lockstep_passes, map_result
    m = result.omega.shape[0] // n
    return sum(lockstep_passes(map_result(lambda a: a[i * m:(i + 1) * m],
                                          result)) for i in range(n))


def pass_counting(**kw):
    """A CmaxWorkload that adds up the lockstep engine passes of every
    batch it harvests (of each shard, under a grid)."""
    from repro_torch.core.distributed import _dp_extent
    from repro_torch.serving import CmaxWorkload

    class PassCounting(CmaxWorkload):
        passes = 0

        def harvest(self, result, track_gain):
            n = 1 if self.mesh is None else _dp_extent(self.mesh)
            self.passes += shard_passes(result, n)
            return super().harvest(result, track_gain)

    return PassCounting(**kw)


def serve_streams(seqs, n_streams):
    """{stream id: (ragged windows, omega_true)}: the POSTER windows of the
    first `n_streams` sequences, each cut by `ragged_lengths`."""
    from repro_torch.data import events
    lo, hi = SERVE_EVENTS
    streams = {}
    for s, (wins, om_true, _) in enumerate(seqs[:n_streams]):
        lens = events.ragged_lengths(WINDOWS_PER_STREAM, lo, hi, seed=s)
        streams[f"s{s}"] = (events.ragged_from_sequence(wins, lens),
                            om_true.cpu().numpy())
    return streams


def submit_all(svc, streams):
    for sid, (wins, om_true) in streams.items():
        for k, w in enumerate(wins):
            svc.submit(sid, w, omega_hint=om_true[0] if k == 0 else None)


def timed_drain(svc):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = svc.drain()
    torch.cuda.synchronize()
    return rs, time.perf_counter() - t0


LM_ARCH = "llama3.2-1b"
LM_STREAMS, LM_CHUNKS, LM_TOKENS = 4, 3, (8, 48)
LM_MIN_BUCKET, LM_MAX_LEN, LM_MAX_BATCH = 16, 256, 4
LM_RTOL, LM_ATOL = 2e-2, 2e-3    # tests/test_arch_smoke.py decode vs forward


@torch.inference_mode()
def lm_chain(wl, chunks):
    """The LM workload's own batch-1 chain over one stream's chunks:
    (tokens of each chunk, the final carried state)."""
    state = wl.default_state()
    out = []
    for c in chunks:
        b = wl.bucket_of(c)
        data, sb, _ = wl.make_batch([c], [state], b, 1)
        res = wl.executable(b, 1)(data, sb)
        toks, state, _, _ = wl.harvest(res, False)(0)
        out.append(toks)
    return out, state


def same_cache(a, b) -> bool:
    """Two carried LM states hold the same positions and the same bits."""
    for x, y in zip(a["cache"]["layers"], b["cache"]["layers"]):
        if x.keys() != y.keys():
            return False
        for k in x:
            if isinstance(x[k], torch.Tensor):
                if not torch.equal(x[k], y[k]):
                    return False
            elif x[k] != y[k]:
                return False
    return True


def lm_drain(svc, streams):
    """Submit every chunk, drain, wait for the device: (responses, s)."""
    for sid, chunks in streams.items():
        for c in chunks:
            svc.submit(sid, c)
    return timed_drain(svc)


def lm_serve_phase(cfg, counted, dev, card) -> dict:
    """Phase 11, serving: `cfg` served by LMDecodeWorkload on `dev`
    through the async and the sync service, each held bitwise to the
    batch-1 chain; one batch's logits on the caller's stream and on a
    worker stream. No CMAX kernel may launch."""
    from repro_torch.data import lm as lm_data
    from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                          AsyncDispatchExecutor,
                                          BatchedEstimationService)
    from repro_torch.models import transformer as tt
    from repro_torch.serving import LMDecodeWorkload

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {n_params} parameters built on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    policy = lm_data.chunk_policy(min_bucket=LM_MIN_BUCKET)
    wl = LMDecodeWorkload(cfg, params=model, policy=policy,
                          max_len=LM_MAX_LEN, device=dev)
    dcfg = lm_data.LMDataConfig(vocab_size=cfg.vocab_size,
                                seq_len=LM_TOKENS[1], global_batch=1, seed=0)
    streams = lm_data.token_streams(dcfg, LM_STREAMS, LM_CHUNKS, *LM_TOKENS)
    n_tok = sum(c.n for cs in streams.values() for c in cs)
    n_chunks = LM_STREAMS * LM_CHUNKS

    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    ex = AsyncDispatchExecutor()
    svc = AsyncBatchedEstimationService(workload=wl, max_batch=LM_MAX_BATCH,
                                        executor=ex)
    try:
        rs_a, wall_a = lm_drain(svc, streams)
    finally:
        ex.close()
    svc_s = BatchedEstimationService(workload=wl, max_batch=LM_MAX_BATCH)
    rs_s, wall_s = lm_drain(svc_s, streams)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chains = {sid: lm_chain(wl, cs) for sid, cs in streams.items()}
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base   # the LM's own
    launches = {fn.__name__: fn.launches for fn in counted}
    check(all(n == 0 for n in launches.values()),
          f"the LM path launched a CMAX kernel: {launches}")

    for name, rs, s in (("async", rs_a, svc), ("sync", rs_s, svc_s)):
        check(len(rs) == n_chunks and all(r.status == "ok" for r in rs),
              f"{name}: not every chunk was served")
        for r in rs:
            want = chains[r.stream_id][0][r.seq]
            check(np.array_equal(np.asarray(r.omega), want),
                  f"{name}: {r.stream_id} chunk {r.seq} differs from the "
                  f"batch-1 chain")
        for sid in streams:
            check(same_cache(s._warm[sid], chains[sid][1]),
                  f"{name}: {sid}'s final KV cache differs from the chain")
    classes = sorted({(r.bucket_n, r.batch_b) for r in rs_a})

    # one batch's logits on the caller's stream and on a worker stream
    wl_l = LMDecodeWorkload(cfg, params=model, policy=policy,
                            max_len=LM_MAX_LEN, return_logits=True,
                            device=dev)
    firsts = [cs[0] for cs in streams.values()]
    b = max(wl_l.bucket_of(c) for c in firsts)
    data, st, _ = wl_l.make_batch(firsts, [wl_l.default_state()] *
                                  len(firsts), b, LM_MAX_BATCH)
    inline = wl_l.executable(b, LM_MAX_BATCH)(data, st)
    torch.cuda.synchronize()
    ex = AsyncDispatchExecutor()
    try:
        worker = ex.wait(ex.submit(wl_l.executable(b, LM_MAX_BATCH), data,
                                   st, b, LM_MAX_BATCH))
    finally:
        ex.close()
    check(torch.equal(inline.logits, worker.logits)
          and torch.equal(inline.tokens, worker.tokens),
          "logits differ between the caller's stream and a worker stream")
    check(all(same_cache(x, y) for x, y in zip(inline.state, worker.state)),
          "caches differ between the caller's stream and a worker stream")
    check(bool(torch.isfinite(inline.logits).all()), "non-finite logits")

    out = dict(n_params=n_params, tokens=n_tok, chunks=n_chunks,
               async_s=wall_a, sync_s=wall_s, chain_s=wall_c,
               async_tok_s=n_tok / wall_a, sync_tok_s=n_tok / wall_s,
               chain_tok_s=n_tok / wall_c,
               async_ms_per_step=1e3 * wall_a / n_tok,
               sync_ms_per_step=1e3 * wall_s / n_tok,
               chain_ms_per_step=1e3 * wall_c / n_tok,
               async_batches=svc.stats["batches"],
               sync_batches=svc_s.stats["batches"],
               async_padded_slot_frac=svc.padded_slot_frac,
               sync_padded_slot_frac=svc_s.padded_slot_frac,
               classes=classes, peak_gb=peak / 1e9)
    print(f"[lm] served {n_chunks} chunks ({n_tok} tokens, "
          f"{LM_STREAMS} streams x {LM_CHUNKS}) async in {wall_a:.3f} s = "
          f"{out['async_tok_s']:.2f} tok/s, {out['async_ms_per_step']:.3f} "
          f"ms per decode step, {svc.stats['batches']} batches of classes "
          f"{classes}, padded_slot_frac {svc.padded_slot_frac:.3f}; sync "
          f"{wall_s:.3f} s = {out['sync_tok_s']:.2f} tok/s, "
          f"{svc_s.stats['batches']} batches, padded_slot_frac "
          f"{svc_s.padded_slot_frac:.3f}; batch-1 chain {wall_c:.3f} s; "
          f"peak memory {out['peak_gb']:.3f} GB above what earlier phases "
          f"hold (weights included); on {card}")
    print(f"[lm] every served token sequence and final KV cache bitwise "
          f"equal to the batch-1 chain, async == sync; one batch's logits "
          f"bitwise equal on the caller's and a worker stream; CMAX kernel "
          f"launches {launches}")
    return out, model


@torch.inference_mode()
def lm_step_timing(model, dev, card, steps: int = 5) -> dict:
    """A batch-1 decode step of the served model from position 128: its
    pace (host clock over 20 steps, synchronized) and, under
    `torch.profiler`, the device's busy time per step (the kernels' device
    times; an operator's row is not summed), the idle share, the kernel
    launches and aten calls per step and the kernels that took the most
    device time."""
    from repro_torch.models import transformer as tt
    cfg = model.cfg
    token = torch.tensor([[17]], dtype=torch.int32, device=dev)
    cache = tt.init_cache(cfg, 1, LM_MAX_LEN, dev)
    for c in cache["layers"]:
        c["idx"] = 128
    for _ in range(3):
        tt.decode_step(model, token, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        tt.decode_step(model, token, cache)
    torch.cuda.synchronize()
    pace_ms = (time.perf_counter() - t0) * 1e3 / 20
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tt.decode_step(model, token, cache)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy, launches, top = device_kernels(prof)
    busy_ms = busy / steps
    out = dict(pace_ms=pace_ms, profiled_ms=prof_ms,
               launches_per_step=launches / steps,
               aten_calls_per_step=sum(
                   e.count for e in prof.key_averages()
                   if e.key.startswith("aten::")) / steps)
    if busy_ms > 0:
        # the profiler slows the host, not the kernels: idle share against
        # the unprofiled pace
        out.update(device_ms=busy_ms, idle_share=1.0 - busy_ms / pace_ms)
        idle = f"{out['idle_share']:.3f}"
    else:
        idle = "not measured (the profiler saw no device time)"
    print(f"[lm] one decode step of {cfg.name} (batch 1, from position "
          f"128): pace {pace_ms:.3f} ms ({prof_ms:.3f} ms under the "
          f"profiler), device busy {busy_ms:.3f} ms, idle share {idle}, "
          f"{out['launches_per_step']:.0f} kernel launches and "
          f"{out['aten_calls_per_step']:.0f} aten calls per step; on {card}")
    for k_ms, calls, name in top[:8]:
        print(f"[lm]   kernel {k_ms * 1e3 / steps:9.1f} us/step "
              f"{calls / steps:5.0f} calls/step  {name[:80]}")
    return out


@torch.inference_mode()
def lm_decode_vs_forward(cfg, dev, card) -> float:
    """8 decode steps reproduce `forward`'s logits on `dev` (the
    reference's bar), greedy tokens equal."""
    from repro_torch.models import transformer as tt
    model = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32), device=dev)
    full = tt.forward(model, toks)
    cache = tt.init_cache(cfg, 1, 8, dev)
    dec = torch.cat([tt.decode_step(model, toks[:, t:t + 1], cache)[0]
                     for t in range(8)], dim=1)
    err = float((dec - full).abs().max())
    ok = bool(torch.allclose(dec, full, rtol=LM_RTOL, atol=LM_ATOL))
    same = bool(torch.equal(dec.argmax(-1), full.argmax(-1)))
    print(f"[lm] {cfg.name} {cfg.dtype}: 8 decode steps vs forward, logits "
          f"max abs diff {err:.3e} (rtol {LM_RTOL}, atol {LM_ATOL}), greedy "
          f"tokens equal {same}; on {card}")
    check(ok, f"decode differs from forward by {err}")
    check(same, "decode's greedy tokens differ from forward's")
    del model
    torch.cuda.empty_cache()
    return err


def lm_smoke_configs(dev, card) -> float:
    """Each SMOKE config, built from one seed on the CPU and copied to
    `dev`: 8 decode steps there within the reference's bar of the CPU's,
    greedy tokens equal (VLM and whisper decode against their cross
    source). Returns the largest difference."""
    import copy

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import transformer as tt
    worst = 0.0
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        cpu = tt.init_params(cfg, torch.Generator().manual_seed(0),
                             max_len=64, device="cpu")
        card_model = copy.deepcopy(cpu).to(dev)
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)
        cross = None
        if cfg.family == "vlm" or cfg.is_enc_dec:
            cross = (rng.normal(size=(1, cfg.cross_source_len, cfg.d_model))
                     * 0.1).astype(np.float32)
        logits = {}
        for where, m in (("cpu", cpu), ("card", card_model)):
            d = next(m.parameters()).device
            x = None if cross is None else torch.as_tensor(cross, device=d)
            with torch.inference_mode():
                if x is not None and cfg.is_enc_dec:
                    x = tt.encode(m, x)
                cache = tt.init_cache(cfg, 1, 16, d)
                t = torch.as_tensor(toks, device=d)
                logits[where] = torch.cat(
                    [tt.decode_step(m, t[:, i:i + 1], cache,
                                    cross_source=x)[0]
                     for i in range(8)], dim=1).cpu()
        err = float((logits["card"] - logits["cpu"]).abs().max())
        worst = max(worst, err)
        check(bool(torch.allclose(logits["card"], logits["cpu"],
                                  rtol=LM_RTOL, atol=LM_ATOL)),
              f"{arch}: card decode differs from the CPU's by {err}")
        check(torch.equal(logits["card"].argmax(-1),
                          logits["cpu"].argmax(-1)),
              f"{arch}: card greedy tokens differ from the CPU's")
    print(f"[lm] the {len(ARCH_IDS)} SMOKE configs decode 8 tokens on the "
          f"card within rtol {LM_RTOL} / atol {LM_ATOL} of the CPU, greedy "
          f"tokens equal; largest logits difference {worst:.3e}; on {card}")
    return worst


TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 1024, 8, 2, 6
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core rate
G_RTOL, G_ATOL = 5e-4, 5e-5  # tests/test_pipeline_parallel.py:54-55
TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "train_checkpoints")


def train_flops(cfg, model, B, S) -> tuple:
    """(model FLOPs of one train step, FLOPs of remat's re-forward): 6 N T
    for the weight products (the tied table counted once, as the
    unembedding) plus forward and backward of attention's two (S x S)
    products over every head (the port computes the whole masked matrix);
    the re-forward repeats the layers' products and attention once."""
    n = sum(p.numel() for p in model.parameters())
    n_layers = sum(p.numel() for p in model.layers.parameters())
    T = B * S
    attn = 4 * cfg.n_layers * B * S * S * cfg.n_heads * cfg.head_dim
    return 6 * n * T + 3 * attn, 2 * n_layers * T + attn


def train_full_width(cfg, counted, dev, card) -> dict:
    """Phase 12, full width: `cfg` trained from a seeded generator on the
    card through `train.loop.train` (AdamW with f32 moments, remat "full",
    seq TRAIN_SEQ, global batch TRAIN_BATCH in TRAIN_MICRO microbatches,
    TRAIN_STEPS steps, no checkpoint); then one step under the profiler.
    No CMAX kernel may launch."""
    from repro_torch.data import lm as lm_data
    from repro_torch.models import transformer as tt
    from repro_torch.train import loop

    tc = loop.TrainConfig(steps=TRAIN_STEPS, ckpt_dir=os.path.join(
        TRAIN_DIR, "full"), ckpt_every=0, log_every=1, seed=0,
        optimizer="adamw", microbatch=TRAIN_MICRO)
    data = lm_data.batches(lm_data.LMDataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = loop.train(cfg, tc, dev, data, max_len=TRAIN_SEQ)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {fn.__name__: fn.launches for fn in counted}
    check(all(n == 0 for n in launches.values()),
          f"training launched a CMAX kernel: {launches}")
    state = hist["state"]
    model = state.params
    n_params = sum(p.numel() for p in model.parameters())
    check(len(hist["loss"]) == TRAIN_STEPS
          and all(np.isfinite(hist["loss"])), f"losses {hist['loss']}")
    check(state.opt_state.step == TRAIN_STEPS,
          f"optimizer step {state.opt_state.step} != {TRAIN_STEPS}")
    fresh = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(
        tc.seed), max_len=TRAIN_SEQ, device=dev)
    moved = [name for name, p in fresh.named_parameters()
             if not torch.equal(p, model.get_parameter(name))]
    del fresh
    n_tensors = len(list(model.parameters()))
    check(len(moved) == n_tensors,
          f"{len(moved)} of {n_tensors} parameter tensors changed")

    ms = float(np.median(hist["step_time"][1:])) * 1e3   # steps 2-6
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops, remat = train_flops(cfg, model, TRAIN_BATCH, TRAIN_SEQ)
    out = dict(n_params=n_params, losses=hist["loss"],
               step_ms=[t * 1e3 for t in hist["step_time"]],
               ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
               model_flops=flops, remat_flops=remat,
               flop_share=flops / (ms / 1e3) / BF16_FLOPS,
               flop_share_with_remat=(flops + remat) / (ms / 1e3)
               / BF16_FLOPS, peak_gb=peak / 1e9, wall_s=wall)
    print(f"[train] {cfg.name} {cfg.dtype}: {n_params} parameters, AdamW "
          f"(f32 moments), remat full, seq {TRAIN_SEQ}, global batch "
          f"{TRAIN_BATCH} in {TRAIN_MICRO} microbatches, {TRAIN_STEPS} "
          f"steps in {wall:.2f} s: losses "
          f"{[round(x, 4) for x in hist['loss']]}; on {card}")
    print(f"[train] {ms:.1f} ms per step (median of steps 2-{TRAIN_STEPS}; "
          f"each {[round(x) for x in out['step_ms']]} ms), "
          f"{out['tokens_per_s']:.0f} tokens/s; model FLOPs {flops:.4e} "
          f"per step ({out['flop_share']:.4f} of {BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s bf16; remat's re-forward {remat:.4e} more, "
          f"{out['flop_share_with_remat']:.4f} with it); peak memory "
          f"{out['peak_gb']:.2f} GB; on {card}")

    # one more step under the profiler: device busy time, idle share
    step = loop.make_step(cfg, tc, dev)
    toks, labels = next(data)
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
    out.update(profiled_step(lambda: step(model, state.opt_state,
                                          state.comp_state, batch),
                             state, ms, "train", card))
    return out, model


def device_kernels(prof):
    """(busy ms, launches, [(ms, calls, name)] costliest first) of the
    profiler's device kernels, summed from its raw events: building the
    per-event records that `key_averages` reads takes minutes for a step
    of a million launches."""
    by = {}
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not (annotation and annotation()) \
                and e.duration_ns() > 0:
            t = by.setdefault(e.name(), [0, 0])
            t[0] += e.duration_ns()
            t[1] += 1
    top = sorted(((ns / 1e6, n, name) for name, (ns, n) in by.items()),
                 reverse=True)
    return sum(t[0] for t in top), sum(t[1] for t in top), top


def profiled_step(run, state, ms, tag, card) -> dict:
    """One more train step `run()` under `torch.profiler`, recording the
    device's activity only: its device busy time, the idle share against
    the unprofiled `ms` per step, kernel launches and the costliest
    kernels. The step's new optimizer state goes back into `state`."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state.opt_state, state.comp_state, met = run()
        float(met["loss"])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy, launches, top = device_kernels(prof)
    out = dict(profiled_ms=prof_ms, launches_per_step=launches)
    if busy > 0:
        out.update(device_ms=busy, idle_share=1.0 - busy / ms)
        idle = f"{out['idle_share']:.3f}"
    else:
        idle = "not measured (the profiler saw no device time)"
    print(f"[{tag}] one step under torch.profiler: {prof_ms:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {idle} (against the unprofiled "
          f"{ms:.1f} ms), {launches} kernel launches; on {card}")
    for k_ms, calls, name in top[:8]:
        print(f"[{tag}]   kernel {k_ms:9.2f} ms {calls:6d} calls  "
              f"{name[:80]}")
    return out


def train_bf16_vs_f32(model, dev, card) -> dict:
    """Phase 12: the trained bf16 model and an f32 copy of its parameters,
    on one full batch (remat "full", TRAIN_MICRO microbatches): the losses
    agree within rtol 2e-2, and so do the gradients of the unembedding (the
    tied table for a tied config), as the relative L2 norm of their
    difference. The bf16 side runs forward and backward through
    `f32_product` on the card."""
    from repro_torch.data import lm as lm_data
    from repro_torch.models import loss_and_grads
    from repro_torch.models import transformer as tt
    cfg = model.cfg
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    f32 = tt.Transformer(f32cfg, None, 0).to_empty(device=dev)
    f32.load_state_dict({k: v.float() for k, v in
                         model.state_dict().items()})
    toks, labels = next(lm_data.batches(lm_data.LMDataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)))
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
    name = "embed.table" if cfg.tie_embeddings else "lm_head.w"
    res = {}
    for what, m in (("bf16", model), ("f32", f32)):
        loss, grads = loss_and_grads(m, batch, microbatch=TRAIN_MICRO)
        res[what] = (float(loss), grads[name].float())
        del grads
    del f32
    (lb, gb), (lf, gf) = res["bf16"], res["f32"]
    rel = abs(lb - lf) / abs(lf)
    grel = float((gb - gf).norm() / gf.norm())
    cos = float((gb * gf).sum() / (gb.norm() * gf.norm()))
    print(f"[train] bf16 loss {lb:.6f} vs its f32 copy's {lf:.6f} on one "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} batch: relative difference "
          f"{rel:.3e} (rtol 2e-2); gradient of {name} {tuple(gf.shape)}: "
          f"relative L2 difference {grel:.3e} (bar 2e-2), cosine "
          f"{cos:.6f}; on {card}")
    check(rel <= 2e-2, f"bf16 loss {lb} differs from f32 {lf}")
    check(grel <= 2e-2, f"bf16 gradient of {name} differs from the f32 "
          f"copy's by {grel:.3e} (relative L2)")
    return {"loss_rel": rel, "grad_rel_l2": grel, "grad_cosine": cos}


def train_smoke_configs(dev, card) -> float:
    """Phase 12: each SMOKE config, built from one seed on the CPU and
    copied to the card, takes one train step (remat "full", AdamW) on
    both: loss, every gradient and every updated parameter within the
    reference's gradient bar. Returns the largest difference."""
    import copy

    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.models import loss_and_grads
    from repro_torch.models import transformer as tt
    from repro_torch.train import optim
    worst = 0.0
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        cpu = tt.init_params(cfg, torch.Generator().manual_seed(0),
                             max_len=64, device="cpu")
        card_model = copy.deepcopy(cpu).to(dev)
        toks, labels = next(batches(LMDataConfig(cfg.vocab_size, 16, 4)))
        b_np = {"tokens": toks, "labels": labels}
        if cfg.family == "vlm" or cfg.is_enc_dec:
            b_np["cross_source"] = (np.random.default_rng(0).normal(
                size=(4, cfg.cross_source_len, cfg.d_model)) * 0.1
            ).astype(np.float32)
        res = {}
        for where, m in (("cpu", cpu), ("card", card_model)):
            d = next(m.parameters()).device
            b = {k: torch.as_tensor(v, device=d) for k, v in b_np.items()}
            loss, grads = loss_and_grads(m, b)
            optim.adamw_update(ocfg, grads, optim.adamw_init(ocfg, m), m)
            res[where] = [("loss", loss.cpu())] + [
                (f"grad {k}", v.cpu()) for k, v in grads.items()] + [
                (f"param {k}", v.detach().cpu())
                for k, v in m.named_parameters()]
        for (what, got), (_, want) in zip(res["card"], res["cpu"]):
            err = float((got - want).abs().max())
            worst = max(worst, err)
            check(bool(torch.allclose(got, want, rtol=G_RTOL, atol=G_ATOL)),
                  f"{arch} {what}: card differs from the CPU by {err}")
    print(f"[train] the {len(ARCH_IDS)} SMOKE configs take one train step "
          f"on the card within rtol {G_RTOL} / atol {G_ATOL} of the CPU "
          f"(loss, every gradient, every updated parameter); largest "
          f"difference {worst:.3e}; on {card}")
    return worst


def train_subprocesses(card):
    """Phase 12: examples/torch_fault_tolerant_train.py (its defaults: 60
    steps, failures at 17 and 35, int8 compression; it checks its last
    checkpoint restores bitwise) and `python -m repro_torch.launch.train
    --arch llama3.2-1b --smoke --steps 8`, both on the card, at once."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    cmds = {
        "fault_tolerant_train": [
            sys.executable, os.path.join(root, "examples",
                                         "torch_fault_tolerant_train.py"),
            "--ckpt", os.path.join(TRAIN_DIR, "ft_demo")],
        "launch.train": [
            sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama3.2-1b", "--smoke", "--steps", "8", "--ckpt",
            os.path.join(TRAIN_DIR, "train_cli")],
    }
    procs = {}
    try:
        for k, cmd in cmds.items():
            procs[k] = (subprocess.Popen(cmd, env=env, cwd=root,
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), time.perf_counter())
        outs = {}
        for k, (p, t0) in procs.items():
            text, _ = p.communicate(timeout=300)
            outs[k] = (p.returncode, text, time.perf_counter() - t0)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, (rc, text, wall) in outs.items():
        tail = [ln for ln in text.splitlines() if ln.strip()][-4:]
        print(f"[train] {k}: exit {rc} in {wall:.1f} s; on {card}")
        for ln in tail:
            print(f"[train]   {ln}")
        check(rc == 0, f"{k} failed:\n{text[-3000:]}")
    ft = outs["fault_tolerant_train"][1]
    check("survived 2 node failures" in ft, "the example did not restart "
          "exactly twice")
    check("restored bitwise" in ft, "the example's checkpoint was not "
          "restored bitwise")
    check("final loss" in outs["launch.train"][1], "launch.train printed "
          "no final loss")
    return {k: v[2] for k, v in outs.items()}


DIST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "train_dist")
EP_TOL = 2e-4                # tests/test_sharding_subprocess.py:86-87
MOE_ARCH = "deepseek-moe-16b"


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_full_width(cfg, grid, counted, dev, card, single) -> dict:
    """Phase 13, full width: `cfg` trained as in [train] (the same seed,
    batches, optimizer, remat, microbatches and steps) through
    `train.loop.train` on `grid`, a ("data", "model") grid of (1, 1) in the
    world of one rank, with FSDP: the parameters and the optimizer state
    are DTensors. Each loss within rtol 5e-4 of [train]'s (`single`); ms
    per step beside [train]'s; peak memory; one more step under the
    profiler and one under `StepCommMode` (collectives per step)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data import lm as lm_data
    from repro_torch.sharding import distribute_batch
    from repro_torch.sharding.comms import StepCommMode
    from repro_torch.train import loop

    tc = loop.TrainConfig(steps=TRAIN_STEPS, ckpt_dir=os.path.join(
        DIST_DIR, "full"), ckpt_every=0, log_every=1, seed=0,
        optimizer="adamw", microbatch=TRAIN_MICRO, fsdp=True)
    data = lm_data.batches(lm_data.LMDataConfig(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = loop.train(cfg, tc, grid, data, max_len=TRAIN_SEQ)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {fn.__name__: fn.launches for fn in counted}
    check(all(n == 0 for n in launches.values()),
          f"distributed training launched a CMAX kernel: {launches}")
    state = hist["state"]
    model = state.params
    check(all(isinstance(p, DTensor) for p in model.parameters())
          and all(isinstance(v, DTensor) for v in state.opt_state.mu.values()),
          "the parameters and moments are not all DTensors")
    losses, want = np.array(hist["loss"]), np.array(single["losses"])
    check(len(losses) == TRAIN_STEPS and np.all(np.isfinite(losses)),
          f"losses {losses}")
    rel = np.abs(losses - want) / np.abs(want)
    bitwise = bool(np.array_equal(losses, want))
    ms = float(np.median(hist["step_time"][1:])) * 1e3
    out = dict(losses=hist["loss"], loss_rel=rel.tolist(),
               losses_bitwise=bitwise,
               step_ms=[t * 1e3 for t in hist["step_time"]],
               ms_per_step=ms, single_ms_per_step=single["ms_per_step"],
               ratio=ms / single["ms_per_step"], peak_gb=peak / 1e9,
               single_peak_gb=single["peak_gb"], wall_s=wall)
    print(f"[train-dist] {cfg.name} {cfg.dtype} on a (1, 1) ('data', "
          f"'model') grid, NCCL world of 1, FSDP, DTensor parameters and "
          f"moments; {TRAIN_STEPS} steps in {wall:.2f} s: losses "
          f"{[round(x, 6) for x in hist['loss']]} against [train]'s "
          f"{[round(x, 6) for x in single['losses']]}: largest relative "
          f"difference {rel.max():.3e} (rtol {G_RTOL}), "
          f"{'bitwise' if bitwise else 'not bitwise'}; on {card}")
    check(bool(np.allclose(losses, want, rtol=G_RTOL, atol=0.0)),
          f"losses {losses} differ from [train]'s {want}")
    print(f"[train-dist] {ms:.1f} ms per step (median of steps 2-"
          f"{TRAIN_STEPS}; each {[round(x) for x in out['step_ms']]} ms) "
          f"against [train]'s {single['ms_per_step']:.1f} ms "
          f"({out['ratio']:.3f}x); peak memory {out['peak_gb']:.2f} GB "
          f"against {single['peak_gb']:.2f} GB; on {card}")

    step = loop.make_step(cfg, tc, grid)
    mesh = next(model.parameters()).device_mesh

    def batch():
        toks, labels = next(data)
        return distribute_batch({"tokens": torch.as_tensor(toks, device=dev),
                                 "labels": torch.as_tensor(labels,
                                                           device=dev)},
                                mesh)
    b = batch()
    out.update(profiled_step(lambda: step(model, state.opt_state,
                                          state.comp_state, b),
                             state, ms, "train-dist", card))
    b = batch()
    with StepCommMode() as comm:
        state.opt_state, state.comp_state, met = step(
            model, state.opt_state, state.comp_state, b)
        float(met["loss"])
    out["collectives_per_step"] = comm.counts()
    print(f"[train-dist] collectives in one step (StepCommMode): "
          f"{out['collectives_per_step']} ({comm.get_total_counts()} in "
          f"all); on {card}")
    return out


def dist_moe_layer(mesh, dev, card) -> dict:
    """Phase 13: one MoE layer of deepseek-moe-16b's published config (64
    routed experts top-6 of moe_d_ff 1408, 2 shared, d_model 2048, from a
    seeded generator on the card), forward and backward on 8 x 1024
    tokens: `moe_apply_ep` over `mesh` (experts as DTensors placed by the
    reference's specs with FSDP) against the dense `moe_apply`, at the same
    capacity. In the published bf16 and in an f32 copy: output and every
    gradient within rtol / atol 2e-4 (an f32 bar) in f32, and within the
    reference's bf16 bar (0.05, tests/test_kernels.py:55) in bf16, where
    the input's gradient sums each token's pairs and shared experts in
    bf16 (one rounding of 2**-7 at magnitude 1 when the sums meet in
    another order); whether each is bitwise; ms of each path (forward and
    backward, the host's pace)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config
    from repro_torch.models.layers import settle
    from repro_torch.models.moe import MoE, capacity_of, moe_apply, \
        moe_apply_ep
    from repro_torch.sharding import place, port_layout, to_placements
    from repro_torch.sharding.comms import StepCommMode
    published = get_config(MOE_ARCH)
    check((published.d_model, published.n_experts,
           published.experts_per_token, published.moe_d_ff,
           published.n_shared_experts, published.dtype)
          == (2048, 64, 6, 1408, 2, "bfloat16"),
          f"{MOE_ARCH} is not its published config")
    whole = [Replicate()] * mesh.ndim
    B, S = TRAIN_BATCH, TRAIN_SEQ
    cap = capacity_of(published, B * S)
    out = dict(capacity=cap)
    for dtype, tol in (("bfloat16", 0.05), ("float32", EP_TOL)):
        cfg = dataclasses.replace(published, dtype=dtype)
        dense = MoE(cfg, torch.Generator(device=dev).manual_seed(0))
        ep = MoE(cfg, torch.Generator(device=dev).manual_seed(0))
        specs, _ = port_layout({f"layers.1.moe.{n}": p for n, p in
                                ep.named_parameters()}, cfg, mesh, fsdp=True)
        for name, p in list(ep.named_parameters()):
            owner = ep.shared if name.startswith("shared.") else ep
            d = place(p.detach(), mesh,
                      to_placements(specs[f"layers.1.moe.{name}"], mesh))
            setattr(owner, name.rpartition(".")[2], torch.nn.Parameter(d))
        g = torch.Generator(device=dev).manual_seed(1)
        x = (torch.randn((B, S, cfg.d_model), generator=g, device=dev)
             * 0.5).to(dense.wg.dtype)
        ct = torch.randn(x.shape, generator=g, device=dev)
        xd = x.clone().requires_grad_(True)
        xe = DTensor.from_local(x.clone(), mesh, whole,
                                run_check=False).requires_grad_(True)
        ct_e = DTensor.from_local(ct, mesh, whole, run_check=False)

        def run_dense():
            o = moe_apply(dense, xd, cfg, capacity=cap)
            return o, torch.autograd.grad((o.float() * ct).sum(),
                                          [xd, *dense.parameters()])

        def run_ep():
            o = settle(moe_apply_ep(ep, xe, cfg, mesh, capacity=cap,
                                    fsdp_axis="data"))
            return o, torch.autograd.grad((o.float() * ct_e).sum(),
                                          [xe, *ep.parameters()])

        (od, gd), (oe, ge) = run_dense(), run_ep()
        names = ["output", "x"] + [n for n, _ in dense.named_parameters()]
        worst, bitwise = 0.0, True
        for n, a, b in zip(names, [oe, *ge], [od, *gd]):
            a = a.full_tensor() if isinstance(a, DTensor) else a
            err = float((a.float() - b.float()).abs().max())
            worst = max(worst, err)
            bitwise = bitwise and bool(torch.equal(a, b))
            check(bool(torch.allclose(a.float(), b.float(), rtol=tol,
                                      atol=tol)),
                  f"{dtype} moe_apply_ep's {n} differs from the dense "
                  f"path's by {err} (bar {tol})")
        del od, gd, oe, ge
        ms_dense = cuda_ms(run_dense, reps=3, warmup=1, hold=False)
        ms_ep = cuda_ms(run_ep, reps=3, warmup=1, hold=False)
        with StepCommMode() as comm:
            run_ep()
        n_params = sum(p.numel() for p in dense.parameters())
        out[dtype] = dict(max_abs_err=worst, bar=tol, bitwise=bitwise,
                          dense_ms=ms_dense, ep_ms=ms_ep,
                          collectives=comm.counts())
        print(f"[train-dist] {MOE_ARCH} MoE layer ({n_params} parameters, "
              f"{dtype}, capacity {cap}) on {B} x {S} tokens, forward and "
              f"backward: moe_apply_ep over the world of 1 against "
              f"moe_apply, output and every gradient within {tol}: largest "
              f"difference {worst:.3e}, "
              f"{'bitwise' if bitwise else 'not bitwise'}; {ms_ep:.2f} ms "
              f"against {ms_dense:.2f} ms dense; collectives "
              f"{comm.counts()}; on {card}")
        del dense, ep, xd, xe
        torch.cuda.empty_cache()
    out["n_params"] = n_params
    return out


def dist_elastic(grid, dev, card) -> dict:
    """Phase 13: the elastic round trip, at llama3.2-1b's SMOKE size in
    bf16 (a full-width checkpoint is 12.4 GB through numpy's zlib). Six
    steps on `grid` with FSDP write checkpoints at steps 3 and 6. Step 3
    restored onto one card equals it restored onto the grid, bitwise;
    written again from the card and restored onto the grid, bitwise again;
    and the single-card loop resumed from it trains steps 4-6 within rtol
    5e-4 of the grid's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm as lm_data
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="bfloat16")
    root = os.path.join(DIST_DIR, "elastic")
    data = lambda: lm_data.batches(lm_data.LMDataConfig(cfg.vocab_size, 64,
                                                        8, seed=0))
    kw = dict(steps=6, ckpt_every=3, log_every=0, seed=0, lr=1e-3)
    gtc = loop.TrainConfig(ckpt_dir=os.path.join(root, "grid"), fsdp=True,
                           **kw)
    hist = loop.train(cfg, gtc, grid, data(), max_len=64)
    check(sorted(ckpt.committed_steps(gtc.ckpt_dir)) == [3, 6],
          f"grid checkpoints {ckpt.committed_steps(gtc.ckpt_dir)}")

    def whole(tree):
        from repro_torch.train.checkpoint import _flatten
        return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                for k, v in _flatten(tree).items()}

    def same(a, b):
        return a.keys() == b.keys() and all(
            (torch.equal(a[k], b[k]) and a[k].dtype == b[k].dtype)
            if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a)

    stc = loop.TrainConfig(ckpt_dir=os.path.join(root, "single"), **kw)
    one = loop.checkpoint_tree(loop.init_state(cfg, stc, dev, 64))
    on_grid = loop.checkpoint_tree(loop.init_state(cfg, gtc, grid, 64))
    a, extra = ckpt.restore(gtc.ckpt_dir, one, step=3, device=dev)
    b, _ = ckpt.restore(gtc.ckpt_dir, on_grid, step=3,
                        shardings=ckpt.shardings_of(on_grid))
    grid_to_card = same(whole(a), whole(b))
    check(grid_to_card, "the grid's step-3 checkpoint differs on one card")
    ckpt.save(stc.ckpt_dir, 3, a, extra=extra)
    c, _ = ckpt.restore(stc.ckpt_dir, on_grid,
                        shardings=ckpt.shardings_of(on_grid))
    card_to_grid = same(whole(c), whole(b))
    check(card_to_grid, "the card's checkpoint differs on the grid")
    rest = data()
    for _ in range(3):          # the grid's steps 1-3 took these batches
        next(rest)
    resumed = loop.train(cfg, stc, dev, rest, max_len=64)
    rel = np.abs(np.array(resumed["loss"]) - np.array(hist["loss"][3:])) \
        / np.abs(np.array(hist["loss"][3:]))
    check(len(resumed["loss"]) == 3 and bool(np.all(rel <= G_RTOL)),
          f"the resumed single-card losses {resumed['loss']} differ from "
          f"the grid's {hist['loss'][3:]}")
    print(f"[train-dist] elastic ({cfg.name} SMOKE, bf16): the grid's step-3 "
          f"checkpoint restored onto one card and onto the grid, bitwise "
          f"{grid_to_card}; written from the card and restored onto the "
          f"grid, bitwise {card_to_grid}; the single-card loop resumed at "
          f"step {extra['next_step']} trains steps 4-6 within "
          f"{rel.max():.3e} of the grid's losses; on {card}")
    return dict(grid_to_card=grid_to_card, card_to_grid=card_to_grid,
                resumed_loss_rel=float(rel.max()))


def dist_two_cards(single, card) -> dict:
    """Phase 13 with two or more cards: `launch.train` under torchrun on
    two ranks (an NCCL world of 2, a (2, 1) grid with FSDP) at [train]'s
    settings; its final loss within rtol 5e-4 of [train]'s. With one card
    it prints why the multi-rank arithmetic rests on the CPU tests."""
    if torch.cuda.device_count() < 2:
        print(f"[train-dist] one card: a world of 2 would need a second "
              f"(NCCL refuses two ranks on one GPU), so the multi-rank "
              f"arithmetic rests on the CPU tests over gloo "
              f"(tests/test_torch_dist_train.py, "
              f"tests/test_torch_dist_parts.py); on {card}")
        return {"ranks": 1}
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
           "--arch", "llama3.2-1b", "--fsdp", "--seq", str(TRAIN_SEQ),
           "--batch", str(TRAIN_BATCH), "--microbatch", str(TRAIN_MICRO),
           "--steps", str(TRAIN_STEPS), "--ckpt-every", "0", "--ckpt",
           os.path.join(DIST_DIR, "two")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, cwd=root, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"torchrun on 2 cards failed:\n"
          f"{(p.stdout + p.stderr)[-3000:]}")
    m = re.search(r"final loss ([0-9.]+)", p.stdout)
    check(m is not None, "torchrun on 2 cards printed no final loss")
    last = float(m.group(1))
    want = single["losses"][-1]
    print(f"[train-dist] 2 cards, (2, 1) grid with FSDP: final loss {last} "
          f"against [train]'s {want:.4f}, {wall:.1f} s; on {card}")
    check(abs(last - want) <= G_RTOL * abs(want) + 5e-5,
          f"2-card final loss {last} differs from {want}")
    return {"ranks": 2, "final_loss": last, "wall_s": wall}


@contextlib.contextmanager
def world_of_one(dev):
    """An NCCL world of one rank (gloo on the CPU) over a TCP rendezvous
    on 127.0.0.1, and its (1, 1) ("data", "model") grid on `dev`;
    destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    init_distributed("nccl" if dev.type == "cuda" else "gloo",
                     f"tcp://127.0.0.1:{free_port()}", 0, 1)
    try:
        yield make_mesh((1, 1), ("data", "model"), [dev])
    finally:
        dist.destroy_process_group()


def train_dist_phase(cfg, counted, dev, card, single, grid) -> dict:
    """Phase 13, on `grid` (`world_of_one`): the full-width run, the MoE
    layer through `moe_apply_ep` and the elastic round trip. Checkpoints
    go to build/train_dist, emptied before and after."""
    from repro_torch.launch.mesh import device_mesh
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    try:
        out = dist_full_width(cfg, grid, counted, dev, card, single)
        torch.cuda.empty_cache()
        out["moe"] = dist_moe_layer(device_mesh(grid), dev, card)
        torch.cuda.empty_cache()
        out["elastic"] = dist_elastic(grid, dev, card)
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)
    return out


REC_TRAIN, REC_PREFILL = "xlstm-1.3b", "recurrentgemma-9b"
# train_4k's 4,096 cut to 256: sLSTM runs one step of its cell per token
REC_SEQ, REC_BATCH, REC_MICRO, REC_STEPS = 256, 8, 2, 3
REC_PREFILL_SEQ = 2048
REC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "recurrent")


def recurrent_train(cfg, grid, counted, dev, card) -> dict:
    """Phase 14 (a): xlstm-1.3b's published config (48 alternating mLSTM /
    sLSTM layers, d_model 2048, 4 heads, vocab 50,304, bf16, from a seeded
    generator) trained through `train.loop.train` on the card (AdamW, remat
    "full", seq REC_SEQ, global batch REC_BATCH in REC_MICRO microbatches,
    REC_STEPS steps, no checkpoint), then the same run on `grid` with FSDP,
    where the recurrent forms run on their local shards: each grid loss
    within rtol 5e-4 of the card's. Ms per step of both, peak memory, and
    one more card step under the profiler. No CMAX kernel may launch."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data import lm as lm_data
    from repro_torch.train import loop

    def run(where, **kw):
        tc = loop.TrainConfig(steps=REC_STEPS, ckpt_dir=os.path.join(
            REC_DIR, where), ckpt_every=0, log_every=1, seed=0,
            optimizer="adamw", microbatch=REC_MICRO, **kw)
        data = lm_data.batches(lm_data.LMDataConfig(
            cfg.vocab_size, REC_SEQ, REC_BATCH, seed=0))
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        hist = loop.train(cfg, tc, grid if kw else dev, data,
                          max_len=REC_SEQ)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        check(all(n == 0 for n in launches.values()),
              f"recurrent training launched a CMAX kernel: {launches}")
        losses = hist["loss"]
        check(len(losses) == REC_STEPS and all(np.isfinite(losses)),
              f"losses {losses}")
        res = dict(losses=losses, step_ms=[t * 1e3 for t in
                                           hist["step_time"]],
                   ms_per_step=float(np.median(hist["step_time"][1:]))
                   * 1e3, peak_gb=torch.cuda.max_memory_allocated(dev)
                   / 1e9, wall_s=wall)
        return res, hist["state"], tc, data

    shutil.rmtree(REC_DIR, ignore_errors=True)
    try:
        one, state, tc, data = run("card")
        model = state.params
        n_params = sum(p.numel() for p in model.parameters())
        print(f"[recurrent] {cfg.name} {cfg.dtype}: {n_params} parameters, "
              f"AdamW (f32 moments), remat full, seq {REC_SEQ}, global "
              f"batch {REC_BATCH} in {REC_MICRO} microbatches, {REC_STEPS} "
              f"steps on the card in {one['wall_s']:.2f} s: losses "
              f"{[round(x, 6) for x in one['losses']]}; "
              f"{one['ms_per_step']:.1f} ms per step (median of steps 2-"
              f"{REC_STEPS}; each {[round(x) for x in one['step_ms']]} ms), "
              f"{REC_BATCH * REC_SEQ / one['ms_per_step'] * 1e3:.0f} "
              f"tokens/s; peak memory {one['peak_gb']:.2f} GB; on {card}")
        step = loop.make_step(cfg, tc, dev)
        toks, labels = next(data)
        batch = {"tokens": torch.as_tensor(toks, device=dev),
                 "labels": torch.as_tensor(labels, device=dev)}
        one.update(profiled_step(lambda: step(model, state.opt_state,
                                              state.comp_state, batch),
                                 state, one["ms_per_step"], "recurrent",
                                 card))
        del model, state, step, batch
        torch.cuda.empty_cache()

        on_grid, gstate, _, _ = run("grid", fsdp=True)
        check(all(isinstance(p, DTensor) for p in gstate.params.parameters()),
              "the grid run's parameters are not all DTensors")
        del gstate
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(REC_DIR, ignore_errors=True)
    got, want = np.array(on_grid["losses"]), np.array(one["losses"])
    rel = np.abs(got - want) / np.abs(want)
    ratio = on_grid["ms_per_step"] / one["ms_per_step"]
    print(f"[recurrent] {cfg.name} on a (1, 1) ('data', 'model') grid, NCCL "
          f"world of 1, FSDP, the recurrent forms on local shards; "
          f"{REC_STEPS} steps in {on_grid['wall_s']:.2f} s: losses "
          f"{[round(x, 6) for x in on_grid['losses']]}: largest relative "
          f"difference from the card's {rel.max():.3e} (rtol {G_RTOL}), "
          f"{'bitwise' if np.array_equal(got, want) else 'not bitwise'}; "
          f"{on_grid['ms_per_step']:.1f} ms per step (each "
          f"{[round(x) for x in on_grid['step_ms']]} ms) against the "
          f"card's {one['ms_per_step']:.1f} ({ratio:.3f}x); peak memory "
          f"{on_grid['peak_gb']:.2f} GB; on {card}")
    check(bool(np.allclose(got, want, rtol=G_RTOL, atol=0.0)),
          f"grid losses {got} differ from the card's {want}")
    return dict(n_params=n_params, card=one, grid=on_grid,
                loss_rel=rel.tolist(), ratio=ratio)


def recurrent_prefill(cfg, grid, counted, dev, card) -> dict:
    """Phase 14 (b): recurrentgemma-9b's published config (38 layers of
    RG-LRU, RG-LRU, local attention; d_model 4096, bf16, from a seeded
    generator on the card) prefilled through `make_prefill_step` at 1 x
    REC_PREFILL_SEQ tokens, plainly and on `grid`: the grid's last-position
    logits within rtol 5e-4 / atol 5e-5 of the plain ones, greedy next
    tokens equal. Ms of each (median of three). No CMAX kernel."""
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.models import make_prefill_step
    from repro_torch.models import transformer as tt
    from repro_torch.sharding import distribute_batch, distribute_model
    for fn in counted:
        fn.launches = 0
    model = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           max_len=REC_PREFILL_SEQ, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, REC_PREFILL_SEQ)), device=dev)

    def timed(step, m, b):
        times, out = [], None
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(m, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(times)), times

    plain, ms, each = timed(make_prefill_step(cfg), model,
                            {"tokens": toks})
    mesh = device_mesh(grid)
    distribute_model(model, mesh)
    b = distribute_batch({"tokens": toks}, mesh)
    gl, gms, geach = timed(make_prefill_step(cfg, mesh=mesh), model, b)
    gl = gl.full_tensor()
    launches = {fn.__name__: fn.launches for fn in counted}
    check(all(n == 0 for n in launches.values()),
          f"the recurrent prefill launched a CMAX kernel: {launches}")
    check(tuple(plain.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(plain).all()), "bad prefill logits")
    err = float((gl - plain).abs().max())
    bitwise = bool(torch.equal(gl, plain))
    same_tok = bool(torch.equal(gl.argmax(-1), plain.argmax(-1)))
    print(f"[recurrent] {cfg.name} {cfg.dtype}: {n_params} parameters, "
          f"prefill of 1 x {REC_PREFILL_SEQ} tokens: {ms:.1f} ms (each "
          f"{[round(x, 1) for x in each]}); on the (1, 1) grid "
          f"{gms:.1f} ms (each {[round(x, 1) for x in geach]}, "
          f"{gms / ms:.3f}x); last-position logits max abs difference "
          f"{err:.3e} ({'bitwise' if bitwise else 'not bitwise'}), greedy "
          f"next token equal {same_tok}; on {card}")
    check(bool(torch.allclose(gl, plain, rtol=G_RTOL, atol=G_ATOL)),
          f"grid prefill logits differ from the plain ones by {err}")
    check(same_tok, "greedy next tokens differ")
    del model
    torch.cuda.empty_cache()
    return dict(n_params=n_params, ms=ms, grid_ms=gms, ratio=gms / ms,
                max_abs_err=err, bitwise=bitwise)


def recurrent_phase(grid, counted, dev, card) -> dict:
    """Phase 14: the recurrent sequence forms at full width, on the card
    and on `grid` (13's world of one)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(REC_TRAIN)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size,
           cfg.dtype, cfg.block_pattern)
          == (48, 2048, 4, 50304, "bfloat16", ("mlstm", "slstm")),
          f"{REC_TRAIN} is not its published config")
    out = {"train": recurrent_train(cfg, grid, counted, dev, card)}
    torch.cuda.empty_cache()
    cfg = get_config(REC_PREFILL)
    check((cfg.n_layers, cfg.d_model, cfg.dtype, cfg.block_pattern)
          == (38, 4096, "bfloat16", ("rglru", "rglru", "local")),
          f"{REC_PREFILL} is not its published config")
    out["prefill"] = recurrent_prefill(cfg, grid, counted, dev, card)
    out["phase_s"] = time.perf_counter() - t0
    return out


DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "dryrun")
# [train]'s own cell on a fake (1, 1) mesh, as `launch.dryrun` runs a cell
DRYRUN_CELL = """
import json, sys
from pathlib import Path
from repro_torch.launch import dryrun
from repro_torch.models.model import ShapeSpec
seq, batch, micro, out = int(sys.argv[1]), int(sys.argv[2]), \\
    int(sys.argv[3]), sys.argv[4]
mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
shape = ShapeSpec("chip_train", seq, batch, "train")
rec = dryrun.run_cell("llama3.2-1b", shape.name, "1x1", Path(out),
                      force=True, mesh=mesh, shape=shape,
                      overrides={"microbatch": micro})
print(json.dumps({k: v for k, v in rec.items() if k != "traceback"}))
if rec["status"] != "ok":
    sys.exit(rec.get("traceback") or rec.get("error") or rec["status"])
"""


def cpu_subprocess(args) -> subprocess.Popen:
    """A Python subprocess on this checkout's `src`, no card (it sees
    none), its output captured."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = {**os.environ, "PYTHONPATH": src, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen([sys.executable, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, what: str, timeout: float = 600) -> str:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"chip_smoke: {what} ran past {timeout} s")
    check(proc.returncode == 0,
          f"{what} exited {proc.returncode}: {err[-3000:]}")
    return out


def roofline_phase(cfg, train, lm, timing, card) -> dict:
    """Phase 15: the roofline's machine balance against the card, the dry
    run of [train]'s cell against [train]'s measurements, the decode
    roofline beside [lm]'s step, [timing]'s kernel shares (through
    `roofline.kernel_roofline`) against a recount, and the dry-run and
    report CLIs (fake groups in CPU subprocesses, no card)."""
    t0 = time.perf_counter()
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    cell = cpu_subprocess(["-c", DRYRUN_CELL, str(TRAIN_SEQ),
                           str(TRAIN_BATCH), str(TRAIN_MICRO), DRYRUN_DIR])
    sweep = cpu_subprocess(["-m", "repro_torch.launch.dryrun", "--arch",
                            LM_ARCH, "--shape", "train_4k", "--mesh",
                            "single", "--out", DRYRUN_DIR, "--force"])
    try:
        return _roofline_checks(cfg, train, lm, timing, card, cell, sweep,
                                t0)
    finally:
        for proc in (cell, sweep):      # a failed check leaves none behind
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _roofline_checks(cfg, train, lm, timing, card, cell, sweep, t0):
    """`roofline_phase`'s checks, with its two subprocesses running."""
    from repro_torch import roofline as roof
    from repro_torch.configs import canonical
    from repro_torch.models.model import ShapeSpec
    hw = roof.default_hw()
    out = {}

    # (a) the machine balance's device memory against the card's
    total = torch.cuda.get_device_properties(0).total_memory
    out["hbm_per_chip"], out["total_memory"] = hw.hbm_per_chip, total
    check(abs(hw.hbm_per_chip - total) <= 0.02 * total,
          f"HW.hbm_per_chip {hw.hbm_per_chip:.0f} B is not within 2% of "
          f"the card's {total} B")
    print(f"[roofline] HW: {hw.peak_flops / 1e12:.0f} TFLOP/s bf16, "
          f"{hw.hbm_bw / 1e12:.2f} TB/s, link {hw.link_bw / 1e9:.0f} GB/s, "
          f"hbm_per_chip {hw.hbm_per_chip:.0f} B against the card's "
          f"total_memory {total} B ({hw.hbm_per_chip / total:.4f}); on "
          f"{card}")

    # (c) a decode step at [lm]'s size: batch 1, max_len 256
    dec = roof.roofline_terms(cfg, ShapeSpec("lm_decode", 256, 1, "decode"),
                              1, 0.0, hw)
    out["decode"] = dict(hbm_bytes=dec["hbm_bytes"], bound_ms=dec["bound_s"]
                         * 1e3, dominant=dec["dominant"],
                         pace_ms=lm["pace_ms"],
                         device_ms=lm.get("device_ms"))
    check(dec["dominant"] == "memory" and 0.6 < dec["bound_s"] * 1e3 < 0.9,
          f"decode roofline {dec['bound_s'] * 1e3:.3f} ms "
          f"({dec['dominant']}), not the 0.74 ms byte bound")
    print(f"[roofline] {cfg.name} decode at batch 1, max_len 256: "
          f"analytic {dec['hbm_bytes']:.4e} B, bound "
          f"{dec['bound_s'] * 1e3:.3f} ms ({dec['dominant']}) against [lm]'s "
          f"pace {lm['pace_ms']:.3f} ms a step (device "
          f"{lm.get('device_ms', float('nan')):.3f} ms): "
          f"{dec['bound_s'] * 1e3 / lm['pace_ms']:.4f} of the bound "
          f"reached; on {card}")

    # (d) [timing]'s shares (bounds through kernel_roofline) against a
    # recount from its printed counts: the larger of bytes over the HBM
    # rate and flops over the f32 peak, and which of the two it is
    shares = {}
    for name, rows in timing.items():
        for r in rows:
            for tag in ("", "_b1"):
                if f"ms{tag}" not in r:
                    continue
                t_bytes = r[f"bytes{tag}"] / hw.hbm_bw
                t_ops = r[f"flops{tag}"] / roof.F32_FLOPS
                want = max(t_bytes, t_ops) * 1e3 / r[f"ms{tag}"]
                got = r[f"bound_ms{tag}"] / r[f"ms{tag}"]
                by = "bytes" if t_bytes >= t_ops else "operations"
                check(abs(got - want) <= 1e-9 * want
                      and r[f"bound_by{tag}"] == by,
                      f"{name} s={r['scale']}{tag}: [timing]'s share {got} "
                      f"({r[f'bound_by{tag}']}) != the recount's {want} "
                      f"({by})")
                shares[f"{name} s={r['scale']}{tag}"] = got
    out["kernel_shares"] = shares
    print(f"[roofline] [timing]'s kernel_roofline shares equal the recount: "
          + ", ".join(f"{k} {100 * v:.2f}%" for k, v in shares.items())
          + f"; on {card}")

    # (b) [train]'s cell on a fake (1, 1) mesh against [train]
    rec = json.loads(finish(cell, "the dry run of [train]'s cell")
                     .strip().splitlines()[-1])
    check(rec["status"] == "ok", f"dry run of [train]'s cell: {rec}")
    measured = train["model_flops"] + train["remat_flops"]
    flops = rec["cost"]["flops"]
    mem = rec["memory"]["argument_size_in_bytes"] \
        + rec["memory"]["temp_size_in_bytes"]
    ratio = mem / (train["peak_gb"] * 1e9)
    shape = ShapeSpec("chip_train", TRAIN_SEQ, TRAIN_BATCH, "train")
    terms = roof.roofline_terms(cfg, shape, 1,
                                rec["collectives"].get("total", 0), hw)
    step_s = train["ms_per_step"] / 1e3
    out["train_cell"] = dict(
        flops=flops, measured_flops=measured, flops_ratio=flops / measured,
        args_bytes=rec["memory"]["argument_size_in_bytes"],
        temp_bytes=rec["memory"]["temp_size_in_bytes"],
        peak_bytes=train["peak_gb"] * 1e9, memory_ratio=ratio,
        bound_s=terms["bound_s"], dominant=terms["dominant"],
        mfu_upper=terms["mfu_upper"], step_s=step_s,
        bound_share=terms["bound_s"] / step_s, step_wall_s=rec["step_s"],
        torch_version=rec["torch_version"])
    print(f"[roofline] dry run of [train]'s cell ({cfg.name}, seq "
          f"{TRAIN_SEQ} x batch {TRAIN_BATCH} in {TRAIN_MICRO} microbatches, "
          f"AdamW, remat full, fake (1, 1) mesh, torch "
          f"{rec['torch_version']}, {rec['step_s']:.1f} s on the host): "
          f"flops {flops:.4e} against the step's model flops with remat "
          f"{measured:.4e} ({flops / measured:.4f}); args + temp "
          f"{mem / 1e9:.2f} GB against [train]'s peak {train['peak_gb']:.2f}"
          f" GB ({ratio:.4f}); roofline bound {terms['bound_s'] * 1e3:.1f} "
          f"ms ({terms['dominant']}), mfu_upper {terms['mfu_upper']:.4f}, "
          f"against {train['ms_per_step']:.1f} ms a step: "
          f"{terms['bound_s'] / step_s:.4f} of the bound reached; on {card}")
    check(abs(flops / measured - 1) <= 0.25,
          f"dry-run flops {flops:.4e} not within 25% of {measured:.4e}")
    check(0.5 <= ratio <= 2.0, f"dry-run memory / [train]'s peak {ratio}")

    # (e) the dry-run CLI on train_4k x single, then the report over it
    tag = f"{canonical(LM_ARCH)}__train_4k__single"
    text = finish(sweep, "launch.dryrun train_4k single")
    check(f"[ok]   {tag}" in text, f"launch.dryrun did not print {tag} ok: "
          f"{text[-2000:]}")
    rep = finish(cpu_subprocess(["-m", "repro_torch.roofline.report",
                                 "--dir", DRYRUN_DIR, "--mesh", "single"]),
                 "roofline.report")
    check(f"| {tag} | ok |" in rep, f"report: {rep[-2000:]}")
    rec = json.loads(open(os.path.join(DRYRUN_DIR, f"{tag}.json")).read())
    s = roof.summarize_cell(rec, hw)
    out["train_4k_single"] = dict(
        flops_per_dev=rec["cost"]["flops"],
        args_temp_gib=(rec["memory"]["argument_size_in_bytes"]
                       + rec["memory"]["temp_size_in_bytes"]) / 2**30,
        collective_bytes=rec["collectives"].get("total", 0),
        dominant=s["dominant"], fits=s["fits_hbm"], step_wall_s=rec["step_s"])
    print(f"[roofline] launch.dryrun {tag} ok ({rec['step_s']:.1f} s on the "
          f"host): {rec['cost']['flops']:.4e} flops/dev, args + temp "
          f"{out['train_4k_single']['args_temp_gib']:.2f} GiB/dev, "
          f"collectives {out['train_4k_single']['collective_bytes']:.4e} "
          f"B/dev, {s['dominant']}-bound, fits {s['fits_hbm']}; the report "
          f"renders it")
    for line in rep.splitlines():
        if tag in line:
            print(f"[roofline] report: {line}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[roofline] phase {out['phase_s']:.1f} s")
    return out


def serve_phase(cfg, seqs, counted, dev, card):
    """Phase 5: the serving layer on the card. Returns the launches of each
    kernel in its drain and the printed numbers."""
    from repro_torch.data import events
    from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                          AsyncDispatchExecutor,
                                          BatchedEstimationService,
                                          MonotonicClock)

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
    streams = serve_streams(seqs, STREAMS)
    n_win = sum(len(w) for w, _ in streams.values())

    wl = pass_counting(cfg=cfg, policy=policy, device=dev)
    ex = OverlapExecutor()
    svc = AsyncBatchedEstimationService(workload=wl, max_batch=8,
                                        max_in_flight=2,
                                        clock=MonotonicClock(), executor=ex)
    submit_all(svc, streams)
    for fn in counted:
        fn.launches = 0
    rs, wall = timed_drain(svc)
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
    submit_all(sync, streams)
    wl.passes = 0
    rs_sync, wall_sync = timed_drain(sync)
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
    wwl = pass_counting(cfg=wcfg, policy=policy, device=dev)
    wsvc = AsyncBatchedEstimationService(workload=wwl, max_batch=8,
                                         max_in_flight=2)
    few = {sid: (wins[:2], om_true) for sid, (wins, om_true)
           in list(streams.items())[:2]}
    submit_all(wsvc, few)
    for fn in counted:
        fn.launches = 0
    wrs, wwall = timed_drain(wsvc)
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


def host_hits(act, Hs, Ws) -> int:
    """The reference's `lax.scan` forward fill spelled as a host loop: the
    pending-merge hits of one window's active groups (scan order) over the
    4 tap lanes, each hit counting for the 4 channels."""
    Wb = (Ws + 1) // 2
    hits = 0
    for dy in (0, 1):
        for dx in (0, 1):
            carry = -2
            for g, a in enumerate(act):
                if a:
                    addr = ((g // Ws + dy) // 2) * Wb + (g % Ws + dx) // 2
                    hits += addr == carry
                    carry = addr
    return 4 * hits


def energy_phase(T, cfg, streams, res, card) -> dict:
    """Phase [energy]: `locality_stats` of every [main] window at every
    stage on the card, under that window's traced entry and exit omega."""
    from repro_torch.core import energy
    from repro_torch.costmodel import account_window, load_profile
    cam = cfg.camera
    counts = ("n_retained", "active_groups", "eff_updates", "naive_updates")
    shown = ("active_ratio", "outlier_ratio", "expected_update_ratio",
             "expected_reduction", "measured_reduction")
    stage_stats = {}                    # (s, k) -> per-stage account input
    means, card_s, calls, moved_events, differ = [], 0.0, 0, 0, 0
    above_one = 0
    for si, st in enumerate(cfg.stages):
        Hs, Ws = st.grid(cam)
        tr = res.stages[si]
        sums = dict.fromkeys(shown, 0.0)
        for s in range(STREAMS):
            for k in range(WINDOWS_PER_STREAM):
                w = streams.map(lambda a: a[s, k])
                om_s, om_n = tr.omega_entry[s, k], tr.omega_exit[s, k]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loc = energy.locality_stats(w, om_s, om_n, cam, st)
                torch.cuda.synchronize()
                card_s += time.perf_counter() - t0
                calls += 1
                check(all(v.device == w.device for v in loc.values()),
                      "locality_stats left the window's device")
                v = {key: t.item() for key, t in loc.items()}
                # the forward fill's hits against the host loop
                tables = T.sort_events(w, om_s, cam, st)
                p_now = torch.gather(T.warp_events(w, om_n, cam, st.scale)
                                     .p_act, -1, tables.perm)
                n_out = int((tables.retained
                             & (p_now != tables.p_ref)).sum())
                hits = (v["active_groups"] + n_out) * 16 - v["eff_updates"]
                want = host_hits(tables.act.tolist(), Hs, Ws)
                check(hits == want, f"s={st.scale} window {s}/{k}: pending "
                      f"hits {hits} != the host loop's {want}")
                # the reference's invariants. The expected update ratio,
                # (active groups + outliers) / retained, may pass 1, so it
                # is held to that formula on counts taken apart from
                # locality_stats; its two terms keep their [0, 1] bounds
                for key in ("active_ratio", "outlier_ratio"):
                    check(0.0 <= v[key] <= 1.0, f"{key} {v[key]}")
                n_act = int(tables.act.sum())
                n_ret = max(1, int(tables.retained.sum()))
                check(v["expected_update_ratio"]
                      == float(np.float32(n_act + n_out) / np.float32(n_ret)),
                      f"expected_update_ratio {v['expected_update_ratio']} "
                      f"!= ({n_act} + {n_out}) / {n_ret}")
                if v["expected_update_ratio"] > 1.0:
                    above_one += 1
                    print(f"[energy] s={st.scale} window {s}/{k}: expected "
                          f"update ratio {v['expected_update_ratio']!r} "
                          f"(active {v['active_ratio']!r} + outliers "
                          f"{v['outlier_ratio']!r}); omega entry "
                          f"{[float(x) for x in om_s.cpu()]}, exit "
                          f"{[float(x) for x in om_n.cpu()]}")
                check(v["measured_reduction"]
                      >= v["expected_reduction"] - 1e-6,
                      "the pending merge made the updates worse")
                check(v["eff_updates"] <= v["naive_updates"],
                      "eff_updates above naive_updates")
                same = energy.locality_stats(w, om_s, om_s, cam, st)
                check(same["outlier_ratio"].item() == 0.0,
                      "outliers with omega unchanged")
                # the same inputs through the port on the CPU
                wc = w.map(lambda a: a.cpu())
                cpu = energy.locality_stats(wc, om_s.cpu(), om_n.cpu(), cam,
                                            st)
                moved = sum(int((T.warp_events(w, om, cam, st.scale).p_act
                                 .cpu() != T.warp_events(
                                     wc, om.cpu(), cam, st.scale).p_act)
                                .sum()) for om in (om_s, om_n))
                moved_events += moved
                c = {key: int(cpu[key]) for key in counts}
                if moved == 0:
                    check(all(c[key] == v[key] for key in counts),
                          f"s={st.scale} window {s}/{k}: counts on the card "
                          f"{[v[key] for key in counts]} != on the CPU "
                          f"{[c[key] for key in counts]}")
                elif any(c[key] != v[key] for key in counts):
                    differ += 1
                    print(f"[energy] s={st.scale} window {s}/{k}: {moved} "
                          f"events warp to another pixel on the CPU; counts "
                          f"{counts} card {[v[key] for key in counts]}, CPU "
                          f"{[c[key] for key in counts]}")
                for key in shown:
                    sums[key] += v[key]
                stage_stats.setdefault((s, k), []).append(dict(
                    passes=float(tr.passes[s, k]),
                    n_retained=float(tr.n_retained[s, k]),
                    P=float(Hs * Ws), taps=st.blur_taps,
                    merge_reduction=v["measured_reduction"]))
        n = STREAMS * WINDOWS_PER_STREAM
        means.append({key: sums[key] / n for key in shown})
        print(f"[energy] s={st.scale} mean of {n} windows (Table 2): "
              + ", ".join(f"{key} {means[-1][key]:.4f}" for key in shown))
    print(f"[energy] {moved_events} events warp to another pixel on the CPU "
          f"than on the card (either warp, all windows and stages); "
          f"{differ} windows' counts differ because of them; the rest equal;"
          f" {above_one} window-stages with an expected update ratio above 1")
    hw = load_profile("paper_fpga_45nm")
    lat, acc, e = ([], []), ([], []), ([], [])
    for stats in stage_stats.values():
        for j, camel in enumerate((True, False)):
            a, en = account_window(stats, cfg, hw, camel=camel,
                                   n_total=N_EVENTS)
            lat[j].append(en["latency_s"])
            acc[j].append(a.total_accesses)
            e[j].append(en["e_total_uj"])
    red = {name: 100.0 * (np.mean(b) - np.mean(c)) / np.mean(b)
           for name, (c, b) in (("latency", lat), ("accesses", acc),
                                ("energy", e))}
    print(f"[energy] modelled FPGA figures (paper_fpga_45nm cost model on "
          f"these measured statistics; not times or energy of the card): "
          f"latency -{red['latency']:.1f}%, memory accesses "
          f"-{red['accesses']:.1f}%, energy -{red['energy']:.1f}% against "
          f"the baseline (paper: -53.3 / -42 / -52.2%)")
    print(f"[energy] locality_stats on the card: {1e3 * card_s / calls:.3f} "
          f"ms per call ({calls} calls), on {card}")
    return dict(means=means, reductions=red, ms=1e3 * card_s / calls)


def result_bitwise(a, b) -> bool:
    """omega and every stage's iterations, passes and v_final bit-equal."""
    return torch.equal(a.omega, b.omega) and all(
        torch.equal(x.iters, y.iters) and torch.equal(x.passes, y.passes)
        and torch.equal(x.v_final, y.v_final)
        for x, y in zip(a.stages, b.stages))


def grid_phase(T, cfg, streams, om_init, main_out, first, om_b, counted,
               dev, card) -> dict:
    """Phase [grid]: the sharded entry points on a one-entry grid and on
    two data-parallel entries that both name `dev` (cuda:0), against the
    local paths, bitwise."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    local_b = T.estimate_batch(first, om_b, cfg)
    torch.cuda.synchronize()
    walls = {"local batch": time.perf_counter() - t0}
    oms, res = main_out
    grids = {"1 entry": make_mesh((1, 1), ("data", "model"), devices=[dev]),
             f"2 entries on {dev}": make_mesh((2, 1), ("data", "model"),
                                              devices=[dev] * 2)}
    launches = {}
    for gname, g in grids.items():
        n = D._dp_extent(g)
        for kind, run, local in (
                ("batch", lambda: D.estimate_batch_sharded(
                    first, om_b, cfg, g), local_b),
                ("streams", lambda: D.estimate_streams_sharded(
                    streams, om_init, cfg, g), (oms, res))):
            for fn in counted:
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {fn.__name__: fn.launches for fn in counted}
            r, want = (out, local) if kind == "batch" else (out[1], local[1])
            if kind == "streams":
                check(torch.equal(out[0], local[0]), "streams omega differs")
            m = r.omega.shape[0] // n
            passes = shard_passes(r, n)
            key = f"{kind}, {gname}"
            walls[key] = wall
            launches[key] = got["megakernel_stats"]
            print(f"[grid] estimate_{kind}_sharded, {gname} ({n} shards of "
                  f"{m}): {wall:.3f} s; bitwise equal to the local path "
                  f"{result_bitwise(r, want)}; megakernel launches "
                  f"{got['megakernel_stats']}, the shards' lockstep passes "
                  f"{passes}; on {card}")
            check(result_bitwise(r, want),
                  f"{key}: differs from the local path")
            check(got["megakernel_stats"] == passes > 0,
                  f"{key}: launches {got} != shard passes {passes}")
            check(got["tile_accumulate"] == got["blur_stats_streaming"]
                  == 0, f"{key}: a per-window kernel was launched")
    print(f"[grid] local estimate_batch of {B_WINDOWS} windows: "
          f"{walls['local batch']:.3f} s")
    return dict(walls=walls, launches=launches)


def serve_grid_phase(cfg, seqs, counted, dev, card) -> dict:
    """Phase [serve-grid]: the [serve] harness at 2 streams x 4 windows
    under CmaxWorkload(mesh=two entries on `dev`, cuda:0)."""
    from repro_torch.data import events
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                          BatchedEstimationService)
    from repro_torch.serving import CmaxWorkload
    policy = events.pow2_policy(min_bucket=16384)
    grid = make_mesh((2, 1), ("data", "model"), devices=[dev] * 2)
    streams = serve_streams(seqs, 2)
    n_win = sum(len(w) for w, _ in streams.values())
    chain = CmaxWorkload(cfg, policy=policy, device=dev)
    want = {(sid, k): om for sid, (wins, om_true) in streams.items()
            for k, om in enumerate(serve_chain(chain, wins, om_true[0]))}
    out = {}
    for kind, make in (
            ("async", lambda wl: AsyncBatchedEstimationService(
                workload=wl, max_batch=8, max_in_flight=2)),
            ("sync", lambda wl: BatchedEstimationService(
                workload=wl, max_batch=8))):
        wl = pass_counting(cfg=cfg, policy=policy, mesh=grid)
        svc = make(wl)
        submit_all(svc, streams)
        for fn in counted:
            fn.launches = 0
        rs, wall = timed_drain(svc)
        mk = counted[0].launches
        if kind == "async":
            svc.executor.close()
        check(len(rs) == n_win and all(r.status == "ok" for r in rs),
              f"{kind}: {len(rs)} responses, statuses "
              f"{sorted({r.status for r in rs})}")
        for r in rs:
            check(np.array_equal(r.omega, want[(r.stream_id, r.seq)]),
                  f"{kind} grid omega of {r.stream_id}/{r.seq} differs from "
                  f"its batch-1 chain")
        classes = sorted({r.batch_b for r in rs})
        check(all(b % 2 == 0 for b in classes), f"batch classes {classes}")
        check(mk == wl.passes > 0, f"{kind}: megakernel launches {mk} != "
              f"the served batches' passes {wl.passes}")
        print(f"[serve-grid] {kind}: {n_win} windows (2 streams x "
              f"{WINDOWS_PER_STREAM}) under a grid of 2 entries on {dev}: "
              f"{wall:.3f} s, {n_win / wall:.2f} windows/s, batches "
              f"{svc.stats['batches']} of classes {classes}; every omega "
              f"bitwise equal to the batch-1 chain; megakernel launches {mk}"
              f" = the shards' passes; on {card}")
        out[kind] = dict(wall=wall, launches=mk, classes=classes)
    return out


def examples_phase(counted, device, card) -> dict:
    """Phase [examples]: torch_quickstart and torch_serve_batch at their
    default sizes on `device` (the card)."""
    import importlib.util
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for name in ("torch_quickstart", "torch_serve_batch"):
        path = os.path.join(root, "examples", f"{name}.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        err = mod.main(["--device", device])
        wall = time.perf_counter() - t0
        mk = counted[0].launches
        print(f"[examples] {name}: {wall:.3f} s, RMSE {err:.4f} rad/s, "
              f"megakernel launches {mk}; on {card}")
        check(err < 0.5, f"{name}: RMSE {err} >= 0.5 rad/s")
        check(mk > 0, f"{name} launched no kernel")
        out[name] = dict(wall=wall, rmse=err, launches=mk)
    return out


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
    from repro_torch import roofline as roof
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
            slot_ok &= bool(torch.equal(one.stats[0], out[i]))
            slot_ok &= bool(torch.equal(one.spilled,
                                        torch.zeros_like(one.spilled)))
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

    # ---- 6-9. Table 2 statistics, the device grid, served under a grid,
    # the examples ----
    energy_phase(T, cfg, streams, res, card)
    cuda0 = torch.device("cuda", 0)
    gridded = grid_phase(T, cfg, streams, om_init, (oms, res), first, om_b,
                         counted, cuda0, card)
    serve_grid_phase(cfg, seqs, counted, cuda0, card)
    examples_phase(counted, "cuda", card)

    # ---- 10. timing ----
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
        # what the function needs (`roofline.cuda_megakernel_costs`); the
        # sorted keys the kernel also reads are its own traffic, printed
        # apart and not in the bound
        costs = roof.cuda_megakernel_costs(live, B_WINDOWS, P, k)
        nbytes, flops = int(costs["hbm_bytes"]), int(costs["flops"])
        key_bytes = int(costs["key_bytes"])
        bound, bound_by = kernel_bound_ms(flops, nbytes)
        row = dict(scale=st.scale, k=k, ms=kern, plain_ms=plain,
                   prologue_ms=pro, bound_ms=bound, bound_by=bound_by,
                   bytes=nbytes, flops=flops, key_bytes=key_bytes)
        per_stage.append(row)
        print(f"[timing] s={st.scale} k={k} B={B_WINDOWS}: kernel "
              f"{kern * 1e3:.1f} us/pass, prologue {pro * 1e3:.1f} us/pass, "
              f"plain {plain * 1e3:.1f} us/pass, bound {bound * 1e3:.2f} us "
              f"({row['bound_by']}: {nbytes} B, {flops} flop) = "
              f"{100 * bound / kern:.2f}% of bound reached; the kernel also "
              f"reads {key_bytes} B of sorted keys "
              f"({key_bytes / roof.default_hw().hbm_bw * 1e6:.2f} us), on "
              f"{card}")

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
    kernels[0]["grid_launches"] = gridded["launches"]
    for kern in kernels:
        check(kern["launches"] > 0,
              f"{kern['name']} was launched no time on its path")

    # ---- 11. LM decode serving (no CMAX kernel on this path) ----
    from repro_torch.configs import get_config
    lm_cfg = get_config(LM_ARCH)
    check((lm_cfg.dtype, lm_cfg.n_layers, lm_cfg.d_model, lm_cfg.vocab_size)
          == ("bfloat16", 16, 2048, 128256),
          f"{LM_ARCH} is not its published config")
    lm, lm_model = lm_serve_phase(lm_cfg, counted, dev, card)
    lm.update(lm_step_timing(lm_model, dev, card))
    del lm_model
    torch.cuda.empty_cache()
    lm["f32_decode_vs_forward"] = lm_decode_vs_forward(
        dataclasses.replace(lm_cfg, dtype="float32"), dev, card)
    lm["smoke_card_vs_cpu"] = lm_smoke_configs(dev, card)
    print(f"[lm] {json.dumps(lm)}")
    print(f"[lm] ms per decode step: async {lm['async_ms_per_step']:.3f}, "
          f"sync {lm['sync_ms_per_step']:.3f}, one step's pace "
          f"{lm['pace_ms']:.3f} (before serving ran under inference mode: "
          f"31.9-32.4 ms a step on NVIDIA H100 80GB HBM3, 700.00 W); on "
          f"{card}")

    # ---- 12. single-card LM training (no CMAX kernel on this path) ----
    # a checkpoint left by an earlier run would be resumed from: start clean
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    t_train = time.perf_counter()
    train, train_model = train_full_width(lm_cfg, counted, dev, card)
    train["bf16_vs_f32"] = train_bf16_vs_f32(train_model, dev, card)
    del train_model
    torch.cuda.empty_cache()
    train["smoke_card_vs_cpu"] = train_smoke_configs(dev, card)
    train["subprocess_s"] = train_subprocesses(card)
    train["phase_s"] = time.perf_counter() - t_train
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"[train] {json.dumps(train)}")
    torch.cuda.empty_cache()

    # ---- 13-14. multi-device training on a world of 1, then the
    # recurrent forms on the card and on its grid (no CMAX kernel) ----
    with world_of_one(dev) as grid:
        t_dist = time.perf_counter()
        dist_out = train_dist_phase(lm_cfg, counted, dev, card, train, grid)
        dist_out["phase_s"] = time.perf_counter() - t_dist
        torch.cuda.empty_cache()
        recurrent = recurrent_phase(grid, counted, dev, card)
    dist_out["two_cards"] = dist_two_cards(train, card)
    print(f"[train-dist] {json.dumps(dist_out)}")
    print(f"[recurrent] {json.dumps(recurrent)}")
    torch.cuda.empty_cache()

    # ---- 15. the roofline and the dry run against the measurements ----
    roofline = roofline_phase(lm_cfg, train, lm, {
        "megakernel_stats": per_stage, "tile_accumulate": tile_rows,
        "blur_stats_streaming": blur_rows}, card)
    print(f"[roofline] {json.dumps(roofline)}")
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
