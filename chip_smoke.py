"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version at the main path's full shapes,
drives the main path (batched, warm-started CMAX estimation through
`estimate_streams`) at the paper's size, and times the kernels. Phases:

  1. device     the card's name, capability (must be 9.0), power limit;
  2. kernels    each kernel against its plain version at every stage's
                shapes (B=8 POSTER windows of 40,000 events, 2,500
                features): variance rtol=1e-4, max-normalized gradient
                atol=1e-4, bitwise equal on a rerun, and each window's
                B=1 result bitwise equal to its slot of the B=8 batch;
  3. main path  estimate_streams on 8 streams x 4 windows at 240x180 with
                engine="cuda_batched": launch counts equal the lockstep
                engine passes, and the first window of each stream agrees
                with the port's `reference` engine on the card (omega
                atol=5e-4, v_final rtol=1e-3);
  4. timing     each kernel's time per launch (CUDA events), the binning
                prologue's and the plain version's, against the bound set by
                the bytes and operations the kernel needs.

The second-to-last line is the `kernels` JSON object and the last line is
{"ok": true, "device": {...}}. Any failed phase raises and the script exits
non-zero without that line. It needs no network, imports no JAX, and exits
non-zero without a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import os
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call of `fn` from CUDA events over `reps` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rmse(est: np.ndarray, ref: np.ndarray) -> float:
    e = np.linalg.norm(est - ref, axis=-1)
    return float(np.sqrt((e ** 2).mean()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import repro_torch.core as T
    from repro_torch.configs import cmax_camel
    from repro_torch.core.pipeline import lockstep_passes
    from repro_torch.data import events
    from repro_torch.kernels import _build, megakernel, ops

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
    for kname, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {kname}: {line.strip()}")

    cfg = cmax_camel.CONFIG
    check(cfg.engine == "cuda_batched", "CONFIG does not use cuda_batched")
    cam = cfg.camera
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

    # ---- 3. the main path ----
    megakernel.megakernel_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oms, res = T.estimate_streams(streams, om_init, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = megakernel.megakernel_stats.launches
    passes = lockstep_passes(res)
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
          f"kernel launches {launches}")
    check(launches > 0, "the main path launched no kernel")
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

    # ---- 4. timing ----
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
                                           st.scale), reps=20)
        # bytes the function needs: x, y, dt, pw of the events with live
        # taps, each live record, the CSR offsets, omega, taps, the output
        nbytes = (live // 4) * 16 + live * 4 + B_WINDOWS * (P + 1) * 4 \
            + B_WINDOWS * 12 + k * 4 + B_WINDOWS * 32
        flops = live * TAP_FLOPS + B_WINDOWS * P * (16 * k + 12)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        row = dict(scale=st.scale, k=k, ms=kern, plain_ms=plain,
                   prologue_ms=pro, bound_ms=bound,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, flops=flops)
        per_stage.append(row)
        print(f"[timing] s={st.scale} k={k} B={B_WINDOWS}: kernel "
              f"{kern * 1e3:.1f} us/pass, prologue {pro * 1e3:.1f} us/pass, "
              f"plain {plain * 1e3:.1f} us/pass, bound {bound * 1e3:.2f} us "
              f"({row['bound_by']}: {nbytes} B, {flops} flop) = "
              f"{100 * bound / kern:.2f}% of bound reached, on {card}")

    full = per_stage[-1]
    kernels = [dict(
        name="megakernel_stats", route="cuda",
        source="src/repro_torch/kernels/csrc/megakernel.cu",
        replaces="src/repro/kernels/megakernel.py:184",
        launches=launches, max_abs_err=max_abs_err, ms=full["ms"],
        plain_ms=full["plain_ms"], bound_ms=full["bound_ms"],
        bound_by=full["bound_by"], library_ms=None,
        at=f"s=1 stage, B={B_WINDOWS}, N={N_EVENTS}", per_stage=per_stage)]
    print(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
