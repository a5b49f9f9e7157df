"""Where the time of the port's main path goes on one CUDA card.

    python3 tools/profile_main_path.py [--streams 8] [--events 40000]
                                       [--engine cuda_batched|cuda]

Runs `estimate_batch` (the paper's CONFIG, engine "cuda_batched" unless
`--engine` names another) on one batch of POSTER windows once to warm up,
then once under `torch.profiler`, and prints: the wall time, the device
busy time summed over the kernels (and copies) that ran on the card, the
device's idle share, the lockstep passes, the kernels that took the most
device time (in total and per lockstep pass), and the operators whose own
launches took the most. Then, per stage, it profiles `--reps` engine passes
of the same batch at the IMU warm start (prologue and kernels, as the
pipeline calls them) and prints each kernel's device time per pass (the top rows, and
the port's own kernels wherever they rank). Needs a CUDA card; imports no
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


#: the port's own kernels (csrc/): printed at every stage, in the top rows
#: or not
OWN_KERNELS = ("blur_stats_kernel", "tile_accumulate", "pack_events_kernel",
               "vote_kernel", "slab_stats_kernel", "part_sums_kernel")


def _on_device(evt) -> bool:
    """A kernel, copy or fill that ran on the card. An operator's row also
    carries the device time of the kernels it launched, so busy time sums
    these rows only (as PyTorch's own table does)."""
    return (evt.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--events", type=int, default=40000)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--engine", default="cuda_batched",
                    choices=("cuda_batched", "cuda"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device", file=sys.stderr)
        return 1

    import repro_torch.core as T
    from repro_torch.configs import cmax_camel
    from repro_torch.core.pipeline import (lockstep_passes,
                                           lockstep_stage_passes)
    from repro_torch.data import events

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    seqs = [events.make_sequence(dataclasses.replace(
        events.POSTER, n_windows=1, events_per_window=args.events,
        n_features=2500, jerk_prob=0.0, seed=events.POSTER.seed + s),
        device=dev) for s in range(args.streams)]
    wins = T.EventWindow(*[torch.cat([getattr(q[0], f) for q in seqs])
                           for f in ("x", "y", "t", "p", "valid")])
    om0 = torch.cat([q[2] for q in seqs])
    cfg = dataclasses.replace(cmax_camel.CONFIG, engine=args.engine)

    T.estimate_batch(wins, om0, cfg)                  # warm-up (and build)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = T.estimate_batch(wins, om0, cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    evts = [e for e in prof.key_averages() if _self_device_us(e) > 0]
    kernels = [e for e in evts if _on_device(e)]
    ops = [e for e in evts if not _on_device(e)]
    busy_us = sum(_self_device_us(e) for e in kernels)
    passes = lockstep_passes(res)
    per_stage = lockstep_stage_passes(res)
    print(f"[profile] estimate_batch B={args.streams} N={args.events} "
          f"240x180 {args.engine} on {card}: wall {wall_us:.0f} us, "
          f"{passes} lockstep passes {per_stage} per stage "
          f"({wall_us / passes:.0f} us/pass), device busy {busy_us:.0f} us "
          f"({busy_us / passes:.0f} us/pass), idle share "
          f"{1 - busy_us / wall_us:.3f}")
    for kind, rows in (("kernel", kernels), ("op", ops)):
        for e in sorted(rows, key=_self_device_us, reverse=True)[:args.top]:
            us = _self_device_us(e)
            print(f"[profile] {kind:6s} {us:10.0f} us {us / passes:8.1f} "
                  f"us/pass {e.count:6d} calls  {e.key[:80]}")
    for st in cfg.stages:
        stage_breakdown(T, cfg, st, wins, om0, args, card)
    return 0


def stage_breakdown(T, cfg, st, wins, om0, args, card) -> None:
    """Device time per engine pass of each kernel at one stage."""
    from repro_torch.kernels import ops
    cam = cfg.camera
    weights = T.sort_events(wins, om0, cam, st).weights
    fir = T.gaussian_taps(st.blur_taps, st.blur_sigma, device=om0.device)
    if cfg.engine == "cuda_batched":
        def engine_pass():
            ops.batched_engine_stats(wins, om0, cam, st.scale, st.blur_taps,
                                     st.blur_sigma, weights=weights,
                                     rb=cfg.engine_rb, fir=fir)
    else:
        def engine_pass():
            ops.fused_engine_pass(wins, om0, cam, st.scale, st.blur_taps,
                                  st.blur_sigma, weights=weights,
                                  capacity=cfg.engine_capacity, fir=fir)
    for _ in range(3):
        engine_pass()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.reps):
            engine_pass()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if _on_device(e) and _self_device_us(e) > 0]
    busy = sum(_self_device_us(e) for e in rows) / args.reps
    print(f"[stage] s={st.scale} k={st.blur_taps} B={wins.x.shape[0]} "
          f"{cfg.engine} on {card}: device {busy:.1f} us per engine pass")
    ranked = sorted(rows, key=_self_device_us, reverse=True)
    shown = ranked[:args.top] + [e for e in ranked[args.top:] if any(
        name in e.key for name in OWN_KERNELS)]
    for e in shown:
        print(f"[stage]   {_self_device_us(e) / args.reps:9.1f} us/pass "
              f"{e.count // args.reps:4d} launches/pass  {e.key[:80]}")


if __name__ == "__main__":
    sys.exit(main())
