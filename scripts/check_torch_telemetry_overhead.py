#!/usr/bin/env python
"""Gate: the port's telemetry must be (nearly) free when on.

    PYTHONPATH=src python scripts/check_torch_telemetry_overhead.py
    PYTHONPATH=src python scripts/check_torch_telemetry_overhead.py \\
        --device cpu --streams 4 --events 2000 --rounds 2   # a rehearsal

The counterpart of `scripts/check_telemetry_overhead.py`'s real drain race
for the port: full telemetry (request spans, the batch path's step spans
and the decision log) against the default `Telemetry()` (registry only)
on a drain of the `davis240-batched` configuration
(`cmax_bench/configs/davis240-batched.json`: the paper's adaptive
schedule at 240x180 on the batched engine, batches of 8, 2 in flight) of
`--streams` streams x `--windows` windows of `--events` POSTER-like
events. The two services drain the same windows in alternating rounds in
one process; each side keeps its best round (windows/s). Fails (exit 1)
when spans cost more than MAX_OVERHEAD of the best drain rate. A round's
rate moves by up to a tenth from round to round on the card's host (the
drain is host-bound), so the best of many rounds is compared; the
medians are printed beside it.

It also prints, from the traced service's last round, the host time of
each step per lockstep pass and what one step span costs on and off (a
loop of empty spans), so an overhead over the bound names its step.
"""
import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

MAX_OVERHEAD = 0.05        # the reference gate's bound
CONFIG = ROOT / "cmax_bench" / "configs" / "davis240-batched.json"


def _streams(cfg: dict, args, device) -> dict:
    from repro_torch.core.types import Camera
    from repro_torch.data import events
    cam = Camera(**cfg["sensor"])
    out = {}
    for s in range(args.streams):
        spec = dataclasses.replace(
            events.POSTER, camera=cam, n_windows=args.windows,
            events_per_window=args.events, jerk_prob=0.0,
            n_features=cfg["scene"]["n_features"],
            seed=events.POSTER.seed + s)
        wins, _, om = events.make_sequence(spec, device=device)
        out[f"s{s}"] = ([events.window_slice(wins, k)
                         for k in range(args.windows)], om[0].cpu().numpy())
    return out


def _drain(svc, streams: dict) -> float:
    """One drain of every stream's windows from its IMU start; windows/s."""
    n = 0
    t0 = time.perf_counter()
    for sid, (wins, om0) in streams.items():
        for k, w in enumerate(wins):
            svc.submit(sid, w, omega_hint=om0 if k == 0 else None)
            n += 1
    rs = svc.drain()
    dt = time.perf_counter() - t0
    if len(rs) != n or any(r.status != "ok" for r in rs):
        raise RuntimeError("a window was not answered ok")
    return n / dt


def _span_cost(n: int = 200_000) -> tuple:
    """Seconds per `with step(...)` outside and inside a tracer's scope."""
    from repro_torch.telemetry import Tracer, step

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with step("pass"):
                pass
        return (time.perf_counter() - t0) / n

    off = loop()
    tr = Tracer()
    on = tr.batch(lambda: loop(), 0, {}, lambda out: out)()
    return off, on


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--events", type=int, default=40000)
    ap.add_argument("--rounds", type=int, default=25)
    args = ap.parse_args(argv)

    from cmax_bench.harness import port_config
    from repro_torch.data import events
    from repro_torch.launch.serve import AsyncBatchedEstimationService
    from repro_torch.serving import CmaxWorkload
    from repro_torch.telemetry import Telemetry, step_totals

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("check_torch_telemetry_overhead: no CUDA device",
              file=sys.stderr)
        return 2
    with open(CONFIG) as f:
        cfg = json.load(f)
    svc_cfg = cfg["service"]
    policy = events.pow2_policy(min_bucket=svc_cfg["min_bucket"])
    streams = _streams(cfg, args, dev)
    sides = {}
    for name, tel in (("off", Telemetry()),
                      ("on", Telemetry(spans=True, decisions=True))):
        sides[name] = AsyncBatchedEstimationService(
            workload=CmaxWorkload(port_config(cfg), policy=policy,
                                  device=dev),
            max_batch=svc_cfg["max_batch"],
            max_in_flight=svc_cfg["max_in_flight"], telemetry=tel)
    where = (f"{torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
             else "cpu")
    print(f"device: {where}; {args.streams} streams x {args.windows} "
          f"windows of {args.events} events; {args.rounds} rounds a side")
    for svc in sides.values():          # warm-up: every class, each kernel
        _drain(svc, streams)
    rates = {name: [] for name in sides}
    for r in range(args.rounds):
        order = ("off", "on") if r % 2 == 0 else ("on", "off")
        for name in order:
            tel = sides[name].telemetry      # each round keeps its own
            tel.tracer.drain()
            tel.tracer.drain_steps()
            tel.decisions.drain()
            rates[name].append(_drain(sides[name], streams))
    for svc in sides.values():
        svc.executor.close()

    steps = sides["on"].telemetry.tracer.steps
    totals = step_totals(steps)
    passes = sum(totals.get(n, {"count": 0})["count"]
                 for n in ("entry_pass", "pass"))
    print(f"host time per lockstep pass by step (last traced round, "
          f"{passes} passes, {len(steps)} step spans):")
    for name, d in totals.items():
        print(f"  {name}: {1e6 * d['total_s'] / max(passes, 1):.1f} us "
              f"(own {1e6 * d['own_s'] / max(passes, 1):.1f} us, "
              f"{d['count']} spans)")
    off_s, on_s = _span_cost()
    per_pass = len(steps) / max(passes, 1)
    print(f"one step span: {1e9 * off_s:.0f} ns off, {1e9 * on_s:.0f} ns "
          f"on; {per_pass:.1f} spans a lockstep pass -> "
          f"{1e6 * per_pass * on_s:.2f} us a pass when on")
    for name, rs in rates.items():
        print(f"{name:>3}: " + " ".join(f"{r:.2f}" for r in rs))
    best = {name: max(rs) for name, rs in rates.items()}
    med = {name: statistics.median(rs) for name, rs in rates.items()}
    print(f"medians: off={med['off']:.3f} on={med['on']:.3f} windows/s -> "
          f"{100 * (1.0 - med['on'] / med['off']):+.2f}%")
    overhead = 1.0 - best["on"] / best["off"]
    print(f"telemetry overhead [davis240-batched drain]: off="
          f"{best['off']:.3f} on={best['on']:.3f} windows/s -> "
          f"{100 * overhead:+.2f}% (bound {100 * MAX_OVERHEAD:.0f}%)")
    if overhead > MAX_OVERHEAD:
        print(f"telemetry gate: spans, step spans and decisions cost "
              f"{100 * overhead:.1f}% of the drain rate", file=sys.stderr)
        return 1
    print("telemetry overhead gate ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
