"""Run one benchmark cell traced and read the program's step spans and pass
counters against the device trace:

    python3 tools/cell_steps.py --workload <cell> --seed <n> [--seconds 51]

from the root of a checkout, on the card. The run is the cell's traced run
(`cmax_bench/harness.py::run` with `--trace 1`, the cell's traffic,
set-up and reference check), with the service's `Telemetry` kept so that
its step spans (`repro_torch.telemetry.STEP_SPANS`) and its registry can be
read after the run. Prints the traced run's result line, then on standard
error:

  * host microseconds per lockstep pass, by step name, over the batches
    that ran in the window (a step's whole time and its own time, less the
    steps under it);
  * `host_us_per_pass`: those batches' span time less their `stop_sync`
    time (where the host waits on the device), per lockstep pass: the
    denominator of `engine_device_us_per_pass`;
  * `slot_pass_share`: the window's change in
    `repro_serving_window_passes_total` over its change in
    `repro_serving_slot_passes_total` (what `useful_slot_share` reads from
    the benchmark's wrapper);
  * the residence loop's CUDA graphs over the window: the change in
    `repro_serving_graph_captures_total`, `..._graph_replays_total` (entry
    and pass) and `..._graph_eager_passes_total`, and `replay_share`,
    replays / (replays + eager passes), which reads 1.0 when every pass
    of the window replayed a graph;
  * the median and the largest `batch`, `make_batch` and `harvest` ms a
    batch;
  * the profiled slice's device idle time by the innermost step span that
    covers it ("no span" where none does), and the share of the slice's
    device time whose operations start inside a step span;
  * the five longest queue waits and what the dispatch worker ran during
    each.

and, last on standard output, one JSON object of those numbers.
"""
from __future__ import annotations

import argparse
import collections
import heapq
import json
import sys
import time
from bisect import bisect_right
from pathlib import Path

T_PROCESS = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def keep_telemetry():
    """Make the harness's `Telemetry` one that remembers itself, the
    registry at each drain of its request spans (the window's start and
    its close) and the spans drained."""
    import repro_torch.telemetry as tm

    class Kept(tm.Telemetry):
        made = []

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.marks, self.drained = [], []
            drain = self.tracer.drain

            def marked():
                self.marks.append((time.time_ns(), self.registry.snapshot()))
                out = drain()
                self.drained.extend(out)
                return out
            self.tracer.drain = marked
            Kept.made.append(self)

    tm.Telemetry = Kept
    return Kept


def merged(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_by_span(steps, device, a, b):
    """Idle device time in [a, b) by the innermost step span covering it."""
    busy = merged([(max(s, a), min(e, b)) for s, e, _ in device
                   if e > a and s < b])
    edges = [a] + [t for iv in busy for t in iv] + [b]
    gaps = [(lo, hi) for lo, hi in zip(edges[0::2], edges[1::2]) if hi > lo]
    depth = {}
    for sp in sorted(steps, key=lambda sp: sp.id):
        depth[sp.id] = 0 if sp.parent is None else depth.get(sp.parent, 0) + 1
    inside = [sp for sp in steps if sp.t1_ns > a and sp.t0_ns < b]
    cuts = sorted({t for lo, hi in gaps for t in (lo, hi)}
                  | {t for sp in inside for t in (sp.t0_ns, sp.t1_ns)
                     if a < t < b})
    starts = sorted(inside, key=lambda sp: sp.t0_ns)
    active, i, g = [], 0, 0
    out = collections.Counter()
    for lo, hi in zip(cuts, cuts[1:]):
        while i < len(starts) and starts[i].t0_ns <= lo:
            sp = starts[i]
            heapq.heappush(active, (-depth[sp.id], -sp.t0_ns, sp.id, sp))
            i += 1
        while g < len(gaps) and gaps[g][1] <= lo:
            g += 1
        if g == len(gaps) or not gaps[g][0] <= lo < gaps[g][1]:
            continue
        while active and active[0][3].t1_ns <= lo:
            heapq.heappop(active)
        # the heap's top, once ended spans are popped, is the deepest open
        # span (the latest started of its depth)
        out[active[0][3].name if active else "no span"] += (hi - lo) / 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/cell_steps.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)

    from cmax_bench import harness, spec
    harness.cache_dirs(spec.ROOT)
    cell = spec.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("cell_steps: no CUDA device")
        return 2
    print(json.dumps(measure(cell, args.seed, args.seconds)), flush=True)
    return 0


def measure(cell, seed: int, seconds: float, device=None) -> dict:
    """The cell's traced run and the numbers read from its step spans
    (`device` is for a rehearsal on the CPU, which has no device trace)."""
    import torch
    from cmax_bench import harness
    from repro_torch.telemetry import step_totals
    import repro_torch.telemetry as tm
    plain = tm.Telemetry
    Kept = keep_telemetry()
    mono_to_ns = time.time_ns() - time.monotonic_ns()
    try:
        out = harness.run(cell, seed, seconds, True, t_process=T_PROCESS,
                          device=device)
    finally:
        tm.Telemetry = plain
    line = harness.result_line(
        cell, out, True, torch.cuda.get_device_name(0)
        if torch.cuda.is_available() else "cpu", cell.chips)
    print(json.dumps(line), flush=True)
    tel = Kept.made[-1]
    data = out["layer_data"]
    a, b = data.slice_ns
    t_start = tel.marks[0][0]
    steps = tel.tracer.steps

    # ---- the window's batches ----
    by_batch = collections.defaultdict(list)
    for sp in steps:
        by_batch[sp.batch].append(sp)
    window = [bid for bid, sps in by_batch.items()
              for sp in sps if sp.name == "batch"
              and sp.t0_ns >= t_start and sp.t1_ns <= b]
    lockstep = lambda bid: sum(sp.name in ("entry_pass", "pass")
                               for sp in by_batch[bid])
    n_pass = sum(lockstep(bid) for bid in window)
    totals = step_totals([sp for bid in window for sp in by_batch[bid]])
    log(f"[steps] {len(window)} batches and {n_pass} lockstep passes in the "
        f"window; host us per lockstep pass by step (whole / own):")
    for name, d in totals.items():
        log(f"[steps]   {name}: {1e6 * d['total_s'] / n_pass:.1f} / "
            f"{1e6 * d['own_s'] / n_pass:.1f} ({d['count']} spans)")
    ms_per_batch = {}
    for name in ("batch", "make_batch", "harvest"):
        ms = sorted((sp.t1_ns - sp.t0_ns) / 1e6 for bid in window
                    for sp in by_batch[bid] if sp.name == name)
        if ms:
            ms_per_batch[name] = {"median": ms[len(ms) // 2], "max": ms[-1]}
            log(f"[steps] {name} ms per batch: median {ms[len(ms) // 2]:.2f},"
                f" max {ms[-1]:.2f}")
    early = [bid for bid, sps in by_batch.items()
             if any(sp.name == "batch" and sp.t1_ns <= t_start for sp in sps)]
    early_ms = sum((sp.t1_ns - sp.t0_ns) / 1e6 for bid in early
                   for sp in by_batch[bid] if sp.name == "batch")
    loads = ", ".join(f"{sp.attrs['kernel']} {sp.seconds:.3f} s (nvcc "
                      f"{sp.attrs.get('nvcc')})" for sp in steps
                      if sp.name == "kernel_load")
    log(f"[steps] set-up: {len(early)} batches, {early_ms:.1f} ms on the "
        f"worker; kernel loads: {loads or 'none'}")
    own = step_totals([sp for bid in early for sp in by_batch[bid]])
    log("[steps] set-up batches' own time by step (s): " + ", ".join(
        f"{n} {d['own_s']:.3f}" for n, d in sorted(
            own.items(), key=lambda kv: -kv[1]["own_s"])[:6]))
    host = sum(sp.t1_ns - sp.t0_ns for bid in window for sp in by_batch[bid]
               if sp.name == "batch") \
        - sum(sp.t1_ns - sp.t0_ns for bid in window for sp in by_batch[bid]
              if sp.name == "stop_sync")
    host_us = 1e6 * host / 1e9 / n_pass if n_pass else None

    # ---- the counters over the window ----
    (_, s0), (_, s1) = tel.marks[0], tel.marks[-1]
    delta = lambda k: (sum(s1.get(k, {}).values())
                       - sum(s0.get(k, {}).values()))
    slots = delta("repro_serving_slot_passes_total")
    slot_share = delta("repro_serving_window_passes_total") / slots \
        if slots else None
    graphs = {}
    for name in ("captures", "replays", "eager_passes"):
        key = f"repro_serving_graph_{name}_total"
        for lbl in sorted(set(s0.get(key, {})) | set(s1.get(key, {}))):
            d = s1.get(key, {}).get(lbl, 0) - s0.get(key, {}).get(lbl, 0)
            graphs[f"{name}{{{lbl}}}"] = d
    replays = delta("repro_serving_graph_replays_total")
    eager = delta("repro_serving_graph_eager_passes_total")
    replay_share = replays / (replays + eager) if replays + eager else None
    log(f"[steps] CUDA graphs over the window: "
        + (", ".join(f"{k} {v}" for k, v in graphs.items()) or "none")
        + f"; replay_share {replay_share}")

    # ---- the slice: idle by span, device time inside spans ----
    idle = idle_by_span(steps, data.device, a, b)
    log("[steps] device idle in the slice by innermost span (s): "
        + ", ".join(f"{n} {v:.4f}" for n, v in idle.most_common()))
    cover = merged([(sp.t0_ns, sp.t1_ns) for sp in steps
                    if sp.t1_ns > a and sp.t0_ns < b])
    starts = [s for s, _ in cover]
    inside = total = 0
    for s, e, _ in data.device:
        total += e - s
        j = bisect_right(starts, s) - 1
        if j >= 0 and s < cover[j][1]:
            inside += e - s
    in_span = inside / total if total else None
    log(f"[steps] share of the slice's device time starting inside a step "
        f"span: {in_span}")

    # ---- the longest queue waits ----
    waits = sorted(((sp.phases()["queue_wait"], sp) for sp in tel.drained
                    if sp.stream_id.startswith("cam")
                    and "queue_wait" in sp.phases()),
                   key=lambda w: -w[0])[:5]
    batches = [sp for sp in steps if sp.name == "batch"]
    for w, sp in waits:
        t = sp.times()
        lo = t["submit"] * 1e9 + mono_to_ns
        hi = t["admit"] * 1e9 + mono_to_ns
        ran = [bs for bs in batches if bs.t1_ns > lo and bs.t0_ns < hi]
        desc = "; ".join(
            f"batch {bs.batch}: {(bs.t1_ns - bs.t0_ns) / 1e6:.1f} ms, "
            f"{lockstep(bs.batch)} passes" for bs in ran)
        log(f"[steps] queue wait {1e3 * w:.1f} ms ({sp.stream_id} seq "
            f"{sp.seq}): {desc or 'no batch on the worker'}")

    return {"workload": cell.name, "seed": seed,
            "host_us_per_pass": host_us,
            "slot_pass_share": slot_share,
            "graphs": graphs, "replay_share": replay_share,
            "ms_per_batch": ms_per_batch,
            "useful_slot_share": line["metrics"].get(
                "useful_slot_share.replay", {}).get("value"),
            "device_time_in_spans": in_span,
            "idle_by_span_s": dict(idle.most_common()),
            "host_us_per_pass_by_step": {
                n: 1e6 * d["total_s"] / n_pass
                for n, d in totals.items()} if n_pass else {},
            "correct": line["correct"]}

if __name__ == "__main__":
    sys.exit(main())
