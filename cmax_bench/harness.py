"""One run of one cell: set-up, the measured window, the close, the
reference check and the result line.

The window drives `repro_torch.launch.serve.AsyncBatchedEstimationService`
over `CmaxWorkload` on the service's `MonotonicClock` and its threaded
`AsyncDispatchExecutor`: the benchmark submits host windows and calls
`poll` from its own load loop. Open-loop windows are timed from when they
were due; closed-loop streams keep their backlog full. After the close no
window is submitted; those due in the window are awaited (up to a minute)
and all answered windows are compared with the plain reference.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import check, spec, stats
from .gen import events as gen_events
from .gen import traffic as gen_traffic
from .reference import cmax as ref
from .roofline import work
from .trace import (BatchRecord, LayerData, StackSampler, breakdown,
                    busy_intervals, device_events, find_thread)

#: top-level modules that may not be loaded when the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
#: seconds the close waits for the windows due in the window
DRAIN_S = 60.0
#: seconds of whole batches the traced run profiles, ending at the close
SLICE_S = 4.0


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc output goes to `build/repro_torch_kernels/`)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")
    os.environ.setdefault("USE_FLAX", "0")


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m, mod in list(sys.modules.items())
                   if mod is not None} & set(FORBIDDEN))


def port_config(cfg: dict):
    """The port's `CmaxConfig` for a configuration file."""
    from repro_torch.core.types import Camera, CmaxConfig, StageConfig
    if cfg["precision"] != "float32":
        raise ValueError(f"precision {cfg['precision']!r}: the port serves "
                         "CMAX in float32")
    sched = cfg["schedule"]
    return CmaxConfig(
        camera=Camera(**cfg["sensor"]),
        stages=tuple(StageConfig(**st) for st in sched["stages"]),
        adaptive=sched["adaptive"], step_size=sched["step_size"],
        use_cgpr=sched["use_cgpr"], engine=cfg["engine"]["name"],
        engine_capacity=cfg["engine"]["capacity"],
        engine_rb=cfg["engine"]["rb"])


def make_workload(cfg, policy, device, tracing: bool,
                  breaker: Optional[Callable] = None):
    """`CmaxWorkload` as the service uses it. Traced, each batch is timed
    on the dispatch worker and its iterations and retained events read
    back after it; `breaker` (tests only) wraps the batch function."""
    import torch
    from repro_torch.serving.workload import CmaxWorkload

    class BenchWorkload(CmaxWorkload):
        def __init__(self):
            super().__init__(cfg, policy=policy, device=device)
            self.batches: Optional[List[BatchRecord]] = \
                [] if tracing else None
            self._real = collections.deque()

        def make_batch(self, payloads, states, bucket_n, batch_b):
            if self.batches is not None:
                self._real.append(len(payloads))
            return super().make_batch(payloads, states, bucket_n, batch_b)

        def executable(self, bucket_n, batch_b, **kw):
            fn = super().executable(bucket_n, batch_b, **kw)
            if breaker is not None:
                fn = breaker(fn)
            if self.batches is None:
                return fn

            def timed(w, o):
                n_real = self._real.popleft()
                t0 = time.time_ns()
                res = fn(w, o)
                if o.is_cuda:
                    torch.cuda.current_stream(o.device).synchronize()
                t1 = time.time_ns()
                it = torch.stack([st.iters for st in res.stages], -1)
                kept = torch.stack([st.n_retained for st in res.stages], -1)
                self.batches.append(BatchRecord(
                    t0, t1, n_real, it.cpu().tolist(), kept.cpu().tolist()))
                return res
            return timed

    return BenchWorkload()


@dataclasses.dataclass
class Streams:
    """The recorded windows of every stream, on the host."""

    x: list        # per stream (K, N) tensors
    y: list
    t: list
    p: list
    valid: list
    lengths: object            # (S, K) int64
    imu0: np.ndarray           # (S, 3) the IMU reading at each start
    truth: np.ndarray          # (S, K, 3)

    def window(self, s: int, k: int):
        n = int(self.lengths[s, k])
        return tuple(a[s][k, :n] for a in (self.x, self.y, self.t, self.p,
                                            self.valid))


def record_streams(cfg: dict, traffic: dict, seed: int, device) -> Streams:
    """Every stream's recording on the host. The recordings are the pool
    of the mix's `pool_seed`, the same for every run; the run's seed deals
    them to the streams and rotates each (the window a stream starts its
    first pass at): every seed offers the same set of windows in another
    order."""
    import torch
    sensor = gen_events.Sensor(**cfg["sensor"])
    scene = gen_events.Scene(**cfg["scene"])
    S, K = int(traffic["streams"]), int(traffic["recording_windows"])
    g = gen_events.generator(seed, S, "cpu")
    deal = torch.randperm(S, generator=g).tolist()
    turn = torch.randint(0, K, (S,), generator=g).tolist()
    cols = collections.defaultdict(list)
    imu0, truth = [], []
    for s in range(S):
        rec = gen_events.record(
            sensor, scene, K, cfg["events_per_window"],
            gen_events.generator(traffic["pool_seed"], deal[s], device),
            device)
        rec = type(rec)(*(torch.roll(a, -turn[s], dims=0) for a in rec))
        for f in ("x", "y", "t", "p", "valid"):
            cols[f].append(getattr(rec, f).cpu())
        imu0.append(rec.omega_imu[0].cpu().numpy())
        truth.append(rec.omega_true.cpu().numpy())
    lengths = gen_traffic.window_lengths(traffic, S, K)
    if int(lengths.max()) > cfg["events_per_window"]:
        raise ValueError("the mix asks for windows longer than recorded")
    del rec
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return Streams(**cols, lengths=lengths, imu0=np.stack(imu0),
                   truth=np.stack(truth))


def event_window(w):
    from repro_torch.core.types import EventWindow
    return EventWindow(*w)


def warm_up(svc, streams: Streams, traffic: dict, policy, max_batch: int):
    """One batch of every (length class, batch class) the mix can form,
    through the service, under streams of their own."""
    S, K = streams.lengths.shape
    by_class = collections.defaultdict(list)
    for s in range(S):
        for k in range(K):
            by_class[policy.bucket_of(int(streams.lengths[s, k]))].append(
                (s, k))
    if traffic["loop"] == "closed":
        sizes = [min(max_batch, S)]
    else:
        sizes, b = [], 1
        while b <= min(max_batch, S):
            sizes.append(b)
            b *= 2
    done = 0
    for bucket in sorted(by_class):
        for b in sizes:
            picks = by_class[bucket][:b]
            if len(picks) < b:
                continue
            for j, (s, k) in enumerate(picks):
                svc.submit(f"warm-{done}-{j}",
                           event_window(streams.window(s, k)),
                           omega_hint=streams.imu0[s])
            svc.drain()
            done += 1
    return done


@dataclasses.dataclass
class Request:
    stream: int
    seq: int
    k: int
    due: float
    warm_hint: Optional[np.ndarray]
    done: Optional[float] = None
    status: Optional[str] = None
    omega: Optional[np.ndarray] = None
    iters: tuple = ()


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        t_process: float, device=None, breaker=None, judge: bool = True,
        log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> dict:
    """One run; returns the result object. `device` and `breaker` are for
    the CPU tests, which skip the look for a card; the rate sweep runs
    with `judge` off (no reference)."""
    import torch
    from repro_torch.data import events as port_events
    from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                          MonotonicClock)
    from repro_torch.telemetry import Telemetry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"

    # ---- set-up ----
    t_phase = time.perf_counter()
    log(f"[setup] process start to the run: {t_phase - t_process:.3f} s")
    streams = record_streams(cfg, traffic, seed, dev)
    log(f"[setup] recordings: {time.perf_counter() - t_phase:.3f} s")
    t_phase = time.perf_counter()
    S, K = streams.lengths.shape
    svc_cfg = cfg["service"]
    policy = port_events.pow2_policy(min_bucket=svc_cfg["min_bucket"])
    wl = make_workload(port_config(cfg), policy, dev, trace, breaker)
    clock = MonotonicClock()
    tel = Telemetry(spans=trace)
    svc = AsyncBatchedEstimationService(
        workload=wl, max_batch=svc_cfg["max_batch"],
        max_in_flight=svc_cfg["max_in_flight"], clock=clock, telemetry=tel)
    n_warm = warm_up(svc, streams, traffic, policy, svc_cfg["max_batch"])
    log(f"[setup] warm-up: {time.perf_counter() - t_phase:.3f} s")
    prof = None
    if trace:
        # started and stopped while the dispatch worker is idle, never
        # under a running batch; only its slice is read
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
            if on_card else [torch.profiler.ProfilerActivity.CPU])
        prof.start()
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tel.tracer.drain()
    if wl.batches is not None:
        wl.batches.clear()

    # ---- the window ----
    closed = traffic["loop"] == "closed"
    offsets = None if closed else gen_traffic.arrival_offsets(traffic,
                                                              seconds)
    reqs: Dict[tuple, Request] = {}
    nxt = [0] * S                   # next arrival / window count per stream
    lag: List[float] = []
    sampler = None
    setup_s = time.perf_counter() - t_process
    t0 = clock.now()
    t_end = t0 + seconds
    t_slice = t_end - min(SLICE_S, seconds / 2)
    slice_ns = None

    def submit(s: int, due: float):
        i = nxt[s]
        nxt[s] += 1
        k = i % K
        hint = streams.imu0[s] if k == 0 else None
        seq = svc.submit(f"cam{s}", event_window(streams.window(s, k)),
                         omega_hint=hint)
        reqs[(s, seq)] = Request(s, seq, k, due, hint)

    def take(responses):
        for r in responses:
            q = reqs.get((int(r.stream_id[3:]), r.seq)) \
                if r.stream_id.startswith("cam") else None
            if q is None:
                continue
            q.done, q.status, q.omega, q.iters = (r.t_done, r.status,
                                                   r.omega, tuple(r.iters))
            if closed and clock.now() < t_end:
                submit(q.stream, clock.now())

    if closed:
        for s in range(S):
            for _ in range(int(traffic["outstanding"])):
                submit(s, t0)
    while True:
        now = clock.now()
        if now >= t_end:
            break
        if trace and slice_ns is None and now >= t_slice:
            worker = find_thread("repro_torch-dispatch")
            sampler = StackSampler(worker) if worker else None
            slice_ns = (time.time_ns(), 0)
            if sampler:
                sampler.start()
        busy = False
        if not closed:
            for s in range(S):
                while nxt[s] < len(offsets[s]) \
                        and t0 + float(offsets[s][nxt[s]]) <= now:
                    due = t0 + float(offsets[s][nxt[s]])
                    lag.append(now - due)
                    submit(s, due)
                    busy = True
        got = svc.poll()
        take(got)
        if not got and not busy:
            wait = 5e-4
            if not closed:
                pending = [t0 + float(offsets[s][nxt[s]]) for s in range(S)
                           if nxt[s] < len(offsets[s])]
                if pending:
                    wait = min(wait, max(0.0, min(pending) - now))
            time.sleep(wait)
    if slice_ns is not None:
        slice_ns = (slice_ns[0], time.time_ns())
        if sampler:
            sampler.stop()

    # ---- the close: await what was due ----
    deadline = t_end + DRAIN_S
    while any(q.status is None for q in reqs.values()) \
            and clock.now() < deadline:
        got = svc.poll()
        take(got)
        if not got:
            time.sleep(5e-4)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if prof is not None:
        if on_card:
            torch.cuda.synchronize(dev)
        prof.stop()
    ordered = sorted(reqs.values(), key=lambda q: q.due)
    open_at_close = sum(q.done is None or q.done > t_end for q in ordered)
    ok_done = [q.done for q in ordered if q.status == "ok"]
    per_s = stats.rate(ok_done, t0, t_end)
    lat = stats.latencies([q.due for q in ordered],
                          [q.done if q.status == "ok" else None
                           for q in ordered],
                          missing=deadline - t0)
    failed = sum(q.status != "ok" for q in ordered)
    fifths = [stats.rate(ok_done, t0 + i * seconds / 5,
                         t0 + (i + 1) * seconds / 5) for i in range(5)]
    log("[load] windows/s answered ok in each fifth of the window: "
        + ", ".join(f"{r:.3f}" for r in fifths))
    if lag:
        log(f"[load] generator lag over {len(lag)} arrivals: median "
            f"{1e3 * stats.percentile(lag, 50):.3f} ms, max "
            f"{1e3 * max(lag):.3f} ms")
    log(f"[load] {len(ordered)} windows due in {seconds} s, "
        f"{len(ok_done)} answered ok, {failed} failed, {open_at_close} "
        f"unanswered at the close; {n_warm} warm-up batches; set-up "
        f"{setup_s:.3f} s")

    end_to_end = {"windows_per_s": per_s,
                  "latency_p50_ms": 1e3 * stats.percentile(lat, 50),
                  "latency_p95_ms": 1e3 * stats.percentile(lat, 95),
                  "setup_s": setup_s}

    # ---- per-layer data (traced run) ----
    layer_data = None
    if trace:
        spans = tel.tracer.drain()
        t_read = time.perf_counter()
        every = device_events(prof, 0, 1 << 63) if on_card else []
        a, b = slice_ns
        layer_data = LayerData(
            config=cfg, window_batches=list(wl.batches),
            peak=work.peaks(torch.cuda.get_device_name(dev)
                            if on_card else "cpu"),
            slice_ns=slice_ns,
            device=[e for e in every if a <= e[0] < b],
            samples=sampler.samples if sampler else [],
            queue_waits=[sp.phases()["queue_wait"] for sp in spans
                         if sp.stream_id.startswith("cam")
                         and "queue_wait" in sp.phases()])
        log(f"[trace] {len(every)} device operations profiled over the "
            f"window, read in {time.perf_counter() - t_read:.3f} s; "
            f"{len(layer_data.device)} in the slice of {(b - a) / 1e9:.3f} "
            f"s; {len(layer_data.slice_batches())} of "
            f"{len(layer_data.window_batches)} batches wholly inside it; "
            f"{len(layer_data.samples)} stack samples")
    svc.executor.close()

    served = served_chain(ordered)
    out = dict(correct=None, attempted=len(ordered), failed=failed,
               end_to_end=end_to_end, layer_data=layer_data,
               memory_peak=memory_peak, compared={},
               open_at_close=open_at_close, served=served, streams=streams)
    if not judge:
        return out

    # ---- correctness: the reference, after the program's state is freed
    del svc, wl
    if on_card:
        torch.cuda.empty_cache()
    schedule = ref.Schedule.from_config(cfg)
    t_ref = time.perf_counter()
    answers = check.reference_answers(served, streams.window, schedule, dev)
    numbers = check.compare(served, answers, schedule)
    numbers["unanswered"] = float(failed)
    log(f"[check] widest gap {numbers.get('omega_gap_max', 0.0):.6g} rad/s, "
        "not compared")
    log(f"[check] reference over {len(answers)} distinct windows "
        f"({len(served)} answered) in {time.perf_counter() - t_ref:.3f} s; "
        f"RMSE of the served rates against the truth "
        f"{rmse(served, streams):.4f} rad/s")
    out["correct"], out["compared"] = check.verdict(
        numbers, cfg["correct"]["limits"])
    return out


def served_chain(ordered: List[Request]) -> List[check.Served]:
    """Every window answered ok, in each stream's order, with the warm
    start the service was bound to use: the IMU hint the benchmark gave,
    or the stream's previous answer."""
    served, warm = [], {}
    for q in sorted(ordered, key=lambda q: (q.stream, q.seq)):
        if q.status != "ok":
            continue
        w = q.warm_hint if q.warm_hint is not None else warm.get(q.stream)
        if w is None:
            raise RuntimeError(f"stream {q.stream}: no warm start known")
        served.append(check.Served(q.stream, q.k,
                                   np.asarray(w, np.float32),
                                   np.asarray(q.omega, np.float32),
                                   q.iters))
        warm[q.stream] = np.asarray(q.omega, np.float32)
    return served


def rmse(served, streams: Streams) -> float:
    if not served:
        return float("nan")
    err = [s.omega - streams.truth[s.stream, s.k] for s in served]
    return float(np.sqrt(np.mean(np.square(err))))


def result_line(cell: spec.Cell, out: dict, trace: bool, device_name: str,
                count: int) -> dict:
    """The last line of standard output."""
    if trace:
        data = out["layer_data"]
        readers = spec.layer_readers(cell)
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]](data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": {"platform": "gpu", "kind": device_name,
                       "count": count,
                       "memory_peak_bytes": out["memory_peak"]}}
    if trace:
        data = out["layer_data"]
        a, b = data.slice_ns or (0, 0)
        line["device"]["busy_s"] = sum(
            e - s for s, e in busy_intervals(data)) / 1e9
        line["device"]["window_s"] = (b - a) / 1e9
        line["breakdown"] = breakdown(data)
    line["compared"] = out["compared"]
    return line


def main(argv: List[str], t_process: float) -> int:
    ap = argparse.ArgumentParser(prog="cmax_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(spec.ROOT)
    cell = spec.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"cmax_bench: the cell needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              t_process=t_process)
    leaked = loaded_forbidden()
    if leaked:
        print(f"cmax_bench: modules loaded that the benchmark may not "
              f"load: {leaked}", file=sys.stderr)
        return 3
    for name, c in out["compared"].items():
        print(f"[correct] {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"[correct] {out['correct']}", file=sys.stderr, flush=True)
    line = result_line(cell, out, bool(args.trace),
                       torch.cuda.get_device_name(0), cell.chips)
    print(json.dumps(line), flush=True)
    return 0
