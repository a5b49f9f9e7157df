"""What a traced run (`--trace 1`) records, and the reductions every
per-layer metric reads from it.

A traced run keeps the program's own spans (`Telemetry(spans=True)`) over
the whole window, times each batch on the dispatch worker (host
nanoseconds before the batch function and after its stream has
finished), and in a bounded slice at the end of the window runs
`torch.profiler` over the device only, while a sampler reads the
dispatch worker's Python stack every millisecond. Device operations are
summed from the profiler's raw events, each with its start and end on the
host's clock: `key_averages` would take minutes where a run launches
hundreds of thousands of kernels.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

Interval = Tuple[int, int]


@dataclasses.dataclass
class BatchRecord:
    """One batch as the dispatch worker ran it."""

    t0_ns: int                 # host clock, before the batch function
    t1_ns: int                 # after the batch's stream finished
    n_real: int                # windows in the batch (the rest are fill)
    iters: List[List[int]]     # (batch_b, stages) iterations per slot
    retained: List[List[int]]  # (batch_b, stages) events kept by Alg. 3

    @property
    def batch_b(self) -> int:
        return len(self.iters)

    def lockstep_passes(self) -> int:
        """Engine passes the batch ran: per stage the entry pass plus the
        iterations of its slowest slot."""
        return sum(1 + max(col) for col in zip(*self.iters))

    def own_passes(self) -> int:
        """Engine passes its windows needed, each on its own."""
        return sum(1 + it for row in self.iters[:self.n_real] for it in row)


@dataclasses.dataclass
class LayerData:
    """Everything a per-layer metric's reader may read."""

    config: dict
    peak: Optional[dict]                  # the card's row of the peaks table
    window_batches: List[BatchRecord]     # every batch of the window
    slice_ns: Optional[Interval] = None   # the profiled slice
    device: List[Tuple[int, int, str]] = dataclasses.field(
        default_factory=list)             # device operations in the slice
    samples: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    queue_waits: List[float] = dataclasses.field(default_factory=list)

    def slice_batches(self) -> List[BatchRecord]:
        """Batches that ran wholly inside the profiled slice."""
        if self.slice_ns is None:
            return []
        a, b = self.slice_ns
        return [r for r in self.window_batches
                if a <= r.t0_ns and r.t1_ns <= b]

    def device_s(self, rec: BatchRecord) -> float:
        """Device seconds of the operations that started in a batch."""
        return sum(e - s for s, e, _ in self.device
                   if rec.t0_ns <= s < rec.t1_ns) / 1e9


def merge(intervals: List[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: List[Interval], b: List[Interval]) -> int:
    """Total length of the intersection of two merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_events(prof, start_ns: int, end_ns: int
                  ) -> List[Tuple[int, int, str]]:
    """(start, end, name) of every kernel, copy and fill the profiler saw
    on the card between start_ns and end_ns (its raw events; user
    annotations mirrored onto the device are left out)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or (annotation and annotation()) or e.duration_ns() <= 0:
            continue
        s = e.start_ns()
        if start_ns <= s < end_ns:
            out.append((s, s + e.duration_ns(), e.name()))
    return out


class StackSampler:
    """Samples one thread's Python stack every `period` seconds: the
    innermost frame of the port (`repro_torch`), as file:function:line,
    or what the thread waits in where it is outside the port."""

    def __init__(self, thread: threading.Thread, period: float = 1e-3):
        self.ident = thread.ident
        self.period = period
        self.samples: List[Tuple[int, str]] = []
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, daemon=True,
                                    name="cmax_bench-sampler")

    @staticmethod
    def label(frame) -> str:
        inner = None
        f = frame
        while f is not None:
            path = f.f_code.co_filename.replace("\\", "/")
            if "/repro_torch/" in path:
                rel = path.split("/repro_torch/", 1)[1]
                return f"{rel}:{f.f_code.co_name}:{f.f_lineno}"
            inner = inner or f"{path.rsplit('/', 1)[-1]}:{f.f_code.co_name}"
            f = f.f_back
        return f"outside the port: {inner}"

    def _run(self):
        while not self._stop.wait(self.period):
            frame = sys._current_frames().get(self.ident)
            if frame is not None:
                self.samples.append((time.time_ns(), self.label(frame)))

    def start(self):
        self._th.start()

    def stop(self):
        self._stop.set()
        self._th.join(timeout=10)


def find_thread(prefix: str) -> Optional[threading.Thread]:
    for th in threading.enumerate():
        if th.name.startswith(prefix):
            return th
    return None


def busy_intervals(data: LayerData) -> List[Interval]:
    return merge([(s, e) for s, e, _ in data.device])


def breakdown(data: LayerData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the slice, and the
    idle time between them, summed by what the dispatch worker was doing
    (the sampler's label nearest the middle of each gap)."""
    by_op: Counter = Counter()
    for s, e, name in data.device:
        by_op[name] += (e - s) / 1e9
    gaps: Counter = Counter()
    if data.slice_ns is not None:
        a, b = data.slice_ns
        edges = [a] + [t for iv in busy_intervals(data) for t in iv] + [b]
        times = [t for t, _ in data.samples]
        import bisect
        for lo, hi in zip(edges[0::2], edges[1::2]):
            if hi <= lo:
                continue
            label = "no sample"
            if times:
                i = bisect.bisect_left(times, (lo + hi) // 2)
                near = [j for j in (i - 1, i) if 0 <= j < len(times)]
                j = min(near, key=lambda j: abs(times[j] - (lo + hi) // 2))
                label = data.samples[j][1]
            gaps[label] += (hi - lo) / 1e9
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
