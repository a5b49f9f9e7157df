"""Per-request span tracing through the serving scheduler state machine
(counterpart of `repro.telemetry.spans`).

One `Span` follows one `WindowRequest` through the lifecycle the services
implement (DESIGN.md §6):

    submit ──> admit (batch assembly) ──> dispatch ──> harvest
       │                                                  (status ok)
       └──────────────────────────> shed  (deadline)  or
       └──> shed at submit          (strict budget refusal, "refused")

Every timestamp comes from the *service clock* — the same injectable
`Clock` the scheduler itself runs on — so FakeClock/ManualExecutor tests
and the virtual-time load generator produce bit-identical traces, and a
span's phase decomposition telescopes exactly onto the response latency:

    queue_wait (submit→admit) + assemble (admit→dispatch)
        + execute (dispatch→harvest)  ==  t_done - t_submit

The tracer is the *optional* half of the telemetry layer: the default
service runs a `NullTracer` (every method a no-op, nothing retained), so
tracing costs nothing unless a caller opts in (`Telemetry(spans=True)`,
or the `--trace-out` serving flag).

The same tracer records *step spans*: what the host does for one batch,
from the service's `make_batch` through the worker's stages, lockstep
passes and kernels to the `harvest` (`STEP_SPANS`). The service runs the
batch function under the tracer's scope (`Tracer.batch`), on whatever
thread the executor runs it; the pipeline and the kernel wrappers open
their spans with `step`, which under no scope returns one shared no-op.
Step spans are stamped in host nanoseconds on `time.time_ns`, the clock
the profiler stamps device events on, so a span can be laid against the
device's work; a service on a `FakeClock` stamps them on its virtual
time instead (`Telemetry.bind_clock`), so its traces stay deterministic.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

#: canonical lifecycle event names, in order of occurrence
SPAN_EVENTS = ("submit", "admit", "dispatch", "harvest", "shed")

#: canonical keys of a serialized span (the cross-workload schema pinned
#: by tests/test_workload_conformance.py)
SPAN_FIELDS = ("type", "stream_id", "seq", "qos", "bucket_n", "batch_b",
               "status", "compile", "iters", "events", "phases",
               "latency_s")

#: the step spans of the batch path, outermost first: on the service's
#: thread `make_batch` and `harvest`; under the worker's `batch`, one
#: `stage` per stage holding `sort`, `entry_pass` and one `pass` per
#: lockstep iteration, each pass holding `propose`, `engine`, `select`
#: and `stop_sync` (the one read that waits on the device); under
#: `engine` the kernels' steps (`bin_taps`, `megakernel` on the batched
#: engine; `pack_tiles`, `tile_accumulate`, `blur_stats` on the
#: per-window one); `kernel_load` where a kernel library is first
#: loaded (built with nvcc or not, its `nvcc` attribute says); `capture`
#: where a stage's CUDA graphs are captured (`core.graphs`), after the
#: class's first run: on a card a stage's entry pass and passes are then
#: replays, with `stop_sync` their only step
STEP_SPANS = ("make_batch", "harvest", "batch", "stage", "sort",
              "entry_pass", "pass", "propose", "engine", "bin_taps",
              "megakernel", "pack_tiles", "tile_accumulate", "blur_stats",
              "select", "stop_sync", "kernel_load", "capture")

#: canonical keys of a serialized step span
STEP_FIELDS = ("type", "id", "name", "parent", "batch", "t0_ns", "t1_ns",
               "attrs")


class Span:
    """One request's lifecycle: identity, shape classes, outcome, and the
    ordered (event, clock-time) list the phases derive from."""

    __slots__ = ("stream_id", "seq", "qos", "bucket_n", "batch_b",
                 "status", "compile", "iters", "events")

    def __init__(self, stream_id: str, seq: int, qos: str, bucket_n: int,
                 t_submit: float):
        self.stream_id = stream_id
        self.seq = seq
        self.qos = qos
        self.bucket_n = bucket_n
        self.batch_b = 0
        self.status: Optional[str] = None       # set at finish
        self.compile: Optional[bool] = None     # set at dispatch
        self.iters: Tuple[int, ...] = ()
        self.events: List[Tuple[str, float]] = [("submit", t_submit)]

    # -- derived views -------------------------------------------------------

    def times(self) -> Dict[str, float]:
        """First occurrence time of each event."""
        t: Dict[str, float] = {}
        for name, tt in self.events:
            t.setdefault(name, tt)
        return t

    @property
    def latency_s(self) -> float:
        return self.events[-1][1] - self.events[0][1]

    def phases(self) -> Dict[str, float]:
        """Durations between consecutive lifecycle events. Only phases
        whose endpoints were recorded appear; the differences telescope,
        so sum(phases.values()) equals latency_s up to one float rounding
        per phase (bit-exact whenever the clock values subtract exactly,
        as the virtual-time clocks in tests do)."""
        t = self.times()
        ph: Dict[str, float] = {}
        if "shed" in t:
            ph["queue_wait"] = t["shed"] - t["submit"]
            return ph
        if "admit" in t:
            ph["queue_wait"] = t["admit"] - t["submit"]
            if "dispatch" in t:
                ph["assemble"] = t["dispatch"] - t["admit"]
                if "harvest" in t:
                    ph["execute"] = t["harvest"] - t["dispatch"]
        return ph

    def to_dict(self) -> dict:
        return {"type": "span", "stream_id": self.stream_id,
                "seq": self.seq, "qos": self.qos,
                "bucket_n": self.bucket_n, "batch_b": self.batch_b,
                "status": self.status, "compile": self.compile,
                "iters": list(self.iters),
                "events": [[n, t] for n, t in self.events],
                "phases": self.phases(), "latency_s": self.latency_s}


class StepSpan:
    """One step of the batch path: its name, host nanoseconds at its start
    and end, the id of the span it ran under (None at the top) and the
    id of the batch it belongs to."""

    __slots__ = ("id", "name", "parent", "batch", "t0_ns", "t1_ns",
                 "attrs")

    def __init__(self, id_: int, name: str, parent: Optional[int],
                 batch: Optional[int], t0_ns: int, attrs: dict):
        self.id = id_
        self.name = name
        self.parent = parent
        self.batch = batch
        self.t0_ns = t0_ns
        self.t1_ns = t0_ns
        self.attrs = attrs

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def to_dict(self) -> dict:
        return {"type": "step", "id": self.id, "name": self.name,
                "parent": self.parent, "batch": self.batch,
                "t0_ns": self.t0_ns, "t1_ns": self.t1_ns,
                "attrs": dict(self.attrs)}


class _OpenStep:
    """An open step span: `with` ends it and files it with its tracer."""

    __slots__ = ("tracer", "span", "stack")

    def __init__(self, tracer: "Tracer", span: StepSpan, stack: list):
        self.tracer = tracer
        self.span = span
        self.stack = stack

    def __enter__(self) -> StepSpan:
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.t1_ns = self.tracer.step_ns()
        self.stack.pop()
        self.tracer.steps.append(self.span)
        return False


class _NoStep:
    """The step span under no tracer: a shared no-op (`with` gives None)."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_STEP = _NoStep()


class _Scope(threading.local):
    """The tracer whose scope the running thread is in (`Tracer.batch`),
    the ids of its open step spans and the batch they belong to; None
    outside a scope (class defaults, so the no-op path raises nothing)."""

    tracer = None
    stack = None
    batch = None


_scope = _Scope()


def step(name: str, **attrs):
    """A step span of the batch path, to be used as ``with step(name):``,
    under the tracer whose scope this thread is in; the shared no-op
    where there is none. `name` is one of `STEP_SPANS`."""
    tracer = _scope.tracer
    if tracer is None:
        return _NO_STEP
    return tracer._open_step(name, _scope.stack, _scope.batch, attrs)


class Tracer:
    """Collects spans keyed by (stream_id, seq) — unique per service,
    since seq numbers are per-stream monotone. The serving loop passes
    explicit timestamps (`t=`) where it already read the clock, so a
    span never sees a different time than the response it describes.

    Also collects the batch path's step spans (`steps`, in the order they
    end), stamped by `step_ns`."""

    enabled = True

    def __init__(self, clock=None):
        self.clock = clock
        self._open: Dict[Tuple[str, int], Span] = {}
        self.spans: List[Span] = []
        self.step_ns: Callable[[], int] = time.time_ns
        self.steps: List[StepSpan] = []
        self._ids = itertools.count()

    def _now(self, t: Optional[float]) -> float:
        return self.clock.now() if t is None else t

    def start(self, stream_id: str, seq: int, qos: str = "standard",
              bucket_n: int = 0, t: Optional[float] = None) -> None:
        self._open[(stream_id, seq)] = Span(stream_id, seq, qos, bucket_n,
                                            self._now(t))

    def mark(self, stream_id: str, seq: int, event: str,
             t: Optional[float] = None, batch_b: Optional[int] = None,
             compile: Optional[bool] = None) -> None:
        sp = self._open.get((stream_id, seq))
        if sp is None:
            return
        sp.events.append((event, self._now(t)))
        if batch_b is not None:
            sp.batch_b = batch_b
        if compile is not None:
            sp.compile = compile

    def finish(self, stream_id: str, seq: int, event: str, status: str,
               iters: Tuple[int, ...] = (),
               t: Optional[float] = None) -> None:
        sp = self._open.pop((stream_id, seq), None)
        if sp is None:
            return
        sp.events.append((event, self._now(t)))
        sp.status = status
        sp.iters = tuple(iters)
        self.spans.append(sp)

    def drain(self) -> List[Span]:
        """Hand over (and forget) the completed spans — long-running
        services call this periodically so the trace buffer is bounded
        by the export cadence, not the service lifetime."""
        out, self.spans = self.spans, []
        return out

    # -- step spans ------------------------------------------------------------

    def _open_step(self, name: str, stack: list, batch: Optional[int],
                   attrs: dict) -> _OpenStep:
        sp = StepSpan(next(self._ids), name, stack[-1] if stack else None,
                      batch, self.step_ns(), attrs)
        stack.append(sp.id)
        return _OpenStep(self, sp, stack)

    def step(self, name: str, batch: Optional[int], **attrs) -> _OpenStep:
        """A step span at the top of the calling thread's own steps (the
        service's `make_batch` and `harvest` of batch `batch`)."""
        return self._open_step(name, [], batch, attrs)

    def batch(self, fn: Callable, batch: int, attrs: dict,
              block: Callable) -> Callable:
        """`fn` run under this tracer's scope as the `batch` span of batch
        `batch`: the thread that calls the returned function records the
        batch path's `step` spans under it. The span ends when
        `block(result)` has waited for the result's device work. `attrs`
        become the span's attributes; the caller may add to the dict
        until the trace is exported."""

        def run(*args):
            saved = (_scope.tracer, _scope.stack, _scope.batch)
            _scope.tracer, _scope.stack, _scope.batch = self, [], batch
            try:
                with self._open_step("batch", _scope.stack, batch, attrs):
                    return block(fn(*args))
            finally:
                _scope.tracer, _scope.stack, _scope.batch = saved
        return run

    def drain_steps(self) -> List[StepSpan]:
        """Hand over (and forget) the step spans that have ended."""
        out, self.steps = self.steps, []
        return out


class NullTracer:
    """Disabled-mode tracer: every method is a no-op, nothing is
    retained. `spans` stays an empty tuple so exporters see 'no data',
    never an error."""

    enabled = False
    clock = None
    spans: Tuple[Span, ...] = ()
    steps: Tuple[StepSpan, ...] = ()

    def start(self, *a, **kw) -> None:
        pass

    def mark(self, *a, **kw) -> None:
        pass

    def finish(self, *a, **kw) -> None:
        pass

    def drain(self) -> tuple:
        return ()

    def step(self, *a, **kw) -> _NoStep:
        return _NO_STEP

    def batch(self, fn: Callable, *a) -> Callable:
        return fn

    def drain_steps(self) -> tuple:
        return ()
