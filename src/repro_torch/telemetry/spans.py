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
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

#: canonical lifecycle event names, in order of occurrence
SPAN_EVENTS = ("submit", "admit", "dispatch", "harvest", "shed")

#: canonical keys of a serialized span (the cross-workload schema pinned
#: by tests/test_workload_conformance.py)
SPAN_FIELDS = ("type", "stream_id", "seq", "qos", "bucket_n", "batch_b",
               "status", "compile", "iters", "events", "phases",
               "latency_s")


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


class Tracer:
    """Collects spans keyed by (stream_id, seq) — unique per service,
    since seq numbers are per-stream monotone. The serving loop passes
    explicit timestamps (`t=`) where it already read the clock, so a
    span never sees a different time than the response it describes."""

    enabled = True

    def __init__(self, clock=None):
        self.clock = clock
        self._open: Dict[Tuple[str, int], Span] = {}
        self.spans: List[Span] = []

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


class NullTracer:
    """Disabled-mode tracer: every method is a no-op, nothing is
    retained. `spans` stays an empty tuple so exporters see 'no data',
    never an error."""

    enabled = False
    clock = None
    spans: Tuple[Span, ...] = ()

    def start(self, *a, **kw) -> None:
        pass

    def mark(self, *a, **kw) -> None:
        pass

    def finish(self, *a, **kw) -> None:
        pass

    def drain(self) -> tuple:
        return ()
