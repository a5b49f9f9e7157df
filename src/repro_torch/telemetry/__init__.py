"""Telemetry layer: metrics registry, request spans, adaptation
decision log, and exporters (DESIGN.md §6; counterpart of
`repro.telemetry`, pure Python: the same metric names, span and decision
fields and text formats, so one trace reader serves both packages).

The `Telemetry` facade is what the serving layer consumes: it owns one
`MetricsRegistry` (always on — it backs the legacy `stats` view) plus an
optional `Tracer` and `DecisionLog` (Null twins when disabled, so the
hot path pays only no-op method calls). A service binds its injectable
clock via `bind_clock`, so FakeClock/virtual-time runs produce
deterministic traces.

    tel = Telemetry(spans=True, decisions=True)
    svc = AsyncBatchedEstimationService(cfg, telemetry=tel, ...)
    ... serve ...
    tel.write_trace("trace.jsonl")      # spans + decisions, JSONL
    tel.write_metrics("metrics.prom")   # Prometheus text format
    print(tel.summary())
"""
from __future__ import annotations

from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       LATENCY_BUCKETS_S)
from .spans import Span, Tracer, NullTracer, SPAN_EVENTS, SPAN_FIELDS
from .decisions import DecisionLog, NullDecisionLog, DECISION_FIELDS
from .export import write_jsonl, read_jsonl, summary_text, to_dicts

__all__ = [
    "Telemetry", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_S", "Span", "Tracer", "NullTracer", "SPAN_EVENTS",
    "SPAN_FIELDS", "DecisionLog", "NullDecisionLog", "DECISION_FIELDS",
    "write_jsonl", "read_jsonl", "summary_text", "to_dicts",
]


class Telemetry:
    """Bundle of registry + tracer + decision log handed to a service.

    `spans`/`decisions` choose the live or Null implementations at
    construction; `enabled` reports whether anything beyond the
    always-on registry is active.
    """

    def __init__(self, clock=None, spans: bool = False,
                 decisions: bool = False,
                 registry: MetricsRegistry = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = Tracer(clock) if spans else NullTracer()
        self.decisions = DecisionLog() if decisions else NullDecisionLog()

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled or self.decisions.enabled

    def bind_clock(self, clock) -> None:
        """Point the tracer at the service's injectable clock (used only
        when an event is marked without an explicit `t=`)."""
        if self.tracer.enabled:
            self.tracer.clock = clock

    # -- export --------------------------------------------------------------

    def trace_records(self):
        """All spans then all decisions, as serializable dicts."""
        return (to_dicts(self.tracer.spans)
                + to_dicts(self.decisions.records))

    def write_trace(self, path: str) -> int:
        return write_jsonl(path, self.trace_records())

    def write_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.registry.to_prometheus())

    def summary(self) -> str:
        return summary_text(self.registry, self.tracer.spans,
                            self.decisions)
