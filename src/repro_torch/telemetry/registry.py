"""Metrics registry: counters, gauges, fixed-bucket histograms
(counterpart of `repro.telemetry.registry`).

The registry is the always-on half of the telemetry layer (DESIGN.md §6):
the serving loop's `stats` accounting is backed by it, so it must cost no
more than the dict increments it replaced. It is therefore
lock-free-in-spirit: metric objects are plain Python attributes mutated
with `+=` under the assumption that one scheduler loop owns them — the
same single-writer assumption the services already make about their
queues. There are no locks, no atomics, and no allocation on the hot
path (`Counter.inc` is one attribute add).

Naming scheme (DESIGN.md §6): ``repro_<subsystem>_<what>_<unit>[_total]``
— Prometheus conventions, so `to_prometheus()` is a direct serialization.
Labeled families (`labels=("reason",)`) hold one child metric per label
value; children are created on first use and cached.

Histograms use *fixed* upper bounds fixed at registration: `observe(v)`
is a bisect into the bound list, counts are per-bucket (cumulated only at
export, as Prometheus `le` semantics require: a value equal to a bound
falls in that bound's bucket).
"""
from __future__ import annotations

import re
from bisect import bisect_left
from itertools import accumulate
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: default latency bounds (seconds): sub-ms scheduler turns up to
#: multi-second queue waits under overload.
LATENCY_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotone (by convention) scalar. `set` exists only for the legacy
    `stats` compat view, which historically allowed arbitrary writes."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, v=1) -> None:
        self.value += v

    def set(self, v) -> None:
        self.value = v

    def get(self):
        return self.value


class Gauge(Counter):
    """A scalar that may go up and down (queue depth, in-flight batches)."""

    __slots__ = ()


class Histogram:
    """Fixed-bucket histogram with Prometheus `le` (inclusive) semantics."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Sequence[float]):
        bs = tuple(float(b) for b in bounds)
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing and non-empty, got {bounds}")
        self.bounds = bs
        self.counts: List[int] = [0] * (len(bs) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        # bisect_left: first bound >= v, i.e. the smallest bucket with
        # v <= le — a value equal to a bound lands in that bound's bucket
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[int]:
        """Per-`le` cumulative counts (Prometheus export order),
        including the +Inf bucket (== count)."""
        return list(accumulate(self.counts))

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (linear within a bucket;
        the +Inf bucket reports the last finite bound). For summaries
        only — raw spans carry exact times."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
            if cum + c >= target:
                if c == 0 or i >= len(self.bounds):
                    return hi
                return lo + (hi - lo) * (target - cum) / c
            cum += c
            lo = hi
        return self.bounds[-1]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One registered metric name: kind, help text, label names, and the
    child metrics keyed by label values."""

    __slots__ = ("name", "kind", "help", "labelnames", "buckets",
                 "children")

    def __init__(self, name: str, kind: str, help_: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Sequence[float]]):
        self.name = name
        self.kind = kind
        self.help = help_
        self.labelnames = labelnames
        self.buckets = buckets
        self.children: Dict[Tuple[str, ...], object] = {}

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self.buckets or LATENCY_BUCKETS_S)
        return _KINDS[self.kind]()

    def labels(self, **kv):
        """The child metric for one label-value assignment (created on
        first use). Label names must match registration exactly."""
        if set(kv) != set(self.labelnames):
            raise ValueError(f"metric {self.name!r} takes labels "
                             f"{self.labelnames}, got {tuple(kv)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        child = self.children.get(key)
        if child is None:
            child = self.children[key] = self._make()
        return child

    def series(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        return sorted(self.children.items())


class MetricsRegistry:
    """Create-or-get registration of metric families.

    Re-registering an existing name returns the existing family (so a
    service restarting its metrics plumbing against a shared registry is
    idempotent) — but re-registering with a *different* kind or label set
    is an error, never a silent overwrite.
    """

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    # -- registration --------------------------------------------------------

    def _register(self, name: str, kind: str, help_: str,
                  labels: Sequence[str],
                  buckets: Optional[Sequence[float]] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labels)
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.labelnames != labelnames:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind} "
                    f"with labels {fam.labelnames}")
            return fam
        fam = _Family(name, kind, help_, labelnames, buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help_: str = "", labels: Sequence[str] = ()):
        """A counter (or, with `labels`, a counter family)."""
        fam = self._register(name, "counter", help_, labels)
        return fam if fam.labelnames else fam.labels()

    def gauge(self, name: str, help_: str = "", labels: Sequence[str] = ()):
        fam = self._register(name, "gauge", help_, labels)
        return fam if fam.labelnames else fam.labels()

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  labels: Sequence[str] = ()):
        fam = self._register(name, "histogram", help_, labels,
                             buckets=buckets)
        return fam if fam.labelnames else fam.labels()

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict view of every series (JSON-friendly)."""
        out = {}
        for name, fam in sorted(self._families.items()):
            if fam.kind == "histogram":
                val = {
                    _label_str(fam.labelnames, key) or "": {
                        "sum": h.sum, "count": h.count,
                        "buckets": {_le(b): c for b, c in
                                    zip(list(h.bounds) + ["+Inf"],
                                        h.cumulative())}}
                    for key, h in fam.series()}
            else:
                val = {_label_str(fam.labelnames, key) or "": m.value
                       for key, m in fam.series()}
            if list(val) == [""]:                      # unlabeled
                val = val[""]
            out[name] = val
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one TYPE/HELP block per
        family, histograms expanded to _bucket/_sum/_count)."""
        lines: List[str] = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, m in fam.series():
                lbl = _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    cum = m.cumulative()
                    for b, c in zip(list(m.bounds) + ["+Inf"], cum):
                        le = _label_str(fam.labelnames + ("le",),
                                        key + (_le(b),))
                        lines.append(f"{name}_bucket{{{le}}} {c}")
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}_sum{suffix} {_num(m.sum)}")
                    lines.append(f"{name}_count{suffix} {m.count}")
                else:
                    suffix = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}{suffix} {_num(m.value)}")
        return "\n".join(lines) + "\n"


def _le(bound) -> str:
    return bound if isinstance(bound, str) else _num(bound)


def _num(v) -> str:
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    return ",".join(f'{n}="{v}"' for n, v in zip(names, values))
