"""Exporters: JSONL trace dump and human-readable summary (counterpart of
`repro.telemetry.export`).

Three consumption paths (DESIGN.md §6):

  * JSONL (`write_jsonl`) — one record per line; spans carry
    ``"type": "span"``, decision records ``"type": "decision"``, so one
    file holds a full interleaved trace and downstream tools filter by
    type. This is what `--trace-out` writes.
  * Prometheus text — `MetricsRegistry.to_prometheus()`; `--metrics-out`
    writes it verbatim (a scrape-file, also valid for node_exporter's
    textfile collector).
  * Human summary (`summary_text`) — a terminal-width digest of the
    registry snapshot plus span/decision tallies, printed by
    `launch/serve.py` when telemetry is on.
"""
from __future__ import annotations

import json
from typing import Iterable, List


def to_record(obj) -> dict:
    """Span/decision → serializable dict (dicts pass through)."""
    return obj if isinstance(obj, dict) else obj.to_dict()


def write_jsonl(path: str, records: Iterable) -> int:
    """Write records (spans, decision dicts, or plain dicts) as JSON
    lines. Returns the number of lines written."""
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(to_record(rec), sort_keys=True) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def summary_text(registry, spans=(), decisions=None) -> str:
    """Human-readable digest: scalar metrics, histogram quantiles, span
    phase decomposition, and the adaptation verdict tally."""
    lines: List[str] = ["telemetry summary", "-----------------"]
    snap = registry.snapshot()
    for name, val in snap.items():
        if isinstance(val, dict) and "buckets" in val:     # one histogram
            val = {"": val}
        if isinstance(val, dict) and val and all(
                isinstance(v, dict) and "buckets" in v for v in val.values()):
            for lbl, h in val.items():
                mean = h["sum"] / h["count"] if h["count"] else float("nan")
                tag = f"{name}{{{lbl}}}" if lbl else name
                lines.append(f"  {tag}: count={h['count']} "
                             f"mean={mean:.6g} sum={h['sum']:.6g}")
        elif isinstance(val, dict):
            for lbl, v in sorted(val.items()):
                lines.append(f"  {name}{{{lbl}}}: {v}")
        else:
            lines.append(f"  {name}: {val}")
    spans = list(spans)
    if spans:
        lines.append(f"  spans: {len(spans)} "
                     f"(ok={sum(1 for s in to_dicts(spans) if s['status'] == 'ok')})")
        tot = {}
        for s in to_dicts(spans):
            for ph, dt in s["phases"].items():
                tot[ph] = tot.get(ph, 0.0) + dt
        for ph in ("queue_wait", "assemble", "execute"):
            if ph in tot:
                lines.append(f"    phase {ph}: total={tot[ph]:.6g}s "
                             f"mean={tot[ph] / len(spans):.6g}s")
    if decisions is not None and getattr(decisions, "enabled", False):
        counts = decisions.verdict_counts()
        if counts:
            tally = " ".join(f"{k}={v}" for k, v in sorted(counts.items()))
            lines.append(f"  adaptation verdicts: {tally}")
    return "\n".join(lines) + "\n"


def to_dicts(records) -> List[dict]:
    return [to_record(r) for r in records]
