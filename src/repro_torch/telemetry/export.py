"""Exporters: JSONL trace dump and human-readable summary (counterpart of
`repro.telemetry.export`).

Three consumption paths (DESIGN.md §6):

  * JSONL (`write_jsonl`) — one record per line; spans carry
    ``"type": "span"``, the batch path's step spans ``"type": "step"``,
    decision records ``"type": "decision"``, so one file holds a full
    interleaved trace and downstream tools filter by type. This is what
    `--trace-out` writes.
  * Prometheus text — `MetricsRegistry.to_prometheus()`; `--metrics-out`
    writes it verbatim (a scrape-file, also valid for node_exporter's
    textfile collector).
  * Human summary (`summary_text`) — a terminal-width digest of the
    registry snapshot plus span/decision tallies and the host time of
    each step (`step_totals`), printed by `launch/serve.py` when
    telemetry is on.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List

from .spans import STEP_SPANS


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


def step_totals(steps: Iterable) -> Dict[str, dict]:
    """Host time by step name over step spans (or their records): how
    many, their seconds in all, and their own seconds (less the spans
    directly under them, so the own seconds of a batch's steps add up to
    its span)."""
    recs = to_dicts(steps)
    under: Dict[int, int] = {}
    for r in recs:
        if r["parent"] is not None:
            under[r["parent"]] = under.get(r["parent"], 0) \
                + r["t1_ns"] - r["t0_ns"]
    out: Dict[str, dict] = {}
    for r in recs:
        d = out.setdefault(r["name"], {"count": 0, "total_s": 0.0,
                                       "own_s": 0.0})
        dt = r["t1_ns"] - r["t0_ns"]
        d["count"] += 1
        d["total_s"] += dt / 1e9
        d["own_s"] += (dt - under.get(r["id"], 0)) / 1e9
    return out


def summary_text(registry, spans=(), decisions=None, steps=()) -> str:
    """Human-readable digest: scalar metrics, histogram quantiles, span
    phase decomposition, the adaptation verdict tally, and the host time
    of each step per lockstep pass (entry passes and passes)."""
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
    totals = step_totals(steps)
    if totals:
        passes = sum(totals.get(n, {"count": 0})["count"]
                     for n in ("entry_pass", "pass"))
        lines.append(f"  step spans: {sum(d['count'] for d in totals.values())}"
                     f" ({totals.get('batch', {'count': 0})['count']} "
                     f"batches, {passes} lockstep passes)")
        for name in sorted(totals, key=lambda n: (STEP_SPANS.index(n)
                                                  if n in STEP_SPANS
                                                  else len(STEP_SPANS), n)):
            d = totals[name]
            per = (f" per pass={1e6 * d['total_s'] / passes:.6g}us"
                   if passes else "")
            lines.append(f"    step {name}: count={d['count']} "
                         f"total={d['total_s']:.6g}s own={d['own_s']:.6g}s"
                         f"{per}")
    return "\n".join(lines) + "\n"


def to_dicts(records) -> List[dict]:
    return [to_record(r) for r in records]
