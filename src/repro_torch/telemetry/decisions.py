"""Adaptation decision log — the software twin of the paper's
adaptation-overhead accounting (counterpart of `repro.telemetry.decisions`).

CMAX-CAMEL's runtime-adaptive controller (Alg. 1, `core/adaptive.py`)
decides per stage how long a window *stays*; the budget scheduler
(`costmodel/scheduler.py`, DESIGN.md §5) decides how long it is
*allowed* to stay. This log records, per served window and per
coarse-to-fine stage, what actually happened:

    iters     — update iterations the stage executed (exactly the value
                returned in the response's `iters` tuple)
    cap       — the budget scheduler's per-slot iteration cap for this
                stage (None when the window ran unbudgeted)
    max_iters — the static watchdog bound compiled into the stage
    gain      — the measured Eq. 7 normalized variance gain of the whole
                stage residence (None when the workload has no per-stage
                objective, e.g. LM decode)
    verdict   — the controller's outcome, classified by
                `core.adaptive.residence_verdict`:
                  "run"  — the gain test saturated before any bound
                  "cap"  — the budget cap bound the residence
                  "max"  — the static watchdog bound it
                  "skip" — the stage executed no iterations

Like the tracer, the log is opt-in: the default service carries a
`NullDecisionLog` and records nothing.
"""
from __future__ import annotations

from collections import Counter as _TallyCounter
from typing import Dict, List, Optional, Tuple

#: canonical keys of a serialized decision record
DECISION_FIELDS = ("type", "stream_id", "seq", "stage", "iters", "cap",
                   "max_iters", "gain", "verdict")


class DecisionLog:
    enabled = True

    def __init__(self):
        self.records: List[dict] = []

    def record(self, stream_id: str, seq: int, stage: int, iters: int,
               cap: Optional[int], max_iters: Optional[int],
               gain: Optional[float], verdict: str) -> None:
        self.records.append({
            "type": "decision", "stream_id": stream_id, "seq": seq,
            "stage": stage, "iters": iters, "cap": cap,
            "max_iters": max_iters, "gain": gain, "verdict": verdict})

    def drain(self) -> List[dict]:
        out, self.records = self.records, []
        return out

    # -- summaries -----------------------------------------------------------

    def verdict_counts(self) -> Dict[str, int]:
        return dict(_TallyCounter(r["verdict"] for r in self.records))

    def iters_by_request(self) -> Dict[Tuple[str, int], Tuple[int, ...]]:
        """(stream_id, seq) -> per-stage iteration tuple, rebuilt from the
        log. Must reproduce each response's `iters` exactly."""
        acc: Dict[Tuple[str, int], Dict[int, int]] = {}
        for r in self.records:
            acc.setdefault((r["stream_id"], r["seq"]), {})[r["stage"]] = \
                r["iters"]
        return {k: tuple(v[s] for s in sorted(v)) for k, v in acc.items()}


class NullDecisionLog:
    enabled = False
    records: tuple = ()

    def record(self, *a, **kw) -> None:
        pass

    def drain(self) -> tuple:
        return ()

    def verdict_counts(self) -> dict:
        return {}

    def iters_by_request(self) -> dict:
        return {}
