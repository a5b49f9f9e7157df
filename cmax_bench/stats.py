"""The benchmark's metric arithmetic: rates over a whole window and
percentiles over all requests, never statistics of chunks or batches."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q% of the values at or below it. None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(done_times: Sequence[float], t_start: float, t_end: float
         ) -> float:
    """Completions inside [t_start, t_end] per second of the window."""
    n = sum(1 for t in done_times if t_start <= t <= t_end)
    return n / (t_end - t_start)


def latencies(due: Sequence[float], done: Sequence[Optional[float]],
              missing: float) -> List[float]:
    """Seconds from each request's due time to its answer. A request that
    failed (done is None) counts as `missing`, a wait past every limit."""
    return [missing if d is None else d - u for u, d in zip(due, done)]

