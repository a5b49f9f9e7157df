"""exec_idle_share.<cells>: share of the time a batch was on the dispatch
worker, within the profiled slice, in which no operation ran on the
device. A run with no device trace gives it nothing to read."""
from cmax_bench.trace import busy_intervals, merge, overlap


def read(d):
    if d.slice_ns is None or not d.device:
        return None
    a, b = d.slice_ns
    flight = merge([(max(a, r.t0_ns), min(b, r.t1_ns))
                    for r in d.window_batches
                    if r.t1_ns > a and r.t0_ns < b])
    total = sum(e - s for s, e in flight)
    if total <= 0:
        return None
    return 1.0 - overlap(flight, busy_intervals(d)) / total
