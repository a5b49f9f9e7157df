"""queue_wait_p95_ms.<cells>: 95th percentile of the spans' queue wait
(submit to admit), ms."""
from cmax_bench import stats


def read(d):
    p = stats.percentile(d.queue_waits, 95)
    return None if p is None else 1e3 * p
