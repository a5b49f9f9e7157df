"""The metric arithmetic: a rate over the whole window, percentiles over
every window due, failures as misses, and a stall that shows."""
import pytest

from cmax_bench import stats


def test_rate_counts_completions_inside_the_window_only():
    done = [0.5, 1.0, 9.9, 10.0, 10.01, -0.1]
    assert stats.rate(done, 0.0, 10.0) == pytest.approx(4 / 10.0)


def test_percentile_is_nearest_rank_over_all_values():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None


def test_failed_windows_count_as_missing_every_limit():
    due = [float(i) for i in range(20)]
    done = [d + 0.1 for d in due]
    done[3] = None                      # never answered
    lat = stats.latencies(due, done, missing=1e3)
    assert lat[3] == 1e3
    assert stats.percentile(lat, 95) == pytest.approx(0.1)
    done[4] = None                      # a second failure reaches p95
    lat = stats.latencies(due, done, missing=1e3)
    assert stats.percentile(lat, 95) == 1e3


def test_an_injected_stall_shows_in_the_p95():
    # 200 windows served in 20 ms each, one every 50 ms; a 1 s stall at
    # window 100 delays every window due while it lasts
    due = [0.05 * i for i in range(200)]
    free, done = 0.0, []
    for i, d in enumerate(due):
        start = max(d, free)
        if i == 100:
            start += 1.0
        free = start + 0.02
        done.append(free)
    lat = stats.latencies(due, done, missing=1e3)
    assert stats.percentile(lat, 50) == pytest.approx(0.02)
    assert stats.percentile(lat, 95) > 0.5

