"""The generator and the traffic: deterministic per seed, and the
lengths, arrivals and recordings of the mixes' own."""
import pytest
import torch

from cmax_bench.gen import events, traffic

SENSOR = events.Sensor(64, 48, 53.0, 53.0, 32.0, 24.0)
SCENE = events.Scene(n_features=150)


def rec(seed, stream=0):
    return events.record(SENSOR, SCENE, 5, 2000,
                         events.generator(seed, stream, "cpu"), "cpu")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, -3, 2**70])
def test_a_recording_is_a_function_of_its_seed(seed):
    a, b = rec(seed), rec(seed)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    other = rec(seed + 1)
    assert not torch.equal(a.x, other.x)
    assert not torch.equal(a.x, rec(seed, stream=1).x)


def test_a_recording_follows_the_law():
    r = rec(2**31 + 5)
    K, N = r.x.shape
    assert (K, N) == (5, 2000)
    # integer pixels on the sensor where valid, time-ordered windows
    v = r.valid
    assert torch.equal(r.x[v], torch.round(r.x[v]))
    assert bool(((r.x[v] >= 0) & (r.x[v] < SENSOR.width)).all())
    assert bool(((r.y[v] >= 0) & (r.y[v] < SENSOR.height)).all())
    assert bool((r.t[:, 1:] >= r.t[:, :-1]).all())
    k = torch.arange(K, dtype=torch.float32)[:, None]
    assert bool((r.t >= k * SCENE.window_dt - 1e-6).all())
    assert bool((r.t <= (k + 1) * SCENE.window_dt + 1e-6).all())
    assert set(r.p.unique().tolist()) <= {-1.0, 1.0}
    assert float((r.omega_imu - r.omega_true).abs().max()) < 0.2
    assert float(r.valid.float().mean()) > 0.9


def test_window_lengths_of_the_mixes():
    fixed = traffic.window_lengths({"events": {"law": "fixed", "n": 40000}},
                                   16, 64)
    assert fixed.shape == (16, 64) and bool((fixed == 40000).all())
    with pytest.raises(ValueError):
        traffic.window_lengths({"events": {"law": "log_uniform"}}, 16, 64)


def test_open_loop_arrivals_are_the_mixes_own():
    mix = {"loop": "open", "arrival_seed": 2, "streams": 4,
           "rate_per_s": 8.0}
    a = traffic.arrival_offsets(mix, 30.0)
    assert len(a) == 4
    again = traffic.arrival_offsets(mix, 30.0)
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    other = traffic.arrival_offsets(dict(mix, arrival_seed=3), 30.0)
    assert not all(torch.equal(x, y) for x, y in zip(a, other))
    with pytest.raises(ValueError):
        traffic.arrival_offsets({"loop": "closed"}, 30.0)


def test_periodic_arrivals_are_one_window_a_period_per_stream():
    mix = {"loop": "open", "arrival_seed": 1, "streams": 16,
           "rate_per_s": 32.0}
    a = traffic.arrival_offsets(mix, 51.0)
    period = 16 / 32.0
    for x in a:
        assert 0.0 <= float(x[0]) < period
        assert torch.allclose(torch.diff(x), torch.full_like(x[1:], period))
        assert float(x[-1]) < 51.0 <= float(x[-1]) + period
    assert abs(sum(len(x) for x in a) - 32.0 * 51.0) <= 16


def test_a_pool_offers_every_seed_the_same_windows():
    from cmax_bench import harness
    from cmax_bench.tests.tiny import tiny_cell
    cell = tiny_cell("davis240-batched.replay-40k")
    cfg, mix = cell.config, dict(cell.traffic, recording_windows=3)
    a = harness.record_streams(cfg, mix, 11, "cpu")
    b = harness.record_streams(cfg, mix, 12, "cpu")
    key = lambda st: sorted(float(x.sum()) for s in range(len(st.x))
                            for x in st.x[s])
    assert key(a) == key(b)                   # the same windows ...
    assert [float(x.sum()) for x in a.x] != [float(x.sum()) for x in b.x]
    c = harness.record_streams(cfg, dict(mix, pool_seed=mix["pool_seed"] + 1),
                               11, "cpu")
    assert key(c) != key(a)                   # ... of the mix's pool
