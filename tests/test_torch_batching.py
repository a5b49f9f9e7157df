"""The port's bucketing half of `data/events.py` against the JAX package:
the same length classes, padding, leader-replicated fill and ragged cuts on
the same numpy-seeded windows (integers and windows compared exactly)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import events as r_events

from repro_torch.core.types import Camera
from repro_torch.data import events as t_events
from helpers import small_camera

torch.set_num_threads(1)

COUNTS = [1, 2, 3, 127, 128, 129, 511, 512, 513, 1000, 1024, 1025, 4096,
          40000, 65536, 65537, 1 << 20]
POLICIES = [
    ("pow2", lambda m: m.pow2_policy()),
    ("pow2-16384", lambda m: m.pow2_policy(min_bucket=16384,
                                           max_bucket=65536)),
    ("single", lambda m: m.single_policy(40000)),
    ("fixed", lambda m: m.fixed_policy([4096, 512, 65536])),
]


def _outcome(fn):
    """fn()'s value, or the type and message of what it raised."""
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("name,make", POLICIES, ids=[p[0] for p in POLICIES])
def test_policies_match_reference(name, make):
    rp, tp = make(r_events), make(t_events)
    assert dataclasses.asdict(rp) == dataclasses.asdict(tp)
    for n in COUNTS + [0, -3]:
        assert _outcome(lambda: tp.bucket_of(n)) == \
            _outcome(lambda: rp.bucket_of(n)), n
    for lo, hi in [(1, 1), (100, 5000), (20000, 40000), (512, 1 << 20),
                   (3, 2), (0, 10), (40000, 70000)]:
        assert _outcome(lambda: tp.classes(lo, hi)) == \
            _outcome(lambda: rp.classes(lo, hi)), (lo, hi)
    for n in (1, 5, 1023, 1024, 1025):
        assert t_events._next_pow2(n) == r_events._next_pow2(n)


def _sequence(n_windows=4, n=512):
    spec = dict(name="b", n_windows=n_windows, events_per_window=n,
                n_features=40, seed=7, camera=small_camera())
    r_wins, _, _ = r_events.make_sequence(r_events.SequenceSpec(**spec))
    cam = Camera(**dataclasses.asdict(small_camera()))
    t_wins, _, _ = t_events.make_sequence(
        t_events.SequenceSpec(**{**spec, "camera": cam}), device="cpu")
    return r_wins, t_wins


def _fields(ev):
    return [np.asarray(getattr(ev, f)) for f in ("x", "y", "t", "p", "valid")]


def test_ragged_cuts_match_reference():
    for seed in (0, 3):
        for lo, hi in ((170, 512), (20000, 40000), (1, 1)):
            np.testing.assert_array_equal(
                t_events.ragged_lengths(6, lo, hi, seed=seed),
                r_events.ragged_lengths(6, lo, hi, seed=seed))
    with pytest.raises(ValueError):
        t_events.ragged_lengths(3, 10, 5)
    r_wins, t_wins = _sequence()
    lens = r_events.ragged_lengths(4, 100, 512, seed=1)
    r_rag = r_events.ragged_from_sequence(r_wins, lens)
    t_rag = t_events.ragged_from_sequence(t_wins, lens)
    assert [w.n for w in t_rag] == [w.n for w in r_rag] == list(lens)
    for rw, tw in zip(r_rag, t_rag):
        for a, b in zip(_fields(rw), _fields(tw)):
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        t_events.ragged_from_sequence(t_wins, lens[:2])
    with pytest.raises(ValueError):
        t_events.ragged_from_sequence(t_wins, [0, 1, 1, 1])


def test_fill_bucketize_and_padding_match_reference():
    r_wins, t_wins = _sequence()
    lens = r_events.ragged_lengths(4, 100, 512, seed=2)
    r_rag = r_events.ragged_from_sequence(r_wins, lens)
    t_rag = t_events.ragged_from_sequence(t_wins, lens)
    policy_r = r_events.pow2_policy(min_bucket=128, max_bucket=512)
    policy_t = t_events.pow2_policy(min_bucket=128, max_bucket=512)
    assert t_events.bucketize(t_rag, policy_t) == \
        r_events.bucketize(r_rag, policy_r)
    assert t_events.padding_overhead(t_rag, policy_t) == \
        r_events.padding_overhead(r_rag, policy_r)
    for take, batch_b in (([0], 1), ([1, 2], 4), ([0, 1, 2, 3], 8)):
        r_ev, r_fill = r_events.fill_batch([r_rag[i] for i in take], 512,
                                           batch_b)
        t_ev, t_fill = t_events.fill_batch([t_rag[i] for i in take], 512,
                                           batch_b)
        assert t_fill == r_fill == batch_b - len(take)
        assert t_ev.x.shape == (batch_b, 512) and t_ev.x.device.type == "cpu"
        assert t_ev.valid.dtype == torch.bool
        for a, b in zip(_fields(r_ev), _fields(t_ev)):
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError):
        t_events.fill_batch(t_rag, 512, 2)
    with pytest.raises(ValueError):
        t_events.fill_batch([], 512, 2)
