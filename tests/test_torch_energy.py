"""The port's `core/energy.py` against the JAX package's: `locality_stats`
on the same windows and hypotheses gives every count exactly and every
ratio bitwise (f32), at every stage; `account_window` fed each package's
own locality statistics gives exactly equal accounts; and the reference's
invariants of `tests/test_energy.py` hold on the port, traced by the
port's own pipeline.

Inputs: `tests/test_energy.py`'s fixture (`structured_window(4096,
Camera(), seed=17)`, traced by the reference's `estimate_window`), one
POSTER window of 40,000 events, and three edge cases (omega unchanged, an
all-invalid window, a window in one pixel group).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CmaxConfig as RConfig, estimate_window as r_estimate
from repro.core import energy as R
from repro.core.types import Camera as RCamera, EventWindow as REventWindow
from repro.data import events as r_events

import repro_torch.core as T
from repro_torch.convert import config_from_reference
from repro_torch.core import energy as E
from helpers import structured_window

torch.set_num_threads(1)

KEYS = ("n_retained", "active_groups", "active_ratio", "outlier_ratio",
        "expected_update_ratio", "expected_reduction", "measured_reduction",
        "eff_updates", "naive_updates")


def _win(ev) -> T.EventWindow:
    return T.EventWindow(*[torch.tensor(np.asarray(a))
                           for a in (ev.x, ev.y, ev.t, ev.p, ev.valid)])


def _om(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def traced():
    cam = RCamera()
    ev, om_true = structured_window(4096, cam=cam, seed=17)
    cfg = RConfig(camera=cam)
    res = r_estimate(ev, om_true + 0.15, cfg)
    return cam, cfg, ev, res


def _assert_same(r_loc, t_loc):
    assert set(t_loc) == set(KEYS)
    for k in KEYS:
        want = np.asarray(r_loc[k])
        got = t_loc[k]
        assert got.dim() == 0, k
        got = got.numpy()
        assert got.dtype == want.dtype, (k, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), (k, got, want)


def _both(cam, cfg, si, ev, om_sort, om_now):
    r_loc = R.locality_stats(ev, jnp.asarray(om_sort), jnp.asarray(om_now),
                             cam, cfg.stages[si])
    t_cfg = config_from_reference(cfg)
    t_loc = E.locality_stats(_win(ev), _om(om_sort), _om(om_now),
                             t_cfg.camera, t_cfg.stages[si])
    return r_loc, t_loc


@pytest.fixture(scope="module")
def traced_pairs(traced):
    """(reference, port) statistics at each stage of the traced fixture,
    under the reference trace's entry and exit hypotheses."""
    cam, cfg, ev, res = traced
    return [_both(cam, cfg, si, ev, res.stages[si].omega_entry,
                  res.stages[si].omega_exit) for si in range(3)]


@pytest.mark.parametrize("si", [0, 1, 2])
def test_locality_stats_equal_on_the_traced_fixture(traced_pairs, si):
    _assert_same(*traced_pairs[si])


@pytest.fixture(scope="module")
def poster():
    spec = dataclasses.replace(r_events.POSTER, n_windows=1,
                               events_per_window=40000, jerk_prob=0.0)
    wins, om_true, om_imu = r_events.make_sequence(spec)
    return (spec.camera, RConfig(camera=spec.camera),
            r_events.window_slice(wins, 0), np.asarray(om_imu[0]),
            np.asarray(om_true[0]))


@pytest.mark.parametrize("si", [0, 1, 2])
def test_locality_stats_equal_on_a_poster_window(poster, si):
    cam, cfg, ev, om_imu, om_true = poster
    r_loc, t_loc = _both(cam, cfg, si, ev, om_imu, om_true)
    _assert_same(r_loc, t_loc)
    assert int(t_loc["n_retained"]) > 1000
    assert int(t_loc["eff_updates"]) < int(t_loc["naive_updates"])


# `chip_smoke.py`'s [main] stream 1, window 3 (POSTER, 40,000 events,
# 2,500 features, seed POSTER.seed + 1) at s = 1, under the entry and exit
# omega the card traced for it (NVIDIA H100 80GB HBM3, 700 W). The estimate
# had settled near zero, where a small move of omega flips the floor of
# most integer event coordinates: outliers are then most of the retained
# events, and (active groups + outliers) / retained passes 1.
CARD_WINDOW_OMEGA = (
    [-0.0003191744035575539, 0.00036294630263000727, -0.002493778010830283],
    [-0.00044829072430729866, -0.0006227459525689483, -0.001735991914756596])
CARD_WINDOW_RATIOS = dict(expected_update_ratio=1.0025750398635864,
                          active_ratio=0.21979999542236328,
                          outlier_ratio=0.7827749848365784)


def test_locality_stats_equal_on_the_cards_window_above_one():
    from repro.configs import cmax_camel
    spec = dataclasses.replace(r_events.POSTER, n_windows=4,
                               events_per_window=40000, n_features=2500,
                               jerk_prob=0.0, seed=r_events.POSTER.seed + 1)
    wins, _, _ = r_events.make_sequence(spec)
    cfg = cmax_camel.CONFIG
    assert cfg.stages[2].scale == 1.0
    r_loc, t_loc = _both(cfg.camera, cfg, 2, r_events.window_slice(wins, 3),
                         *(np.array(om, np.float32)
                           for om in CARD_WINDOW_OMEGA))
    _assert_same(r_loc, t_loc)
    # the reference gives the card's ratios, and the sum passes 1 while
    # each of its terms stays in [0, 1]
    for key, want in CARD_WINDOW_RATIOS.items():
        assert float(r_loc[key]) == want, (key, float(r_loc[key]))
    assert float(r_loc["expected_update_ratio"]) > 1.0
    assert int(t_loc["eff_updates"]) <= int(t_loc["naive_updates"])


def test_locality_stats_equal_when_omega_is_unchanged(traced):
    cam, cfg, ev, res = traced
    om = res.stages[0].omega_entry
    for si in range(3):
        r_loc, t_loc = _both(cam, cfg, si, ev, om, om)
        _assert_same(r_loc, t_loc)
        assert float(t_loc["outlier_ratio"]) == 0.0


def test_locality_stats_equal_on_an_all_invalid_window(traced):
    cam, cfg, ev, _ = traced
    dead = REventWindow(ev.x, ev.y, ev.t, ev.p, jnp.zeros_like(ev.valid))
    om = np.array([0.3, -0.2, 0.5], np.float32)
    for si in range(3):
        r_loc, t_loc = _both(cam, cfg, si, dead, om, om * 1.1)
        _assert_same(r_loc, t_loc)
        assert int(t_loc["n_retained"]) == 1          # clamped
        assert int(t_loc["active_groups"]) == 0


def test_locality_stats_equal_with_one_active_group(traced):
    cam, cfg, ev, _ = traced
    n = ev.x.shape[0]
    one = REventWindow(jnp.full((n,), 120.0, jnp.float32),
                       jnp.full((n,), 90.0, jnp.float32), ev.t[:n], ev.p[:n],
                       jnp.ones((n,), bool))
    om = np.zeros(3, np.float32)
    for si in range(3):
        r_loc, t_loc = _both(cam, cfg, si, one, om, om)
        _assert_same(r_loc, t_loc)
        assert int(t_loc["active_groups"]) == 1


def test_forward_fill_matches_a_host_loop():
    """The cummax fill against the reference's scan, spelled in Python:
    the address of the previous active group, -2 before the first."""
    rng = np.random.default_rng(3)
    act = torch.tensor(rng.random((2, 97)) < 0.2)
    act[1] = False
    addr = torch.tensor(rng.integers(0, 9, 97))
    prev = E._prev_active(act)
    for b in range(2):
        carry = -2
        for i in range(97):
            got = int(addr[prev[b, i]]) if prev[b, i] >= 0 else -2
            assert got == carry
            if act[b, i]:
                carry = int(addr[i])


def _stage_stats(cam, cfg, res, locs):
    stats = []
    for si, stage in enumerate(cfg.stages):
        tr = res.stages[si]
        Hs, Ws = stage.grid(cam)
        stats.append(dict(passes=float(tr.passes),
                          n_retained=float(tr.n_retained),
                          P=float(Hs * Ws), taps=stage.blur_taps,
                          merge_reduction=float(locs[si][
                              "measured_reduction"])))
    return stats


def test_account_window_equal_fed_each_packages_stats(traced,
                                                    traced_pairs):
    cam, cfg, ev, res = traced
    pairs = traced_pairs
    r_stats = _stage_stats(cam, cfg, res, [p[0] for p in pairs])
    t_stats = _stage_stats(cam, cfg, res, [p[1] for p in pairs])
    assert r_stats == t_stats
    t_cfg = config_from_reference(cfg)
    for camel in (True, False):
        ra, re_ = R.account_window(r_stats, cfg, R.HwParams(), camel=camel,
                                   n_total=4096)
        ta, te = E.account_window(t_stats, t_cfg, E.HwParams(), camel=camel,
                                  n_total=4096)
        assert dataclasses.asdict(ta) == dataclasses.asdict(ra)
        assert te == re_
    assert E.C_CH == R.C_CH == 4 and E.T_TAP == R.T_TAP == 4
    for name in ("Account", "HwParams", "MemGroup", "account_stage",
                 "account_window", "load_profile", "pass_cost", "sort_cost"):
        assert hasattr(E, name), name


# ---- the reference's invariants, on the port's own trace ----


@pytest.fixture(scope="module")
def t_traced(traced):
    cam, cfg, ev, _ = traced
    _, om_true = structured_window(4096, cam=cam, seed=17)
    t_cfg = config_from_reference(cfg)
    tev = _win(ev)
    res = T.estimate_window(tev, _om(om_true) + 0.15, t_cfg)
    return t_cfg.camera, t_cfg, tev, res


def _t_stage_stats(cam, cfg, ev, res):
    locs = [E.locality_stats(ev, res.stages[si].omega_entry,
                             res.stages[si].omega_exit, cam, stage)
            for si, stage in enumerate(cfg.stages)]
    return _stage_stats(cam, cfg, res, locs)


def test_port_camel_fewer_accesses_and_cycles(t_traced):
    cam, cfg, ev, res = t_traced
    hw = E.HwParams()
    stats = _t_stage_stats(cam, cfg, ev, res)
    acc_c, e_c = E.account_window(stats, cfg, hw, camel=True, n_total=4096)
    acc_b, e_b = E.account_window(stats, cfg, hw, camel=False, n_total=4096)
    assert acc_c.total_accesses < acc_b.total_accesses
    assert acc_c.cycles < acc_b.cycles
    assert e_c["e_total_uj"] < e_b["e_total_uj"]
    assert e_c["e_mem_rw_uj"] < e_b["e_mem_rw_uj"]


def test_port_locality_stats_ranges(t_traced):
    cam, cfg, ev, res = t_traced
    for si, stage in enumerate(cfg.stages):
        tr = res.stages[si]
        loc = E.locality_stats(ev, tr.omega_entry, tr.omega_exit, cam, stage)
        for key in ("active_ratio", "outlier_ratio",
                    "expected_update_ratio"):
            v = float(loc[key])
            assert 0.0 <= v <= 1.0, (key, v)
        # pending merge can only help on top of local accumulation
        assert float(loc["measured_reduction"]) >= \
            float(loc["expected_reduction"]) - 1e-6
        # effective updates never exceed naive event-wise updates
        assert int(loc["eff_updates"]) <= int(loc["naive_updates"])


def test_port_zero_outliers_when_omega_unchanged(t_traced):
    cam, cfg, ev, res = t_traced
    om = res.stages[0].omega_entry
    loc = E.locality_stats(ev, om, om, cam, cfg.stages[0])
    assert float(loc["outlier_ratio"]) == 0.0


def test_port_energy_breakdown_consistency(t_traced):
    cam, cfg, ev, res = t_traced
    hw = E.HwParams()
    stats = _t_stage_stats(cam, cfg, ev, res)
    acc, e = E.account_window(stats, cfg, hw, camel=True, n_total=4096)
    assert e["e_total_uj"] == pytest.approx(
        e["e_mem_rw_uj"] + e["e_logic_leak_uj"])
    assert e["latency_s"] == pytest.approx(acc.cycles / hw.freq_hz)


def test_locality_stats_batched_equals_per_window(traced):
    """Leading batch axes carry through: a batch of windows gives each
    window's own statistics."""
    cam, cfg, ev, res = traced
    t_cfg = config_from_reference(cfg)
    tev = _win(ev)
    wins = T.EventWindow(*[torch.stack([a, a.flip(0)]) for a in
                           (tev.x, tev.y, tev.t, tev.p, tev.valid)])
    tr = res.stages[1]
    om_s = torch.stack([_om(tr.omega_entry), _om(tr.omega_exit)])
    om_n = torch.stack([_om(tr.omega_exit), _om(tr.omega_entry)])
    st = t_cfg.stages[1]
    both = E.locality_stats(wins, om_s, om_n, t_cfg.camera, st)
    for b in range(2):
        one = E.locality_stats(wins.map(lambda a: a[b]), om_s[b], om_n[b],
                               t_cfg.camera, st)
        for k in KEYS:
            assert torch.equal(both[k][b], one[k]), k
