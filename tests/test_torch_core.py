"""Parity of the PyTorch port's core modules with the JAX reference on the
CPU: the same numpy-seeded inputs go through `repro` and `repro_torch`.

Bars are the reference's own: float modules at 1e-4 in float32; the Alg. 3
tables (perm, weights, counts) exactly; the seeded generator bit for bit.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as R
from repro.core import adaptive as R_adaptive
from repro.core import cgpr as R_cgpr
from repro.core.iwe import tap_weight_grads as r_tap_weight_grads
from repro.core.iwe import tap_weights as r_tap_weights
from repro.data import events as r_events

import repro_torch.core as T
from repro_torch.configs import cmax_camel
from repro_torch.convert import (config_from_reference, result_to_numpy,
                                 window_from_numpy)
from repro_torch.core import adaptive as T_adaptive
from repro_torch.core import cgpr as T_cgpr
from repro_torch.core.iwe import tap_weight_grads, tap_weights
from repro_torch.data import events as t_events
from helpers import random_window, small_camera, structured_window

torch.set_num_threads(1)

TOL = 1e-4
SCALES = [0.25, 0.5, 1.0]


def _cam(jcam):
    return T.Camera(**dataclasses.asdict(jcam))


def _win(w):
    return window_from_numpy(np.asarray(w.x), np.asarray(w.y),
                             np.asarray(w.t), np.asarray(w.p),
                             np.asarray(w.valid), device="cpu")


def _stage(jstage):
    return T.StageConfig(**dataclasses.asdict(jstage))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), rtol=tol, atol=tol)


OMEGA = np.array([0.8, -0.4, 1.1], np.float32)


@pytest.mark.parametrize("scale", SCALES)
def test_warp_events_matches_reference(scale):
    jcam = small_camera()
    w = random_window(700, cam=jcam, seed=3, valid_frac=0.9)
    a = R.warp_events(w, jnp.asarray(OMEGA), jcam, scale)
    b = T.warp_events(_win(w), torch.tensor(OMEGA), _cam(jcam), scale)
    for f in ("x0", "y0", "p_act", "in_range"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)))
    for f in ("xw", "yw", "ax", "ay", "rx", "ry"):
        _close(np.asarray(getattr(a, f)), getattr(b, f).numpy())


def test_rotational_flow_and_warp_points_match_reference():
    jcam = small_camera()
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 64, 200).astype(np.float32)
    y = rng.uniform(0, 48, 200).astype(np.float32)
    dt = rng.uniform(0, 0.03, 200).astype(np.float32)
    xn, yn = (x - jcam.cx) / jcam.fx, (y - jcam.cy) / jcam.fy
    ua, va = R.rotational_flow(jnp.asarray(xn), jnp.asarray(yn),
                               jnp.asarray(OMEGA), jcam.fx, jcam.fy)
    ub, vb = T.rotational_flow(torch.tensor(xn), torch.tensor(yn),
                               torch.tensor(OMEGA), jcam.fx, jcam.fy)
    _close(np.asarray(ua), ub.numpy())
    _close(np.asarray(va), vb.numpy())
    pa = R.warp_points(jnp.asarray(x), jnp.asarray(y), jnp.asarray(dt),
                       jnp.asarray(OMEGA), jcam, 0.5)
    pb = T.warp_points(torch.tensor(x), torch.tensor(y), torch.tensor(dt),
                       torch.tensor(OMEGA), _cam(jcam), 0.5)
    for ra, rb in zip(pa, pb):
        _close(np.asarray(ra), rb.numpy())


def test_dead_window_warp_is_masked():
    """An all-invalid window has t_ref = +inf; nothing lands in range."""
    jcam = small_camera()
    w = _win(random_window(64, cam=jcam, seed=1, valid_frac=0.0))
    assert torch.isinf(w.t_ref)
    out = T.warp_events(w, torch.tensor(OMEGA), _cam(jcam), 1.0)
    assert not bool(out.in_range.any())
    assert bool((out.p_act == -1).all())


@pytest.mark.parametrize("scale", SCALES)
def test_iwe_matches_reference(scale):
    jcam = small_camera()
    w = random_window(600, cam=jcam, seed=4, valid_frac=0.95)
    wts = np.random.default_rng(1).random(600).astype(np.float32)
    om = jnp.asarray(OMEGA)
    wa = R.warp_events(w, om, jcam, scale)
    wb = T.warp_events(_win(w), torch.tensor(OMEGA), _cam(jcam), scale)
    _close(np.asarray(R.event_deltas(wa, w.p, jnp.asarray(wts))),
           T.event_deltas(wb, _win(w).p, torch.tensor(wts)).numpy())
    grid = jcam.grid(scale)
    _close(np.asarray(R.accumulate(wa, w.p, grid)),
           T.accumulate(wb, _win(w).p, grid).numpy())
    _close(np.asarray(R.build_iwe(w, om, jcam, scale, weights=jnp.asarray(wts))),
           T.build_iwe(_win(w), torch.tensor(OMEGA), _cam(jcam), scale,
                       weights=torch.tensor(wts)).numpy())
    _close(np.asarray(R.build_iwe_only(w, om, jcam, scale)),
           T.build_iwe_only(_win(w), torch.tensor(OMEGA), _cam(jcam),
                            scale).numpy())


def test_tap_weights_and_grads_match_reference():
    rng = np.random.default_rng(2)
    ax, ay = (rng.random(50).astype(np.float32) for _ in range(2))
    rx, ry = (rng.normal(size=(50, 3)).astype(np.float32) for _ in range(2))
    _close(np.asarray(r_tap_weights(jnp.asarray(ax), jnp.asarray(ay))),
           tap_weights(torch.tensor(ax), torch.tensor(ay)).numpy())
    _close(np.asarray(r_tap_weight_grads(*map(jnp.asarray, (ax, ay, rx, ry)))),
           tap_weight_grads(*map(torch.tensor, (ax, ay, rx, ry))).numpy())


@pytest.mark.parametrize("k,sigma", [(3, 0.5), (5, 0.75), (9, 1.0)])
def test_contrast_matches_reference(k, sigma):
    rng = np.random.default_rng(k)
    ch = rng.normal(size=(4, 23, 31)).astype(np.float32)
    ta, tb = R.gaussian_taps(k, sigma), T.gaussian_taps(k, sigma)
    _close(np.asarray(ta), tb.numpy())
    _close(np.asarray(R.blur_separable(jnp.asarray(ch), ta)),
           T.blur_separable(torch.tensor(ch), tb).numpy())
    sa = R.streaming_stats(jnp.asarray(ch), ta)
    sb = T.streaming_stats(torch.tensor(ch), tb)
    _close(np.asarray(sa), sb.numpy())
    for fa, fb in ((R.objective_direct, T.objective_direct),
                   (R.objective_streaming, T.objective_streaming)):
        va, ga = fa(jnp.asarray(ch), ta)
        vb, gb = fb(torch.tensor(ch), tb)
        _close(np.asarray(va), vb.numpy())
        _close(np.asarray(ga), gb.numpy())
    va, ga = R.stats_to_objective(sa, 23 * 31)
    vb, gb = T.stats_to_objective(sb, 23 * 31)
    _close(np.asarray(va), vb.numpy())
    _close(np.asarray(ga), gb.numpy())


@pytest.mark.parametrize("k,sigma", [(3, 0.5), (5, 0.75), (9, 1.0)])
def test_variance_of_matches_reference(k, sigma):
    """Var of the blurred bare image at the engine pass's variance bar,
    rtol 1e-4 (`tests/test_megakernel.py:80-84`)."""
    img = np.random.default_rng(10 + k).normal(size=(23, 31)).astype(
        np.float32)
    want = np.asarray(R.contrast.variance_of(jnp.asarray(img), k, sigma))
    got = T.variance_of(torch.tensor(img), k, sigma)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


def test_streaming_stats_batched_equals_per_window():
    rng = np.random.default_rng(5)
    ch = torch.tensor(rng.normal(size=(3, 4, 12, 16)).astype(np.float32))
    taps = T.gaussian_taps(5, 0.75)
    batched = T.streaming_stats(ch, taps)
    for b in range(3):
        assert torch.equal(batched[b], T.streaming_stats(ch[b], taps))


@pytest.mark.parametrize("scale,keep", [(0.25, 0.25), (0.5, 0.5), (1.0, 1.0),
                                        (0.5, 0.25)])
def test_sort_events_exact(scale, keep):
    jcam = small_camera()
    w = random_window(1500, cam=jcam, seed=7, valid_frac=0.9)
    jst = R.StageConfig(scale=scale, tau=1e-3, max_iters=3, blur_taps=5,
                        blur_sigma=0.75, keep_ratio=keep)
    om = np.array([0.3, -0.2, 0.5], np.float32)
    ta = R.sort_events(w, jnp.asarray(om), jcam, jst)
    tb = T.sort_events(_win(w), torch.tensor(om), _cam(jcam), _stage(jst))
    for f in ta._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(ta, f)), err_msg=f)
    ra = R.retained_window(w, ta)
    rb = T.retained_window(_win(w), tb)
    for f in ("x", "y", "t", "p", "valid"):
        np.testing.assert_array_equal(getattr(rb, f).numpy(),
                                      np.asarray(getattr(ra, f)))


def test_sort_events_batched_equals_per_window():
    jcam = small_camera()
    wins = [_win(random_window(300, cam=jcam, seed=20 + i, valid_frac=0.8))
            for i in range(3)]
    batch = T.EventWindow(*[torch.stack([getattr(w, f) for w in wins])
                            for f in ("x", "y", "t", "p", "valid")])
    om = torch.tensor([[0.1, 0.2, 0.3], [0.0, 0.0, 0.0], [-1.0, 0.5, 0.2]])
    st = T.StageConfig(scale=0.5, tau=1e-3, max_iters=3, blur_taps=5,
                       blur_sigma=0.75, keep_ratio=0.5)
    tb = T.sort_events(batch, om, _cam(jcam), st)
    for i, w in enumerate(wins):
        t1 = T.sort_events(w, om[i], _cam(jcam), st)
        for f in t1._fields:
            assert torch.equal(getattr(tb, f)[i], getattr(t1, f)), f


@pytest.mark.parametrize("keep,cap", [(1.0, None), (0.5, None), (0.25, 2)])
def test_stage_policy_exact(keep, cap):
    cnt = np.array([0, 1, 2, 3, 7, 8, 9], np.int32)
    a = R.stage_policy(jnp.asarray(cnt), keep, cap)
    b = T.stage_policy(torch.tensor(cnt), keep, cap)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)))


def test_cgpr_matches_reference():
    rng = np.random.default_rng(3)
    sa, sb = R_cgpr.init_state(), T_cgpr.init_state(device="cpu")
    om_a = jnp.zeros(3)
    om_b = torch.zeros(3)
    for i in range(6):
        g = rng.normal(size=3).astype(np.float32)
        fa, fb = ((R_cgpr.step, T_cgpr.step) if i % 2 == 0 else
                  (R_cgpr.gradient_ascent_step, T_cgpr.gradient_ascent_step))
        om_a, sa = fa(om_a, jnp.asarray(g), sa, 0.1)
        om_b, sb = fb(om_b, torch.tensor(g), sb, 0.1)
        _close(np.asarray(om_a), om_b.numpy())
        for x, y in zip(sa, sb):
            _close(np.asarray(x), y.numpy())
    da, _ = R_cgpr.direction(jnp.asarray(g), sa)
    db, _ = T_cgpr.direction(torch.tensor(g), sb)
    _close(np.asarray(da), db.numpy())


def test_cgpr_batched_equals_per_window():
    rng = np.random.default_rng(4)
    g = torch.tensor(rng.normal(size=(4, 3)).astype(np.float32))
    om = torch.tensor(rng.normal(size=(4, 3)).astype(np.float32))
    st = T_cgpr.init_state(device="cpu", batch=(4,))
    alpha = torch.tensor([0.1, 0.2, 0.3, 0.4])
    om_b, st_b = T_cgpr.step(om, g, st, alpha)
    om_b, st_b = T_cgpr.step(om_b, g.flip(0), st_b, alpha)
    for i in range(4):
        s1 = T_cgpr.init_state(device="cpu")
        o1, s1 = T_cgpr.step(om[i], g[i], s1, float(alpha[i]))
        o1, s1 = T_cgpr.step(o1, g.flip(0)[i], s1, float(alpha[i]))
        assert torch.equal(o1, om_b[i])


def test_adaptive_matches_reference():
    v, vp = np.float32(1.02), np.float32(1.0)
    _close(np.asarray(R_adaptive.gain(v, vp)),
           T_adaptive.gain(torch.tensor(v), torch.tensor(vp)).numpy())
    for tau in (1e-3, 0.05):
        assert bool(R_adaptive.should_stay(v, vp, tau)) == \
            bool(T_adaptive.should_stay(torch.tensor(v), torch.tensor(vp),
                                        tau))
    for args in [(0,), (3, 3, 5), (5, 10, 5), (2, 10, 5), (5,), (5, None, 5),
                 (4, 4, None)]:
        assert T_adaptive.residence_verdict(*args) == \
            R_adaptive.residence_verdict(*args)

    def step(x):
        x = x + 0.5 * (1.0 - x)
        return x, x

    ja = R_adaptive.GainThresholdController(tau=0.01, max_iters=20).run(
        lambda x: step(x), jnp.float32(0.1), jnp.float32(0.1))
    tb = T_adaptive.GainThresholdController(tau=0.01, max_iters=20).run(
        lambda x: step(x), torch.tensor(0.1), torch.tensor(0.1))
    assert int(ja[2]) == int(tb[2])
    _close(np.asarray(ja[1]), tb[1].numpy())
    jb = R_adaptive.BudgetedGainThresholdController(tau=0.01, max_iters=20
                                                    ).run(
        lambda x: step(x), jnp.float32(0.1), jnp.float32(0.1), 3)
    tbb = T_adaptive.BudgetedGainThresholdController(tau=0.01, max_iters=20
                                                     ).run(
        lambda x: step(x), torch.tensor(0.1), torch.tensor(0.1),
        torch.tensor(3))
    assert int(jb[2]) == int(tbb[2]) == 3


@pytest.mark.parametrize("preset", ["POSTER", "BOXES"])
def test_make_sequence_bit_identical(preset):
    kw = dict(n_windows=3, events_per_window=2048)
    ja = r_events.make_sequence(dataclasses.replace(
        getattr(r_events, preset), **kw))
    tb = t_events.make_sequence(dataclasses.replace(
        getattr(t_events, preset), **kw), device="cpu")
    for f in ("x", "y", "t", "p", "valid"):
        a, b = np.asarray(getattr(ja[0], f)), getattr(tb[0], f).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    for a, b in zip(ja[1:], tb[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_window_helpers_match_reference():
    jcam = small_camera()
    ws = [random_window(n, cam=jcam, seed=n) for n in (100, 160, 128)]
    ja = r_events.batch_windows(ws, 200)
    tb = t_events.batch_windows([_win(w) for w in ws], 200)
    for f in ("x", "y", "t", "p", "valid"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(ja, f)))
    sl = t_events.window_slice(tb, 1)
    np.testing.assert_array_equal(sl.x.numpy(), np.asarray(ja.x[1]))
    with pytest.raises(ValueError):
        t_events.pad_window(_win(ws[1]), 10)


def test_structured_window_round_trip():
    """The reference test helper's simulator window converts exactly."""
    w, om = structured_window(512, cam=small_camera(), seed=2)
    tw = _win(w)
    np.testing.assert_array_equal(tw.t.numpy(), np.asarray(w.t))
    _close(np.asarray(w.t_ref), tw.t_ref.numpy(), tol=0)


def test_config_from_reference_and_engine_names():
    cfg = config_from_reference(R.CmaxConfig(engine="pallas_batched",
                                             engine_rb=4))
    assert cfg.engine == "cuda_batched" and cfg.engine_rb == 4
    assert cfg.stages == cmax_camel.CONFIG.stages
    assert cfg.camera == cmax_camel.CAMERA
    assert config_from_reference(R.CmaxConfig()).engine == "reference"
    fixed = config_from_reference(R.fixed_schedule_config())
    assert not fixed.adaptive and fixed.fixed_iters == (10, 10, 15)
    assert config_from_reference(R.full_resolution_config()).stages == \
        cmax_camel.FULLRES.stages
    cfg = config_from_reference(R.CmaxConfig(engine="pallas",
                                             engine_capacity=256))
    assert cfg.engine == "cuda" and cfg.engine_capacity == 256
    assert config_from_reference(R.CmaxConfig()).engine_capacity == \
        T.CmaxConfig().engine_capacity == 4096
    assert T.CmaxConfig().engine == "cuda_batched"
    assert T.CmaxConfig(engine="cuda").engine == "cuda"
    for bad in ("triton", "pallas_batched", "pallas"):
        with pytest.raises(ValueError):
            T.CmaxConfig(engine=bad)
    assert cmax_camel.EVENTS_PER_WINDOW == 40000


def test_result_to_numpy():
    res = T.WindowResult(
        omega=torch.ones(2, 3),
        stages=(T.StageTrace(*([torch.zeros(2)] * 5 + [torch.zeros(2, 4)]
                               + [torch.zeros(2, 3)] * 2)),))
    out = result_to_numpy(res)
    assert isinstance(out.omega, np.ndarray)
    assert out.stages[0].v_history.shape == (2, 4)


def test_tensor_factories_default_to_the_card():
    """make_sequence, the converters and init_state default to CUDA; with no
    card they raise instead of falling back to the CPU."""
    spec = dataclasses.replace(t_events.POSTER, n_windows=1,
                               events_per_window=64)
    calls = [lambda: t_events.make_sequence(spec),
             lambda: window_from_numpy([1.0], [1.0], [0.0], [1.0]),
             lambda: T_cgpr.init_state()]
    if torch.cuda.is_available():
        assert t_events.make_sequence(spec)[0].x.is_cuda
        assert T_cgpr.init_state().g_prev.is_cuda
    else:
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
        with pytest.raises(RuntimeError):
            t_events.make_sequence(spec, device="cuda")
