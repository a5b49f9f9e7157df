"""The benchmark's frozen reference against the JAX package's estimator,
on the CPU at a small size. The only file of the benchmark that imports
the JAX package (`repro`); it runs no part of the port."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import cgpr as jcgpr  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import sorting as jsort  # noqa: E402
from repro.core import types as jtypes  # noqa: E402

from cmax_bench.gen import events  # noqa: E402
from cmax_bench.reference import cmax as ref  # noqa: E402

SENSOR = events.Sensor(64, 48, 53.0, 53.0, 32.0, 24.0)
CAM = jtypes.Camera(64, 48, 53.0, 53.0, 32.0, 24.0)
CFG = jtypes.CmaxConfig(camera=CAM, engine="reference")
SCHED = ref.Schedule(64, 48, 53.0, 53.0, 32.0, 24.0, tuple(
    ref.Stage(s.scale, s.tau, s.max_iters, s.blur_taps, s.blur_sigma,
              s.keep_ratio, s.step_scale) for s in CFG.stages),
    CFG.step_size)


@pytest.fixture(scope="module")
def windows():
    torch.set_num_threads(1)
    r = events.record(SENSOR, events.Scene(n_features=150), 8, 3000,
                      events.generator(2**31 + 19, 0, "cpu"), "cpu")
    t_ref = torch.where(r.valid, r.t, torch.inf).amin(1, keepdim=True)
    return r, (r.x, r.y, r.t - t_ref, r.p, r.valid)


def jwin(r, k):
    a = lambda t: jnp.asarray(t[k].numpy())
    return jtypes.EventWindow(a(r.x), a(r.y), a(r.t), a(r.p), a(r.valid))


def test_alg3_keeps_the_same_events(windows):
    r, ev = windows
    for si, st in enumerate(CFG.stages):
        mine = ref.retained(ev, r.omega_imu, SCHED, SCHED.stages[si])
        for k in range(r.x.shape[0]):
            want = jsort.sort_events(jwin(r, k),
                                     jnp.asarray(r.omega_imu[k].numpy()),
                                     CAM, st).weights
            assert np.array_equal(mine[k].numpy(), np.asarray(want)), (si, k)


def test_engine_pass_within_the_reference_bars(windows):
    # variance rtol 1e-4, gradient atol 1e-4 of its largest component
    # (tests/test_megakernel.py:80-84)
    r, ev = windows
    for si, st in enumerate(CFG.stages):
        w = ref.retained(ev, r.omega_imu, SCHED, SCHED.stages[si])
        for om in (r.omega_imu, r.omega_true, r.omega_imu * 0.5):
            v, g = ref.engine_pass(ev, w, om, SCHED, SCHED.stages[si])
            jeng = jpipe.make_engine_pass(CAM, st, engine="reference")
            for k in range(r.x.shape[0]):
                jv, jg = jeng(jwin(r, k), jnp.asarray(w[k].numpy()),
                              jnp.asarray(om[k].numpy()))
                jv, jg = float(jv), np.asarray(jg)
                assert abs(float(v[k]) - jv) <= 1e-4 * abs(jv)
                scale = np.abs(jg).max()
                assert np.abs(g[k].numpy() - jg).max() <= 1e-4 * scale


def test_one_cgpr_step_matches():
    g = torch.tensor([[0.3, -0.2, 0.1]])
    gp = torch.tensor([[0.1, 0.4, -0.3]])
    dp = torch.tensor([[0.2, 0.1, 0.0]])
    om = torch.tensor([[1.0, -2.0, 0.5]])
    alpha = torch.tensor([0.16])
    for first in (True, False):
        mine, _ = ref._cg_step(om, g, gp, dp, torch.tensor([first]), alpha)
        st = jcgpr.CgprState(jnp.asarray(gp[0].numpy()),
                             jnp.asarray(dp[0].numpy()), jnp.asarray(first))
        want, _ = jcgpr.step(jnp.asarray(om[0].numpy()),
                             jnp.asarray(g[0].numpy()), st, 0.16)
        np.testing.assert_allclose(mine[0].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_whole_estimates_match_while_the_decisions_are_clear(windows):
    """Three stages of three iterations each, from the IMU warm start,
    with no gain test (tau = 0): every decision is the accept or reject
    of a large early step, far from the float32 rounding that sways the
    late decisions of a converging window, so the two estimators take the
    same path and agree to rounding. (Run to convergence, their accept
    and stop decisions turn on the last bits, and a window may take a
    step more or less in one of them: the benchmark's check reads that
    spread as a median, PERF.md.)"""
    import dataclasses
    r, ev = windows
    stages = tuple(dataclasses.replace(st, tau=0.0, max_iters=3)
                   for st in CFG.stages)
    cfg = dataclasses.replace(CFG, stages=stages)
    sched = dataclasses.replace(SCHED, stages=tuple(
        dataclasses.replace(st, tau=0.0, max_iters=3)
        for st in SCHED.stages))
    om, it = ref.estimate(ev, r.omega_imu, sched)
    res = jpipe.estimate_batch(
        jtypes.EventWindow(*(jnp.asarray(a.numpy()) for a in
                             (r.x, r.y, r.t, r.p, r.valid))),
        jnp.asarray(r.omega_imu.numpy()), cfg)
    want = np.asarray(res.omega)
    np.testing.assert_allclose(om.numpy(), want, rtol=0, atol=1e-4)
    assert np.array_equal(it.numpy(), np.stack(
        [np.asarray(s.iters) for s in res.stages], 1))
    # and the steps moved the estimate: not a trivially equal start
    assert np.abs(want - r.omega_imu.numpy()).max() > 1e-2
