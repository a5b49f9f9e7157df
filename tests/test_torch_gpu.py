"""The engine-pass kernel on the card: builds from the repo's source, agrees
with its plain version, gives the same bits run to run and whatever batch a
window rides in, and carries the estimation pipeline.

Every test here is marked `gpu` and skips where there is no sm_90 card. The
file imports no JAX (the card's machine has none); run it there with

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.pipeline import lockstep_passes
from repro_torch.data import events
from repro_torch.kernels import megakernel, ops

pytestmark = pytest.mark.gpu

CAM = T.Camera()
STAGES = [(0.25, 3, 0.5), (0.5, 5, 0.75), (1.0, 9, 1.0)]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def windows(cuda):
    spec = dataclasses.replace(events.POSTER, n_windows=4,
                               events_per_window=8192, jerk_prob=0.0)
    wins, om_true, om_imu = events.make_sequence(spec, device=cuda)
    return wins, om_imu, om_true


def _bins(windows, scale):
    wins, om, _ = windows
    w = torch.ones_like(wins.x)
    return ops.bin_taps(wins, om, w, CAM, scale), om


@pytest.mark.parametrize("scale,k,sigma", STAGES)
def test_kernel_matches_plain_and_is_bitwise_stable(windows, scale, k,
                                                    sigma):
    bins, om = _bins(windows, scale)
    Hs, Ws = CAM.grid(scale)
    fir = T.gaussian_taps(k, sigma, device=om.device)
    kw = dict(H=Hs, W=Ws, rb=8, scale=scale, fx=CAM.fx, fy=CAM.fy,
              cx=CAM.cx, cy=CAM.cy)
    before = megakernel.megakernel_stats.launches
    out = megakernel.megakernel_stats(*bins, om, fir, **kw)
    again = megakernel.megakernel_stats(*bins, om, fir, **kw)
    torch.cuda.synchronize()
    assert megakernel.megakernel_stats.launches == before + 2
    assert torch.equal(out, again)
    plain = megakernel.megakernel_stats_plain(*bins, om, fir, **kw)
    v, g = T.stats_to_objective(out, Hs * Ws)
    vp, gp = T.stats_to_objective(plain, Hs * Ws)
    torch.testing.assert_close(v, vp, rtol=1e-4, atol=0)
    s = gp.abs().max()
    torch.testing.assert_close(g / s, gp / s, rtol=0, atol=1e-4)
    for i in range(out.shape[0]):
        one = megakernel.megakernel_stats(
            *[a[i:i + 1].contiguous() for a in bins], om[i:i + 1], fir, **kw)
        assert torch.equal(one[0], out[i])


def test_wrapper_validates_inputs(windows):
    bins, om = _bins(windows, 1.0)
    fir = T.gaussian_taps(9, 1.0, device=om.device)
    kw = dict(H=180, W=240, rb=8, scale=1.0, fx=CAM.fx, fy=CAM.fy,
              cx=CAM.cx, cy=CAM.cy)
    with pytest.raises(ValueError):
        megakernel.megakernel_stats(bins.x.double(), *bins[1:], om, fir, **kw)
    with pytest.raises(ValueError):
        megakernel.megakernel_stats(*bins, om, fir, **dict(kw, W=2000))


def _random_batch(cam, n, seeds, device):
    """Windows drawn as tests/helpers.py::random_window draws them."""
    cols = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        x = rng.uniform(2, cam.width - 3, n).round().astype(np.float32)
        y = rng.uniform(2, cam.height - 3, n).round().astype(np.float32)
        t = np.sort(rng.uniform(0, 0.03, n)).astype(np.float32)
        p = rng.choice([-1.0, 1.0], n).astype(np.float32)
        valid = rng.random(n) < 1.0
        cols.append((x, y, t, p, valid))
    return T.EventWindow(*[torch.tensor(np.stack(c), device=device)
                           for c in zip(*cols)])


def test_pipeline_on_the_card_matches_reference_engine(cuda):
    """tests/test_megakernel.py::test_estimate_batch_matches_reference_engine
    on the card: the same setup and bars, the kernel path against the
    port's reference engine."""
    cam = T.Camera(width=64, height=48, fx=53.0, fy=53.0, cx=32.0, cy=24.0)
    stages = tuple(dataclasses.replace(s, max_iters=3)
                   for s in T.CmaxConfig().stages)
    cfg = T.CmaxConfig(camera=cam, stages=stages)
    batch = _random_batch(cam, 256, [40, 41, 42], cuda)
    om0 = torch.tensor([[0.1, -0.05, 0.2]] * 3, device=cuda)
    before = megakernel.megakernel_stats.launches
    res = T.estimate_batch(batch, om0, cfg)
    assert megakernel.megakernel_stats.launches - before == \
        lockstep_passes(res)
    ref = T.estimate_batch(batch, om0, dataclasses.replace(
        cfg, engine="reference"))
    again = T.estimate_batch(batch, om0, dataclasses.replace(
        cfg, engine="reference"))
    assert torch.equal(ref.omega, again.omega)   # the oracle is deterministic
    torch.testing.assert_close(res.omega, ref.omega, rtol=0, atol=5e-4)
    for st_k, st_r in zip(res.stages, ref.stages):
        assert st_k.iters.tolist() == st_r.iters.tolist()
        torch.testing.assert_close(st_k.v_final, st_r.v_final, rtol=1e-3,
                                   atol=0)


def test_pipeline_on_the_card_tracks_and_is_slot_independent(windows):
    """POSTER windows through the kernel path: every lockstep pass is one
    launch, the estimates track the ground truth, and a window's whole
    result has the same bits alone as in its slot of the batch."""
    wins, om, om_true = windows
    cfg = dataclasses.replace(T.CmaxConfig(), stages=tuple(
        dataclasses.replace(s, max_iters=6) for s in T.CmaxConfig().stages))
    before = megakernel.megakernel_stats.launches
    res = T.estimate_batch(wins, om, cfg)
    assert megakernel.megakernel_stats.launches - before == \
        lockstep_passes(res)
    err = (res.omega - om_true).norm(dim=-1)
    assert float(err.pow(2).mean().sqrt()) < 0.5
    one = T.estimate_batch(wins.map(lambda a: a[2:3]), om[2:3], cfg)
    assert torch.equal(one.omega[0], res.omega[2])
    for st1, stb in zip(one.stages, res.stages):
        assert torch.equal(st1.v_final[0], stb.v_final[2])
