"""The port's batched engine pass (binning prologue + the kernel's plain
PyTorch version, which is what runs for CPU tensors) against the JAX
package on the CPU.

  * against the JAX `reference` engine at every (scale, k) stage pair;
  * against the JAX `pallas_batched` megakernel (interpret mode) at a
    capacity where it spills nothing — and against the reference where
    that kernel does spill, since the port has no capacity;
  * the port's own bits: a window's stats are identical at B=1 and in any
    slot of B=4, dead slots give finite zeros.

Bars are `tests/test_megakernel.py`'s: variance rtol=1e-4, max-normalized
gradient atol=1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.pipeline import make_engine_pass as r_make_engine_pass
from repro.kernels import batched_engine_pass as r_batched_engine_pass

import repro_torch.core as T
from repro_torch.convert import window_from_numpy
from repro_torch.kernels import megakernel, ops
from helpers import random_window, small_camera

torch.set_num_threads(1)

STAGES = [(0.25, 3), (0.5, 5), (1.0, 9)]


def _stack(wins):
    return R.EventWindow(*[jnp.stack([getattr(w, f) for w in wins])
                           for f in ("x", "y", "t", "p", "valid")])


def _win(w):
    return window_from_numpy(np.asarray(w.x), np.asarray(w.y),
                             np.asarray(w.t), np.asarray(w.p),
                             np.asarray(w.valid), device="cpu")


def _cam(jcam):
    return T.Camera(**dataclasses.asdict(jcam))


def _assert_engine_close(v, g, v_ref, g_ref):
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref), rtol=1e-4)
    s = float(np.max(np.abs(np.asarray(g_ref)))) + 1e-12
    np.testing.assert_allclose(np.asarray(g) / s, np.asarray(g_ref) / s,
                               atol=1e-4)


def _batch(n=400, b=3, valid_frac=0.9, seed=10):
    jcam = small_camera()
    wins = [random_window(n, cam=jcam, seed=seed + i, valid_frac=valid_frac)
            for i in range(b)]
    rng = np.random.default_rng(seed)
    om = rng.uniform(-1.5, 1.5, (b, 3)).astype(np.float32)
    wts = (rng.random((b, n)) < 0.7).astype(np.float32)
    return jcam, _stack(wins), om, wts


@pytest.mark.parametrize("scale,k", STAGES)
def test_engine_matches_reference_engine(scale, k):
    jcam, jb, om, wts = _batch()
    sigma = 0.5 + 0.25 * k / 3
    stage = R.StageConfig(scale=scale, tau=1e-3, max_iters=3, blur_taps=k,
                          blur_sigma=sigma, keep_ratio=scale)
    v_ref, g_ref = jax.jit(jax.vmap(r_make_engine_pass(
        jcam, stage, jnp.float32)))(jb, jnp.asarray(wts), jnp.asarray(om))
    v, g, _ = ops.batched_engine_pass(_win(jb), torch.tensor(om), _cam(jcam),
                                      scale, k, sigma,
                                      weights=torch.tensor(wts))
    _assert_engine_close(v.numpy(), g.numpy(), v_ref, g_ref)
    # the port's own reference engine agrees too
    v2, g2 = T.make_engine_pass(_cam(jcam), T.StageConfig(
        **dataclasses.asdict(stage)))(_win(jb), torch.tensor(wts),
                                      torch.tensor(om))
    _assert_engine_close(v2.numpy(), g2.numpy(), v_ref, g_ref)


@pytest.mark.parametrize("scale,k", STAGES)
def test_engine_matches_pallas_batched_at_zero_spill(scale, k):
    jcam, jb, om, wts = _batch(seed=30)
    v_mk, g_mk, spilled = r_batched_engine_pass(
        jb, jnp.asarray(om), jcam, scale, k, 1.0, weights=jnp.asarray(wts),
        capacity=2048, chunk=128)
    assert int(jnp.sum(spilled)) == 0
    v, g, _ = ops.batched_engine_pass(_win(jb), torch.tensor(om), _cam(jcam),
                                      scale, k, 1.0,
                                      weights=torch.tensor(wts))
    _assert_engine_close(v.numpy(), g.numpy(), v_mk, g_mk)


def test_no_capacity_where_the_tpu_kernel_spills():
    """At a capacity where `pallas_batched` drops taps, the port (which has
    no capacity) still equals the reference engine."""
    jcam = small_camera()
    jb = _stack([random_window(400, cam=jcam, seed=7)])
    om = jnp.array([[0.3, -0.6, 1.4]], jnp.float32)
    _, _, spilled = r_batched_engine_pass(jb, om, jcam, 1.0, 9, 1.0,
                                          capacity=128, chunk=128)
    assert int(spilled[0]) > 0
    stage = R.StageConfig(scale=1.0, tau=1e-3, max_iters=3, blur_taps=9,
                          blur_sigma=1.0, keep_ratio=1.0)
    v_ref, g_ref = jax.jit(jax.vmap(r_make_engine_pass(
        jcam, stage, jnp.float32)))(jb, jnp.ones((1, 400), jnp.float32), om)
    v, g, _ = ops.batched_engine_pass(_win(jb),
                                      torch.tensor(np.asarray(om)),
                                      _cam(jcam), 1.0, 9, 1.0)
    _assert_engine_close(v.numpy(), g.numpy(), v_ref, g_ref)


def test_bin_taps_csr_layout():
    """Records are grouped by destination pixel, every live tap is kept, and
    each record's pixel is its event's warped tap pixel."""
    jcam, jb, om, wts = _batch(n=300, b=2, seed=40)
    cam = _cam(jcam)
    ev = _win(jb)
    bins = ops.bin_taps(ev, torch.tensor(om), torch.tensor(wts), cam, 0.5)
    Hs, Ws = cam.grid(0.5)
    w = T.warp_events(ev, torch.tensor(om), cam, 0.5)
    live = w.in_range & (torch.tensor(wts) * ev.p != 0)
    N = ev.n
    for b in range(2):
        off = bins.pix_off[b].long()
        assert int(off[-1]) == 4 * int(live[b].sum())
        assert bool((off[1:] >= off[:-1]).all())
        for p in torch.nonzero(off[1:] > off[:-1]).flatten()[:40].tolist():
            for code in bins.rec[b, off[p]:off[p + 1]].tolist():
                tap, e = divmod(code, N)
                dy, dx = tap // 2, tap % 2
                assert bool(live[b, e])
                assert (int(w.y0[b, e]) + dy) * Ws + int(w.x0[b, e]) + dx == p


def test_bin_taps_keys_are_each_records_pixel():
    """The prologue's sorted keys, which the kernel reads for a record's
    pixel, agree with the CSR offsets at every stage, and the plain version
    (which finds each pixel from the offsets) does not read them."""
    jcam, jb, om, wts = _batch(n=300, b=2, seed=41)
    cam = _cam(jcam)
    ev = _win(jb)
    for scale, k in STAGES:
        bins = ops.bin_taps(ev, torch.tensor(om), torch.tensor(wts), cam,
                            scale)
        Hs, Ws = cam.grid(scale)
        P = Hs * Ws
        assert bins.key.dtype == torch.int32 and bins.key.is_contiguous()
        assert bins.key.shape == bins.rec.shape
        j = torch.arange(bins.key.shape[1])
        for b in range(2):
            off = bins.pix_off[b].long()
            live = j < off[P]
            pix = torch.searchsorted(off, j, right=True) - 1
            assert torch.equal(bins.key[b][live].long(), pix[live])
            assert bool((bins.key[b][~live] == P).all())
        fir = T.gaussian_taps(k, 1.0)
        kw = dict(H=Hs, W=Ws, rb=8, scale=scale, fx=cam.fx, fy=cam.fy,
                  cx=cam.cx, cy=cam.cy)
        out = megakernel.megakernel_stats_plain(*bins, torch.tensor(om),
                                                fir, **kw)
        blind = megakernel.megakernel_stats_plain(
            *bins._replace(key=torch.zeros_like(bins.key)),
            torch.tensor(om), fir, **kw)
        assert torch.equal(out, blind)


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 13, 15])
def test_launch_config_fits_every_stage(k):
    """The kernel's grid at every stage of the paper's configuration, for
    every blur length the kernel takes: the slab block's shared memory stays
    within what a Hopper block may use, the vote's pixel ranges cover the
    grid with at least MIN_VOTE_BLOCKS blocks per window where the grid
    allows, and the slabs cover every row."""
    from repro_torch.configs.cmax_camel import CONFIG
    rb = CONFIG.engine_rb
    for st in CONFIG.stages:
        H, W = st.grid(CONFIG.camera)
        cfg = megakernel.launch_config(H, W, k, rb)
        assert cfg.smem == 16 * (rb + k - 1) * W <= megakernel.SMEM_LIMIT
        vp = cfg.vote_pixels
        assert 32 <= vp <= megakernel.MAX_VOTE_PIXELS and vp & (vp - 1) == 0
        assert vp * (cfg.vote_blocks - 1) < H * W <= vp * cfg.vote_blocks
        assert cfg.vote_blocks >= megakernel.MIN_VOTE_BLOCKS or vp == 32
        assert rb * (cfg.n_slabs - 1) < H <= rb * cfg.n_slabs
    # the paper's grids, as PERF.md states them
    grids = [megakernel.launch_config(*st.grid(CONFIG.camera), 9, rb)
             for st in CONFIG.stages]
    assert [(g.vote_pixels, g.vote_blocks, g.n_slabs) for g in grids] == \
        [(64, 43, 6), (256, 43, 12), (256, 169, 23)]
    assert megakernel.launch_config(180, 240, 15, rb).smem == 84480


def test_slot_independence_bitwise():
    """The port's stats for a window are bit-identical at B=1 and in every
    slot of a B=4 batch."""
    jcam, jb, om, wts = _batch(n=300, b=4, seed=20)
    cam = _cam(jcam)
    ev = _win(jb)
    out_b = ops.batched_engine_stats(ev, torch.tensor(om), cam, 0.5, 5, 0.75,
                                     weights=torch.tensor(wts)).stats
    for i in range(4):
        out_1 = ops.batched_engine_stats(
            ev.map(lambda a: a[i:i + 1]), torch.tensor(om[i:i + 1]), cam,
            0.5, 5, 0.75, weights=torch.tensor(wts[i:i + 1])).stats
        assert torch.equal(out_1[0], out_b[i])
    again = ops.batched_engine_stats(ev, torch.tensor(om), cam, 0.5, 5, 0.75,
                                     weights=torch.tensor(wts)).stats
    assert torch.equal(again, out_b)


def test_padded_and_dead_slots():
    """An all-invalid window gives finite zero stats and leaves the live
    slots' bits untouched."""
    jcam = small_camera()
    cam = _cam(jcam)
    live = [random_window(256, cam=jcam, seed=31 + i) for i in range(2)]
    dead = random_window(256, cam=jcam, seed=33, valid_frac=0.0)
    om = torch.tensor([[0.4, 0.1, -0.8], [1.0, -1.0, 0.5], [0.2, 0.2, 0.2]])
    full = ops.batched_engine_stats(
        _win(_stack(live + [random_window(256, cam=jcam, seed=99)])), om,
        cam, 1.0, 9, 1.0).stats
    holey = ops.batched_engine_stats(_win(_stack(live + [dead])), om, cam,
                                     1.0, 9, 1.0).stats
    for i in range(2):
        assert torch.equal(full[i], holey[i])
    assert bool(torch.isfinite(holey[2]).all())
    assert float(holey[2].abs().max()) == 0.0


def test_batched_api_returns_the_references_structure():
    """`batched_engine_stats` returns `BatchedEngineOut(stats, spilled)` and
    `batched_engine_pass` a triple, as the reference's; the CSR kernel
    drops no tap, so `spilled` is (B,) int32 zeros."""
    jcam, jb, om, wts = _batch(n=300, b=3, seed=21)
    cam = _cam(jcam)
    args = (_win(jb), torch.tensor(om), cam, 0.5, 5, 0.75)
    out = ops.batched_engine_stats(*args, weights=torch.tensor(wts))
    assert isinstance(out, ops.BatchedEngineOut)
    assert out._fields == ("stats", "spilled")
    assert out.stats.shape == (3, 8)
    assert out.spilled.dtype == torch.int32 and out.spilled.shape == (3,)
    assert not bool(out.spilled.any())
    v, g, spilled = ops.batched_engine_pass(*args, weights=torch.tensor(wts))
    assert v.shape == (3,) and g.shape == (3, 3)
    assert torch.equal(spilled, out.spilled)
    vs, gs = T.stats_to_objective(out.stats, cam.grid(0.5)[0]
                                  * cam.grid(0.5)[1])
    assert torch.equal(v, vs) and torch.equal(g, gs)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    jcam, jb, om, wts = _batch(n=200, b=2, seed=50)
    cam = _cam(jcam)
    bins = ops.bin_taps(_win(jb), torch.tensor(om), torch.tensor(wts), cam,
                        1.0)
    fir = T.gaussian_taps(9, 1.0)
    kw = dict(H=cam.grid(1.0)[0], W=cam.grid(1.0)[1], rb=8, scale=1.0,
              fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
    before = megakernel.megakernel_stats.launches
    out = megakernel.megakernel_stats(*bins, torch.tensor(om), fir, **kw)
    assert megakernel.megakernel_stats.launches == before
    assert torch.equal(out, megakernel.megakernel_stats_plain(
        *bins, torch.tensor(om), fir, **kw))


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch):
    """The library name carries a hash of the source and flags, and without
    a CUDA toolkit the build raises instead of falling back."""
    from repro_torch.kernels import _build
    target = _build._target("megakernel")
    assert target.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-g"])
    assert _build._target("megakernel") != target
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda p: _build.CSRC / "absent")
    with pytest.raises(RuntimeError):
        _build._nvcc()
