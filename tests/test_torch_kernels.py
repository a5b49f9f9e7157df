"""The port's per-window engine (`"cuda"`: tile accumulation, streaming blur
statistics and the wrappers around them, which run their kernels' plain
PyTorch versions for CPU tensors) against the JAX package's `"pallas"`
path on the CPU, whose Pallas kernels run in interpret mode as
`tests/test_kernels.py` runs them.

Bars are the reference's own (`tests/test_kernels.py`,
`tests/test_kernel_spill.py`): channel stacks rtol=atol=1e-4, blur
statistics rtol=atol=1e-3, the engine pass at variance rtol=1e-4 and
gradient rtol=1e-3, atol=1e-6; `spilled` exactly equal.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels import blur_stats as r_blur_stats
from repro.kernels import fused_engine_pass as r_fused_engine_pass
from repro.kernels import iwe_accum as r_iwe_accum
from repro.kernels.iwe_accum import tile_accumulate as r_tile_accumulate
from repro.kernels.ref import blur_stats_ref as r_blur_stats_ref

import repro_torch.core as T
from repro_torch.convert import window_from_numpy
from repro_torch.kernels import (_build, blur_stats_streaming,
                                 blur_stats_streaming_plain, ops, ref,
                                 tile_accumulate, tile_accumulate_plain)
from helpers import random_window, small_camera

torch.set_num_threads(1)


def _cam(jcam):
    return T.Camera(**dataclasses.asdict(jcam))


def _win(w):
    return window_from_numpy(np.asarray(w.x), np.asarray(w.y),
                             np.asarray(w.t), np.asarray(w.p),
                             np.asarray(w.valid), device="cpu")


def _stack(wins):
    return T.EventWindow(*[torch.stack([getattr(w, f) for w in wins])
                           for f in ("x", "y", "t", "p", "valid")])


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# tile_accumulate: identical inputs through both kernels
# ----------------------------------------------------------------------


def _as_runs(pix, deltas, cap):
    """The packed (B, T, CAP) layout as runs: tile t of window b is the run
    [(b T + t) CAP, (b T + t + 1) CAP) of the flattened slots."""
    B, T = pix.shape[:2]
    offsets = (torch.arange(B).view(B, 1) * T + torch.arange(T + 1)) * cap
    return (pix.reshape(B, T * cap), deltas.reshape(B, T * cap, 4),
            offsets.to(torch.int32))


def _ragged_runs(pix, deltas, rng):
    """Runs of random lengths (empty ones included) cut from the packed
    tiles' slots, each window's runs followed by slots that are in none,
    and the packed (B, T, CAP) tiles that hold each run at the front of its
    tile: (runs, packed)."""
    B, T, cap = pix.shape
    lens = rng.integers(0, cap + 1, size=(B, T))
    lens[0, 1] = 0
    lens[1, -1] = 0
    L = T * cap + 37
    flat_pix = torch.full((B, L), 5, dtype=torch.int32)   # in no run
    flat_d = torch.ones((B, L, 4), dtype=deltas.dtype)
    offsets = torch.zeros((B, T + 1), dtype=torch.int32)
    packed_pix = torch.full_like(pix, -1)
    packed_d = torch.zeros_like(deltas)
    for b in range(B):
        at = 0
        for t in range(T):
            n = int(lens[b, t])
            offsets[b, t] = b * L + at
            flat_pix[b, at:at + n] = pix[b, t, :n]
            flat_d[b, at:at + n] = deltas[b, t, :n]
            packed_pix[b, t, :n] = pix[b, t, :n]
            packed_d[b, t, :n] = deltas[b, t, :n]
            at += n
        offsets[b, T] = b * L + at
    return (flat_pix, flat_d, offsets), (packed_pix, packed_d)


def _packed_tiles(dtype, rng, n_tiles=3, cap=384, p_tile=1024):
    """Two windows of packed tiles, slots in any order with empty slots
    anywhere: (pix, deltas) as numpy and as torch."""
    pix = rng.integers(-1, p_tile, size=(2, n_tiles, cap)).astype(np.int32)
    pix[:, :, ::7] = -1
    deltas = rng.normal(size=(2, n_tiles, cap, 4)).astype(np.float32)
    return pix, deltas, torch.tensor(pix), \
        torch.tensor(deltas).to(getattr(torch, dtype))


def _hold_to_reference(out, pix, deltas, dtype):
    n_tiles, cap = pix.shape[1:]
    p_tile = out.shape[2]
    assert out.shape == (2, n_tiles, p_tile, 4) and out.dtype == torch.float32
    for b in range(2):
        expect = r_tile_accumulate(
            jnp.asarray(pix[b]), jnp.asarray(deltas[b]).astype(dtype),
            n_tiles=n_tiles, cap=cap, p_tile=p_tile)
        _close(out[b].numpy(), expect, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_accumulate_plain_matches_reference(dtype):
    """The reference's packed tiles as runs, tile t of window b at offsets
    (b T + t) CAP; bf16 deltas are the same bf16 values on both sides and
    accumulate in f32."""
    pix, deltas, tp, td = _packed_tiles(dtype, np.random.default_rng(11))
    out = tile_accumulate_plain(*_as_runs(tp, td, pix.shape[2]), p_tile=1024)
    _hold_to_reference(out, pix, deltas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_accumulate_plain_ragged_runs(dtype):
    """Runs of random lengths, empty ones included, with slots in no run
    between the windows: the bits of the same taps at the front of packed
    tiles (as runs of CAP), and the reference's sums of those tiles."""
    rng = np.random.default_rng(11)
    _, _, tp, td = _packed_tiles(dtype, rng)
    (rp, rd, off), (pp, pd) = _ragged_runs(tp, td, rng)
    out = tile_accumulate_plain(rp, rd, offsets=off, p_tile=1024)
    assert torch.equal(
        out, tile_accumulate_plain(*_as_runs(pp, pd, pp.shape[2]),
                                   p_tile=1024))
    _hold_to_reference(out, pp.numpy(), pd.float().numpy(), dtype)


@pytest.mark.parametrize("fault", ["decreasing", "past_the_end",
                                   "negative"])
def test_tile_accumulate_plain_rejects_bad_offsets(fault):
    """The runs' offsets, flattened, are non-decreasing and within
    [0, B L]; the plain version (the CPU path) refuses others."""
    pix, deltas, off = _as_runs(torch.zeros((2, 3, 8), dtype=torch.int32),
                                torch.ones((2, 3, 8, 4)), 8)
    bad = off.clone()
    if fault == "decreasing":
        bad[0, 2] = bad[0, 1] - 1
    elif fault == "past_the_end":
        bad[1, 3] = pix.numel() + 1
    else:
        bad[0, 0] = -1
    assert torch.equal(tile_accumulate(pix, deltas, offsets=off, p_tile=64),
                       tile_accumulate_plain(pix, deltas, offsets=off,
                                             p_tile=64))
    with pytest.raises(ValueError, match="non-decreasing"):
        tile_accumulate(pix, deltas, offsets=bad, p_tile=64)


# ----------------------------------------------------------------------
# blur_stats: the shape, k/sigma and row-block sweeps of test_kernels.py
# ----------------------------------------------------------------------

BLUR_CASES = ([(hw, k, sigma, 16)
               for hw in [(48, 64), (45, 60), (90, 120), (180, 240)]
               for k, sigma in [(3, 0.5), (5, 0.75), (9, 1.0)]]
              + [((45, 60), 9, 1.0, rb) for rb in (4, 16, 64)])


@pytest.mark.parametrize("hw,k,sigma,rb", BLUR_CASES)
def test_blur_stats_matches_reference(hw, k, sigma, rb):
    """A batch of two stacks; the first against the JAX kernel and both
    against the oracles."""
    H, W = hw
    rng = np.random.default_rng(H * k)
    ch = rng.normal(size=(2, 4, H, W)).astype(np.float32)
    out = ops.blur_stats(torch.tensor(ch), k, sigma, rb=rb).numpy()
    assert out.shape == (2, 8)
    _close(out[0], r_blur_stats(jnp.asarray(ch[0]), k, sigma, rb=rb), 1e-3)
    for b in range(2):
        _close(out[b], r_blur_stats_ref(jnp.asarray(ch[b]), k, sigma), 1e-3)
        _close(out[b], ref.blur_stats_ref(torch.tensor(ch[b]), k, sigma),
               1e-3)


def test_blur_stats_impulse():
    """An interior impulse: S1 equals the kernel mass (=1), as in JAX."""
    ch = torch.zeros((4, 32, 32))
    ch[0, 16, 16] = 1.0
    out = ops.blur_stats(ch, 9, 1.0).numpy()
    expect = np.asarray(r_blur_stats(jnp.asarray(ch.numpy()), 9, 1.0))
    _close(out, expect, 1e-3)
    assert out[0] == pytest.approx(1.0, rel=1e-4)
    assert out[1] > 0
    np.testing.assert_allclose(out[2:], 0.0, atol=1e-6)


# ----------------------------------------------------------------------
# iwe_accum: tile sweep, weights (with and without spill), and exactness
# at any capacity
# ----------------------------------------------------------------------

# (n, seed, omega, scale, tile, capacity, weights)
IWE_CASES = (
    [(700, 5, (-0.5, 0.7, 0.3), 1.0, tile, 2800, False)
     for tile in [(8, 128), (16, 128), (4, 256)]]
    + [(256, 7, (0.3, -0.2, 0.4), 0.5, (8, 128), cap, True)
       for cap in (64, 1024)]
    + [(1024, 3, (0.6, -0.3, 0.9), 0.5, (8, 128), cap, False)
       for cap in (8, 32, 128, 1024)])


@pytest.mark.parametrize("n,seed,omega,scale,tile,capacity,weighted",
                         IWE_CASES)
def test_iwe_accum_matches_reference(n, seed, omega, scale, tile, capacity,
                                     weighted):
    jcam = small_camera()
    ev = random_window(n, cam=jcam, seed=seed)
    om = np.asarray(omega, np.float32)
    wts = (np.arange(n) % 3 == 0).astype(np.float32) if weighted else None
    expect = r_iwe_accum(ev, jnp.asarray(om), jcam, scale,
                         weights=None if wts is None else jnp.asarray(wts),
                         tile=tile, capacity=capacity)
    out = ops.iwe_accum(_win(ev), torch.tensor(om), _cam(jcam), scale,
                        weights=None if wts is None else torch.tensor(wts),
                        tile=tile, capacity=capacity)
    assert int(out.spilled) == int(expect.spilled)
    if capacity < 1024:
        # zero-weight taps of in-range events occupy slots and count
        assert int(out.spilled) > 0
    _close(out.channels.numpy(), expect.channels, 1e-4)
    _close(out.channels.numpy(),
           ref.iwe_accum_ref(_win(ev), torch.tensor(om), _cam(jcam), scale,
                             None if wts is None else torch.tensor(wts)),
           1e-4)


def test_iwe_accum_bf16_deltas_close():
    """bf16 deltas with f32 accumulation, at the reference's bf16 bar."""
    jcam = small_camera()
    ev = random_window(512, cam=jcam, seed=6)
    om = np.array([0.2, 0.5, -0.6], np.float32)
    out = ops.iwe_accum(_win(ev), torch.tensor(om), _cam(jcam), 1.0,
                        capacity=2048, dtype=torch.bfloat16)
    assert int(out.spilled) == 0 and out.channels.dtype == torch.float32
    _close(out.channels.numpy(),
           ref.iwe_accum_ref(_win(ev), torch.tensor(om), _cam(jcam), 1.0),
           0.05)


def test_iwe_accum_batch_equals_windows_bitwise():
    """A (B, N) batch is one pass; each window's channels and spill count
    are bit-identical to its own (N,) pass, spill fold-back included."""
    jcam = small_camera()
    cam = _cam(jcam)
    wins = [_win(random_window(600, cam=jcam, seed=s, valid_frac=0.8))
            for s in (20, 21, 22)]
    om = torch.tensor([[0.6, -0.3, 0.9], [0.1, 0.2, -0.4], [0.0, 0.0, 0.0]])
    out = ops.iwe_accum(_stack(wins), om, cam, 0.25, capacity=64)
    for i, w in enumerate(wins):
        one = ops.iwe_accum(w, om[i], cam, 0.25, capacity=64)
        assert int(one.spilled) == int(out.spilled[i]) > 0
        assert torch.equal(one.channels, out.channels[i])


@pytest.mark.parametrize("capacity", [8, 64, 1024, "above"])
def test_iwe_accum_capacity_moves_only_spilled(capacity):
    """The kernel reads each tile's whole run: the channels have the same
    bits at any capacity, and the capacity moves only `spilled`, which
    still equals the reference's count."""
    jcam = small_camera()
    ev = random_window(1024, cam=jcam, seed=3)
    om = np.array([0.6, -0.3, 0.9], np.float32)
    win, cam = _win(ev), _cam(jcam)
    cnt = ops.pack_tiles(win.map(lambda a: a[None]), torch.tensor(om)[None],
                         cam, 0.5).cnt
    if capacity == "above":
        capacity = int(cnt.max()) + 1
    base = ops.iwe_accum(win, torch.tensor(om), cam, 0.5,
                         capacity=int(cnt.max()) + 1)
    out = ops.iwe_accum(win, torch.tensor(om), cam, 0.5, capacity=capacity)
    expect = r_iwe_accum(ev, jnp.asarray(om), jcam, 0.5, capacity=capacity)
    assert torch.equal(out.channels, base.channels)
    assert int(out.spilled) == int(expect.spilled) \
        == int((cnt - capacity).clamp(min=0).sum())
    assert (int(out.spilled) > 0) == (capacity <= int(cnt.max()))


@pytest.mark.parametrize("fn", ["iwe_accum", "fused_engine_pass"])
def test_cuda_engine_scatters_only_in_the_plain_kernel(fn, monkeypatch):
    """No fold-back: at a capacity that spills, the per-window engine
    enters neither deterministic algorithms nor `index_add_` outside the
    tile kernel's plain version (the one that runs on the CPU)."""
    tile_mod = importlib.import_module("repro_torch.kernels.iwe_accum")
    inside = []
    plain = tile_mod.tile_accumulate_plain

    def in_plain(*a, **k):
        inside.append(1)
        try:
            return plain(*a, **k)
        finally:
            inside.pop()

    def only_in_plain(f, name):
        def guarded(*a, **k):
            if not inside:
                raise AssertionError(f"{name} outside the plain kernel")
            return f(*a, **k)
        return guarded

    entered = []
    monkeypatch.setattr(tile_mod, "tile_accumulate_plain",
                        lambda *a, **k: entered.append(1) or in_plain(*a, **k))
    for name in ("use_deterministic_algorithms", "index_add"):
        monkeypatch.setattr(torch, name, only_in_plain(getattr(torch, name),
                                                       name))
    for name in ("index_add_", "index_add"):
        monkeypatch.setattr(torch.Tensor, name,
                            only_in_plain(getattr(torch.Tensor, name), name))
    assert not hasattr(ops, "_deterministic")
    jcam = small_camera()
    wins = [_win(random_window(600, cam=jcam, seed=s)) for s in (20, 21)]
    om = torch.tensor([[0.6, -0.3, 0.9], [0.1, 0.2, -0.4]])
    if fn == "iwe_accum":
        out = ops.iwe_accum(_stack(wins), om, _cam(jcam), 0.25, capacity=8)
    else:
        out = ops.fused_engine_pass(_stack(wins), om, _cam(jcam), 0.25, 3,
                                    0.5, capacity=8)
    assert bool((out[-1] > 0).all()) and len(entered) == 1


# ----------------------------------------------------------------------
# the fused engine pass, stage by stage
# ----------------------------------------------------------------------


@pytest.mark.parametrize("si", [0, 1, 2])
def test_fused_engine_pass_matches_reference(si):
    jcam = small_camera()
    cam = _cam(jcam)
    jstage = R.CmaxConfig(camera=jcam).stages[si]
    stage = T.StageConfig(**dataclasses.asdict(jstage))
    ev = random_window(1024, cam=jcam, seed=10)
    om = np.array([0.4, -0.3, 0.6], np.float32)
    v_j, g_j, spilled_j = r_fused_engine_pass(
        ev, jnp.asarray(om), jcam, jstage.scale, jstage.blur_taps,
        jstage.blur_sigma, weights=jnp.ones(1024), capacity=1024)
    v, g, spilled = ops.fused_engine_pass(
        _win(ev), torch.tensor(om), cam, stage.scale, stage.blur_taps,
        stage.blur_sigma, weights=torch.ones(1024), capacity=1024)
    assert int(spilled) == int(spilled_j)
    v_r, g_r = T.make_engine_pass(cam, stage)(_win(ev), torch.ones(1024),
                                              torch.tensor(om))
    for v_o, g_o in ((v_j, g_j), (v_r, g_r)):
        np.testing.assert_allclose(float(v), float(v_o), rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_o), rtol=1e-3,
                                   atol=1e-6)


# ----------------------------------------------------------------------
# the wrappers on the CPU, and the build
# ----------------------------------------------------------------------


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    rng = np.random.default_rng(3)
    pix = torch.tensor(rng.integers(-1, 1024, size=(2, 3, 64)),
                       dtype=torch.int32)
    deltas = torch.tensor(rng.normal(size=(2, 3, 64, 4)), dtype=torch.float32)
    ch = torch.tensor(rng.normal(size=(2, 4, 20, 30)), dtype=torch.float32)
    taps = T.gaussian_taps(5, 0.75)
    runs = _as_runs(pix, deltas, 64)
    n_tile = tile_accumulate.launches
    n_blur = blur_stats_streaming.launches
    assert torch.equal(tile_accumulate(*runs, p_tile=1024),
                       tile_accumulate_plain(*runs, p_tile=1024))
    assert torch.equal(blur_stats_streaming(ch, taps, rb=4),
                       blur_stats_streaming_plain(ch, taps))
    assert tile_accumulate.launches == n_tile
    assert blur_stats_streaming.launches == n_blur


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_kernel_build_is_keyed_by_source_headers_and_flags(name, monkeypatch,
                                                          tmp_path):
    """Each kernel's library name changes with its source, with a shared
    header and with the flags, so no stale library is ever loaded."""
    target = _build._target(name)
    assert target.parent == _build.BUILD_DIR
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._target(name) == target
    header = tmp_path / "blur_sums.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    edited_header = _build._target(name)
    assert edited_header != target
    src = tmp_path / _build.SOURCES[name]
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._target(name) not in (target, edited_header)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-g"])
    assert _build._target(name) != target
