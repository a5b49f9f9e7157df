"""The port's kernels on the card: each builds from the repo's source, agrees
with its plain version, gives the same bits run to run and whatever batch a
window rides in, and carries the estimation pipeline — the batched
engine-pass kernel under `cuda_batched`, the tile-accumulation and
blur-statistics kernels under `cuda`. The LM decode-serving path, which
runs none of those kernels, decodes every SMOKE config on the card within
the reference's bar of the CPU and serves chunks bitwise to its batch-1
chain there. Single-card training: `f32_product`'s backward against the
widened product, the bf16 embedding's backward summing a token's repeats
in float32, one train step of every SMOKE config on the card against
the CPU, and a bitwise checkpoint round trip on the card. Multi-device
training on an NCCL world of one rank: a SMOKE train step with DTensor
parameters on a (1, 1) grid against the plain single-card step, and the
expert-parallel MoE against the dense one.

Every test here is marked `gpu` and skips where there is no sm_90 card. The
file imports no JAX (the card's machine has none); run it there with

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.configs import ARCH_IDS
from repro_torch.core.pipeline import lockstep_passes, map_result
from repro_torch.data import events
from repro_torch.kernels import (_build, blur_stats_streaming,
                                 blur_stats_streaming_plain, megakernel, ops,
                                 tile_accumulate, tile_accumulate_plain)
from repro_torch.kernels.iwe_accum import _bind as _bind_tile

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


# ----------------------------------------------------------------------
# the per-window engine: tile accumulation and streaming blur statistics
# ----------------------------------------------------------------------


def _zero_spill_capacity(cnt):
    """The smallest power of two at or above the largest tile count."""
    return 1 << max(int(cnt.max()) - 1, 0).bit_length()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [s for s, _, _ in STAGES])
def test_tile_accumulate_matches_plain_and_is_bitwise_stable(windows, scale,
                                                             dtype):
    wins, om, _ = windows
    w = torch.ones_like(wins.x)
    cnt = ops.pack_tiles(wins, om, CAM, scale, w, capacity=1).cnt
    for capacity in (4096, _zero_spill_capacity(cnt)):
        pack = ops.pack_tiles(wins, om, CAM, scale, w, capacity=capacity,
                              dtype=dtype)
        before = tile_accumulate.launches
        out = tile_accumulate(pack.pix, pack.deltas, p_tile=1024)
        again = tile_accumulate(pack.pix, pack.deltas, p_tile=1024)
        torch.cuda.synchronize()
        assert tile_accumulate.launches == before + 2
        assert torch.equal(out, again)
        plain = tile_accumulate_plain(pack.pix, pack.deltas, p_tile=1024)
        assert torch.equal(out, plain)
        for i in range(out.shape[0]):
            one = tile_accumulate(pack.pix[i:i + 1].contiguous(),
                                  pack.deltas[i:i + 1].contiguous(),
                                  p_tile=1024)
            assert torch.equal(one[0], out[i])
        # CPU tensors run the plain version and launch nothing
        n = tile_accumulate.launches
        cpu = tile_accumulate(pack.pix[:1].cpu(), pack.deltas[:1].cpu(),
                              p_tile=1024)
        assert tile_accumulate.launches == n
        torch.testing.assert_close(cpu, out[:1].cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale,k,sigma", STAGES)
def test_blur_stats_matches_plain_and_is_bitwise_stable(windows, scale, k,
                                                        sigma):
    wins, om, _ = windows
    ch = ops.iwe_accum(wins, om, CAM, scale, capacity=4096).channels
    taps = T.gaussian_taps(k, sigma, device=om.device)
    before = blur_stats_streaming.launches
    out = blur_stats_streaming(ch, taps, rb=16)
    again = blur_stats_streaming(ch, taps, rb=16)
    torch.cuda.synchronize()
    assert blur_stats_streaming.launches == before + 2
    assert torch.equal(out, again)
    plain = blur_stats_streaming_plain(ch, taps)
    # T_x, T_y, T_z vanish (each derivative image sums to ~0), so the sums
    # are held to each window's largest sum
    scale_b = plain.abs().amax(dim=-1, keepdim=True)
    assert float(((out - plain).abs() / scale_b).max()) <= 1e-3
    P = ch.shape[-1] * ch.shape[-2]
    v, g = T.stats_to_objective(out, P)
    vp, gp = T.stats_to_objective(plain, P)
    torch.testing.assert_close(v, vp, rtol=1e-4, atol=0)
    s = gp.abs().max()
    torch.testing.assert_close(g / s, gp / s, rtol=0, atol=1e-4)
    for i in range(out.shape[0]):
        assert torch.equal(blur_stats_streaming(ch[i:i + 1], taps)[0],
                           out[i])
    n = blur_stats_streaming.launches
    blur_stats_streaming(ch[:1].cpu(), taps.cpu())
    assert blur_stats_streaming.launches == n


def test_kernels_load_from_libraries_keyed_by_source(cuda):
    for name in _build.SOURCES:
        lib = _build.load(name)
        assert lib._name == str(_build._target(name))


def test_cuda_engine_on_the_card(cuda, windows):
    """The per-window engine through estimate_batch and estimate_sequence:
    every engine pass launches each kernel once, the estimates track the
    ground truth, a window's result has the same bits alone as in its
    slot, and in the reference's small setup it agrees with the port's
    reference engine on the card."""
    wins, om, om_true = windows
    cfg = dataclasses.replace(T.CmaxConfig(engine="cuda"), stages=tuple(
        dataclasses.replace(s, max_iters=6) for s in T.CmaxConfig().stages))
    t0, b0 = tile_accumulate.launches, blur_stats_streaming.launches
    res = T.estimate_batch(wins, om, cfg)
    passes = lockstep_passes(res)
    assert tile_accumulate.launches - t0 == passes
    assert blur_stats_streaming.launches - b0 == passes
    err = (res.omega - om_true).norm(dim=-1)
    assert float(err.pow(2).mean().sqrt()) < 0.5
    one = T.estimate_batch(wins.map(lambda a: a[2:3]), om[2:3], cfg)
    assert torch.equal(one.omega[0], res.omega[2])

    t0 = tile_accumulate.launches
    oms, seq = T.estimate_sequence(wins, om[0], cfg)
    assert oms.shape == (4, 3) and bool(torch.isfinite(oms).all())
    assert tile_accumulate.launches - t0 == \
        sum(int(st.passes.sum()) for st in seq.stages)

    cam = T.Camera(width=64, height=48, fx=53.0, fy=53.0, cx=32.0, cy=24.0)
    small = dataclasses.replace(cfg, camera=cam, stages=tuple(
        dataclasses.replace(s, max_iters=3) for s in T.CmaxConfig().stages))
    batch = _random_batch(cam, 256, [40, 41, 42], cuda)
    om0 = torch.tensor([[0.1, -0.05, 0.2]] * 3, device=cuda)
    res = T.estimate_batch(batch, om0, small)
    ref = T.estimate_batch(batch, om0, dataclasses.replace(
        small, engine="reference"))
    torch.testing.assert_close(res.omega, ref.omega, rtol=0, atol=5e-4)
    for st_k, st_r in zip(res.stages, ref.stages):
        assert st_k.iters.tolist() == st_r.iters.tolist()
        torch.testing.assert_close(st_k.v_final, st_r.v_final, rtol=1e-3,
                                   atol=0)


# ----------------------------------------------------------------------
# the hard cases of the two sorted kernels
# ----------------------------------------------------------------------


def _tile_case(name, dtype, device):
    """(pix, deltas, p_tile) of one hard case for tile_accumulate: two
    windows of three tiles, drawn from a seed."""
    rng = np.random.default_rng(TILE_CASES.index(name))
    p_tile, cap = 1024, 4096
    if name == "one_pixel":            # every slot of a tile on one pixel
        pix = np.full((2, 3, cap), 517)
        pix[1] = 3
    elif name == "ragged_capacity":    # capacity not a multiple of a chunk
        cap = 4096 * 2 + 1237
        pix = rng.integers(0, p_tile, (2, 3, cap))
    elif name == "empty_slots":        # -1 interleaved and trailing
        pix = rng.integers(0, 40, (2, 3, cap))
        pix[:, :, ::3] = -1
        pix[:, :, 3000:] = -1
    elif name == "empty_tile":         # a tile with no occupied slot
        pix = rng.integers(-1, p_tile, (2, 3, cap))
        pix[0, 1] = -1
        pix[1, :, :] = -1
    elif name == "shuffled":           # slots in no order, and other ids
        pix = rng.permutation(np.repeat(np.arange(-1, 64), 180))[:cap]
        pix = np.broadcast_to(pix, (2, 3, cap)).copy()
        pix[1, 2] = rng.integers(-7, p_tile + 9, cap)   # out-of-tile ids
    elif name == "zero_spill":         # the s = 1/4 zero-spill capacity
        cap = 65536
        pix = rng.integers(0, p_tile, (2, 3, cap))
        pix[:, :, 45000:] = -1
    elif name in ("p_tile_2048", "p_tile_4096"):
        p_tile = int(name[-4:])
        pix = rng.integers(-1, p_tile, (2, 3, cap))
    else:
        raise ValueError(name)
    deltas = rng.normal(size=pix.shape + (4,)).astype(np.float32)
    return (torch.tensor(pix, dtype=torch.int32, device=device),
            torch.tensor(deltas, device=device).to(dtype).contiguous(),
            p_tile)


TILE_CASES = ["one_pixel", "ragged_capacity", "empty_slots", "empty_tile",
              "shuffled", "zero_spill", "p_tile_2048", "p_tile_4096"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TILE_CASES)
def test_tile_accumulate_hard_cases_bitwise(cuda, case, dtype):
    """The sorted tile kernel is bit for bit the plain version (each pixel
    sums its slots in slot order) on the inputs a sort gets wrong first,
    on a rerun, and for each window alone."""
    pix, deltas, p_tile = _tile_case(case, dtype, cuda)
    out = tile_accumulate(pix, deltas, p_tile=p_tile)
    again = tile_accumulate(pix, deltas, p_tile=p_tile)
    plain = tile_accumulate_plain(pix, deltas, p_tile=p_tile)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert torch.equal(out, again)
    for i in range(2):
        one = tile_accumulate(pix[i:i + 1].contiguous(),
                              deltas[i:i + 1].contiguous(), p_tile=p_tile)
        assert torch.equal(one[0], out[i])
    if case == "empty_tile":
        assert float(out[0, 1].abs().max()) == 0.0


def _one_pixel_batch(n, device):
    """Windows whose events all warp (at omega = 0) onto one pixel: four
    runs of n records each, longer than the kernel's chunk of records."""
    rng = np.random.default_rng(5)
    cols = []
    for b in range(3):
        x = np.full(n, 20.3 + b, np.float32)
        y = np.full(n, 11.6, np.float32)
        t = np.sort(rng.uniform(0, 0.03, n)).astype(np.float32)
        p = rng.choice([-1.0, 1.0], n).astype(np.float32)
        cols.append((x, y, t, p, np.ones(n, bool)))
    return T.EventWindow(*[torch.tensor(np.stack(c), device=device)
                           for c in zip(*cols)])


MEGA_CASES = [("one_pixel", 9), ("ragged_rows", 9), ("k15", 15)]


@pytest.mark.parametrize("case,k", MEGA_CASES)
def test_megakernel_hard_cases(cuda, case, k):
    """Against the plain version at the kernel's bars, bitwise on a rerun
    and at B=1 against each slot: a run far longer than a chunk, a grid
    whose height is no multiple of the row slab nor its size of the vote's
    pixel range, and the longest blur the kernel takes."""
    cam = T.Camera(width=60, height=45, fx=53.0, fy=53.0, cx=30.0, cy=22.5)
    if case == "one_pixel":
        wins = _one_pixel_batch(8192, cuda)
        om = torch.zeros((3, 3), device=cuda)
    else:
        wins = _random_batch(cam, 4096, [60, 61, 62], cuda)
        om = torch.tensor([[0.4, -0.3, 0.8], [-1.0, 0.2, 0.1],
                           [0.0, 0.5, -0.6]], device=cuda)
    bins = ops.bin_taps(wins, om, torch.ones_like(wins.x), cam, 1.0)
    if case == "one_pixel":
        runs = bins.pix_off[:, 1:] - bins.pix_off[:, :-1]
        assert int(runs.max()) == 8192 and int((runs > 0).sum()) == 12
    assert 45 % 8 != 0 and (45 * 60) % megakernel.launch_config(
        45, 60, k, 8).vote_pixels != 0
    fir = T.gaussian_taps(k, 1.5, device=cuda)
    kw = dict(H=45, W=60, rb=8, scale=1.0, fx=cam.fx, fy=cam.fy, cx=cam.cx,
              cy=cam.cy)
    out = megakernel.megakernel_stats(*bins, om, fir, **kw)
    again = megakernel.megakernel_stats(*bins, om, fir, **kw)
    plain = megakernel.megakernel_stats_plain(*bins, om, fir, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    v, g = T.stats_to_objective(out, 45 * 60)
    vp, gp = T.stats_to_objective(plain, 45 * 60)
    torch.testing.assert_close(v, vp, rtol=1e-4, atol=0)
    s = gp.abs().max()
    torch.testing.assert_close(g / s, gp / s, rtol=0, atol=1e-4)
    for i in range(3):
        one = megakernel.megakernel_stats(
            *[a[i:i + 1].contiguous() for a in bins], om[i:i + 1], fir, **kw)
        assert torch.equal(one[0], out[i])


def test_launch_configs_match_the_sources(cuda):
    lib = megakernel._bind(_build.load("megakernel"))
    for H, W in ((45, 60), (90, 120), (180, 240)):
        for k in (3, 5, 9, 15):
            cfg = megakernel.launch_config(H, W, k, 8)
            assert cfg.smem == lib.megakernel_smem_bytes(W, 8, k)
            assert cfg.vote_pixels <= lib.megakernel_max_vote_pixels()
    tile = _bind_tile(_build.load("iwe_accum"))
    assert tile.tile_accumulate_max_pixels() == 4096
    for p_tile in (1, 1000, 1024, 2048, 4096):
        assert tile.tile_accumulate_smem_bytes(p_tile) <= \
            megakernel.SMEM_LIMIT


# ----------------------------------------------------------------------
# the hard cases of the streaming blur kernel
# ----------------------------------------------------------------------

# (name, B, H, W, k): ragged shapes (H no multiple of the band, W no
# multiple of the strip or of 4), a grid narrower than one strip, the
# shortest and longest blurs, one window alone, and unit impulses at the
# corners and on the strip and band seams
BLUR_CASES = [("ragged_45x61", 8, 45, 61, 9), ("ragged_45x62", 8, 45, 62, 5),
              ("narrow_20x13", 8, 20, 13, 5), ("k1", 8, 45, 60, 1),
              ("k15", 8, 45, 62, 15), ("k15_full", 8, 180, 240, 15),
              ("b1", 1, 90, 120, 5), ("impulses", 8, 90, 130, 9),
              ("impulses_k3", 8, 45, 61, 3)]


def _blur_case(name, B, H, W, k, device):
    """(channels, taps) of one hard case, drawn from a seed."""
    from repro_torch.kernels.blur_stats import launch_config
    rng = np.random.default_rng([ord(c) for c in name])
    if name.startswith("impulses"):
        cfg = launch_config(H, W, k)
        r, c = cfg.band_rows, min(64, W - 1)
        spots = [(0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1),
                 (r - 1, c - 1), (r, c), (r - 1, c), (r, c - 1)]
        ch = np.zeros((B, 4, H, W), np.float32)
        for b in range(B):
            for i, (y, x) in enumerate(spots):
                ch[b, (b + i) % 4, y, x] = 1.0
            ch[(b, 0) + spots[b % len(spots)]] = 1.0   # I always has one
    else:
        ch = rng.normal(size=(B, 4, H, W)).astype(np.float32)
    sigma = max(k / 6.0, 0.5)
    return (torch.tensor(ch, device=device),
            T.gaussian_taps(k, sigma, device=device))


def _hold_blur_to_plain(out, plain, P):
    rel = ((out - plain).abs() / plain.abs().amax(dim=-1, keepdim=True))
    assert float(rel.max()) <= 1e-3
    v, g = T.stats_to_objective(out, P)
    vp, gp = T.stats_to_objective(plain, P)
    torch.testing.assert_close(v, vp, rtol=1e-4, atol=0)
    s = gp.abs().max()
    torch.testing.assert_close(g / s, gp / s, rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", BLUR_CASES, ids=[c[0] for c in BLUR_CASES])
def test_blur_stats_hard_cases(cuda, case):
    """Against the plain version at the kernel's bars, bitwise on a rerun
    and, for each window alone, bitwise equal to its slot of the batch."""
    name, B, H, W, k = case
    ch, taps = _blur_case(name, B, H, W, k, cuda)
    before = blur_stats_streaming.launches
    out = blur_stats_streaming(ch, taps)
    again = blur_stats_streaming(ch, taps)
    plain = blur_stats_streaming_plain(ch, taps)
    torch.cuda.synchronize()
    assert blur_stats_streaming.launches == before + 2
    assert out.shape == (B, 8) and bool(torch.isfinite(out).all())
    _hold_blur_to_plain(out, plain, H * W)
    assert torch.equal(out, again)
    for i in range(B):
        assert torch.equal(blur_stats_streaming(ch[i:i + 1], taps)[0],
                           out[i])


def test_blur_stats_unaligned_stack_takes_the_same_bits(cuda):
    """A stack that starts 4 bytes past a 16-byte boundary is staged with
    4-byte copies; the staged rows, and so the bits, are the same."""
    ch, taps = _blur_case("aligned", 2, 90, 120, 5, cuda)
    flat = torch.empty(ch.numel() + 1, device=cuda)
    flat[1:] = ch.reshape(-1)
    shifted = flat[1:].view_as(ch)
    assert shifted.data_ptr() % 16 == 4 and shifted.is_contiguous()
    assert torch.equal(blur_stats_streaming(shifted, taps),
                       blur_stats_streaming(ch, taps))


def test_blur_stats_on_two_streams_keeps_its_bits(cuda):
    """Calls on two streams at once (each stream has its own tickets for
    the kernel's last-block sum) give the bits of one call alone."""
    ch, taps = _blur_case("streams", 8, 180, 240, 9, cuda)
    alone = blur_stats_streaming(ch, taps)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    outs = []
    for _ in range(20):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(blur_stats_streaming(ch, taps))
    torch.cuda.synchronize()
    assert all(torch.equal(o, alone) for o in outs)


def test_blur_launch_config_matches_the_source(cuda):
    """The launcher takes launch_config's geometry at every k it is built
    for (it refuses a halo, segment or shared memory it cannot use)."""
    ch = torch.ones((1, 4, 45, 61), device=cuda)
    for k in range(1, 16, 2):
        out = blur_stats_streaming(ch, T.gaussian_taps(k, 1.0, device=cuda))
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())


# ----------------------------------------------------------------------
# serving: the threaded dispatch executor and drains on the card
# ----------------------------------------------------------------------


def _serve_streams(device, n_streams=3, n_windows=2, n_max=8192):
    """Ragged POSTER streams on `device`."""
    from repro_torch.data.events import ragged_from_sequence, ragged_lengths
    out = {}
    for s in range(n_streams):
        spec = dataclasses.replace(events.POSTER, n_windows=n_windows,
                                   events_per_window=n_max, jerk_prob=0.0,
                                   seed=events.POSTER.seed + s)
        wins, _, om = events.make_sequence(spec, device=device)
        lens = ragged_lengths(n_windows, n_max // 2, n_max, seed=s)
        out[f"s{s}"] = (ragged_from_sequence(wins, lens), om[0])
    return out


def _short_cfg(engine):
    return dataclasses.replace(T.CmaxConfig(engine=engine), stages=tuple(
        dataclasses.replace(s, max_iters=6) for s in T.CmaxConfig().stages))


def test_dispatch_executor_overlaps_and_matches_inline(cuda):
    """Two batches in flight on the worker's stream: neither is done while
    the device still sleeps ahead of them, both are after `wait`, and
    their results have the bits of the inline executor's."""
    from repro_torch.launch.serve import AsyncDispatchExecutor, InlineExecutor
    from repro_torch.serving import CmaxWorkload
    cfg = _short_cfg("cuda_batched")
    wl = CmaxWorkload(cfg, device=cuda)
    streams = _serve_streams(cuda)
    batches = []
    for take in (("s0", "s1"), ("s2",)):
        wins = [streams[s][0][0] for s in take]
        states = [streams[s][1].cpu().numpy() for s in take]
        batches.append(wl.make_batch(wins, states, 8192, 2)[:2])
    fn = wl.executable(8192, 2)

    def slow(w, o):
        torch.cuda._sleep(int(0.3 * 2e9))       # ~0.3 s on the device
        return fn(w, o)

    ex = AsyncDispatchExecutor()
    handles = [ex.submit(slow, w, o, 8192, 2) for w, o in batches]
    assert not any(ex.done(h) for h in handles)
    got = [ex.wait(h) for h in handles]
    assert all(ex.done(h) for h in handles)
    ex.close()
    inline = InlineExecutor()
    for (w, o), res in zip(batches, got):
        ref = inline.wait(inline.submit(fn, w, o, 8192, 2))
        assert torch.equal(res.omega, ref.omega)
        for st_a, st_b in zip(res.stages, ref.stages):
            assert torch.equal(st_a.iters, st_b.iters)
            assert torch.equal(st_a.v_final, st_b.v_final)


def test_dispatch_executor_keeps_a_freed_input_alive(cuda):
    """A tensor made on the caller's stream and dropped by the caller right
    after `submit` is read correctly by the worker's stream, although the
    caller's stream allocates and writes over same-size tensors while the
    worker's stream still sleeps ahead of the read."""
    from repro_torch.launch.serve import AsyncDispatchExecutor
    n = 1 << 20
    x = torch.arange(n, device=cuda, dtype=torch.float32)
    expect = x.cpu()

    def read_late(a, b):
        torch.cuda._sleep(int(0.2 * 2e9))
        return a * 1.0 + b

    # load every kernel of the case first: loading a module at its first
    # launch waits for the device, which would order the reads and writes
    # below by itself
    read_late(torch.full((n,), -1.0, device=cuda), x[:1])
    torch.cuda.synchronize()
    ex = AsyncDispatchExecutor()
    h = ex.submit(read_late, x, torch.zeros(1, device=cuda), 0, 1)
    del x
    while not h.future.done():                   # the host side returned
        pass
    time.sleep(0.05)             # and the worker thread dropped the batch
    junk = [torch.full((n,), -1.0, device=cuda) for _ in range(4)]
    out = ex.wait(h)
    ex.close()
    assert torch.equal(out.cpu(), expect)
    assert all(bool((j == -1).all()) for j in junk)


@pytest.mark.parametrize("engine", ["cuda_batched", "cuda"])
def test_served_drain_matches_its_chain_on_the_card(cuda, engine):
    """The async service on the card (threaded executor, two batches in
    flight) gives each window the bits of the workload's batch-1 chain, and
    every engine pass launched the engine's kernels."""
    from repro_torch.core.pipeline import lockstep_passes, map_result
    from repro_torch.launch.serve import AsyncBatchedEstimationService
    from repro_torch.serving import CmaxWorkload

    class Counting(CmaxWorkload):
        passes = 0

        def harvest(self, result, track_gain):
            Counting.passes += lockstep_passes(result)
            return super().harvest(result, track_gain)

    policy = events.pow2_policy(min_bucket=4096, max_bucket=8192)
    wl = Counting(_short_cfg(engine), policy=policy, device=cuda)
    streams = _serve_streams(cuda)
    svc = AsyncBatchedEstimationService(workload=wl, max_batch=2,
                                        max_in_flight=2)
    for sid, (wins, om0) in streams.items():
        for k, w in enumerate(wins):
            svc.submit(sid, w, omega_hint=om0 if k == 0 else None)
    counted = megakernel.megakernel_stats if engine == "cuda_batched" \
        else tile_accumulate
    before = counted.launches
    rs = svc.drain()
    svc.executor.close()
    assert counted.launches - before == Counting.passes > 0
    assert all(r.status == "ok" for r in rs) and len(rs) == 6
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, (wins, om0) in streams.items():
        state = om0.cpu().numpy()
        for k, w in enumerate(wins):
            b = wl.bucket_of(w)
            data, sb, _ = wl.make_batch([w], [state], b, 1)
            res = wl.executable(b, 1)(data, sb)
            _, state, _, _ = wl.harvest(res, False)(0)
            assert np.array_equal(by[(sid, k)].omega, state), (sid, k)


# ---- core/energy.py and core/distributed.py on the card ----


def _host_hits(act, Hs, Ws):
    """The reference's `lax.scan` forward fill spelled as a host loop: the
    pending-merge hits of one window's active groups over the 4 tap lanes
    (each hit counts for the 4 channels)."""
    Wb = (Ws + 1) // 2
    hits = 0
    for dy in (0, 1):
        for dx in (0, 1):
            carry = -2
            for g, a in enumerate(act):
                if a:
                    addr = ((g // Ws + dy) // 2) * Wb + (g % Ws + dx) // 2
                    hits += addr == carry
                    carry = addr
    return 4 * hits


def test_locality_stats_on_the_card_matches_the_host_fill(windows):
    from repro_torch.core import energy
    wins, om_imu, om_true = windows
    for st in T.CmaxConfig().stages:
        Hs, Ws = st.grid(CAM)
        for b in range(wins.x.shape[0]):
            w = wins.map(lambda a: a[b])
            loc = energy.locality_stats(w, om_imu[b], om_true[b], CAM, st)
            assert all(v.is_cuda for v in loc.values())
            tables = T.sort_events(w, om_imu[b], CAM, st)
            p_now = torch.gather(T.warp_events(w, om_true[b], CAM, st.scale)
                                 .p_act, -1, tables.perm)
            n_out = int((tables.retained & (p_now != tables.p_ref)).sum())
            hits = (int(loc["active_groups"]) + n_out) * 16 \
                - int(loc["eff_updates"])
            assert hits == _host_hits(tables.act.tolist(), Hs, Ws)
            for key in ("active_ratio", "outlier_ratio"):
                assert 0.0 <= float(loc[key]) <= 1.0
            # (active groups + outliers) / retained: each term is at most
            # 1, and their sum may pass 1, so it is held to the formula
            n_act = int(tables.act.sum())
            n_ret = max(1, int(tables.retained.sum()))
            assert float(loc["expected_update_ratio"]) == float(
                np.float32(n_act + n_out) / np.float32(n_ret))
            assert int(loc["eff_updates"]) <= int(loc["naive_updates"])
            same = energy.locality_stats(w, om_imu[b], om_imu[b], CAM, st)
            assert float(same["outlier_ratio"]) == 0.0


def _two_shard_grid():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((2, 1), ("data", "model"), devices=["cuda:0"] * 2)


def test_grid_on_one_card_reraises_a_shards_exception(cuda, monkeypatch):
    from repro_torch.core import distributed as D
    wins = T.EventWindow(*[torch.zeros(4, 16, device=cuda)
                           for _ in range(4)])
    om = torch.zeros(4, 3, device=cuda)
    om[2, 0] = 1.0                                   # the second shard
    ran = []

    def flaky(w, o, cfg):
        ran.append(torch.cuda.current_stream().cuda_stream)
        if float(o[0, 0]) == 1.0:
            raise ArithmeticError("shard failed")
        return T.WindowResult(omega=o * 2, stages=())

    monkeypatch.setattr(D, "estimate_windows_parallel", flaky)
    with pytest.raises(ArithmeticError, match="shard failed"):
        D.estimate_batch_sharded(wins, om, T.CmaxConfig(), _two_shard_grid())
    assert len(ran) == 2 and ran[0] != ran[1]    # a stream per shard


def test_grid_gather_waits_for_each_shards_end(cuda, monkeypatch):
    """Each shard writes its output only after the device has slept; the
    gathered result still holds the written values, not the zeros the
    output held before."""
    from repro_torch.core import distributed as D
    wins = T.EventWindow(*[torch.zeros(4, 16, device=cuda)
                           for _ in range(4)])
    om = torch.arange(12, dtype=torch.float32, device=cuda).view(4, 3)
    torch.zeros(1, device=cuda).add_(1)      # load the kernels first
    torch.cuda.synchronize()

    def late(w, o, cfg):
        out = torch.zeros_like(o)
        torch.cuda._sleep(int(0.3 * 2e9))         # ~0.3 s on the device
        out.add_(o + 1)
        return T.WindowResult(omega=out, stages=())

    monkeypatch.setattr(D, "estimate_windows_parallel", late)
    res = D.estimate_batch_sharded(wins, om, T.CmaxConfig(),
                                   _two_shard_grid())
    assert torch.equal(res.omega.cpu(), (om + 1).cpu())


def test_grid_on_one_card_is_bitwise_the_local_batch(windows):
    from repro_torch.core import distributed as D
    wins, om_imu, _ = windows
    cfg = _short_cfg("cuda_batched")
    local = T.estimate_batch(wins, om_imu, cfg)
    before = megakernel.megakernel_stats.launches
    res = D.estimate_batch_sharded(wins, om_imu, cfg, _two_shard_grid())
    launches = megakernel.megakernel_stats.launches - before
    shard_passes = sum(lockstep_passes(map_result(
        lambda a: a[lo:lo + 2], res)) for lo in (0, 2))
    assert launches == shard_passes > 0
    assert torch.equal(res.omega, local.omega)
    for st_a, st_b in zip(res.stages, local.stages):
        assert torch.equal(st_a.iters, st_b.iters)
        assert torch.equal(st_a.v_final, st_b.v_final)


# ---- the LM decode-serving path on the card (no CMAX kernel on it) ----


def _lm_decode(model, toks, cross=None):
    from repro_torch.models import transformer as tt
    dev = next(model.parameters()).device
    x = None if cross is None else torch.as_tensor(cross, device=dev)
    if x is not None and model.cfg.is_enc_dec:
        x = tt.encode(model, x)
    cache = tt.init_cache(model.cfg, toks.shape[0], 16, dev)
    t = torch.as_tensor(toks, device=dev)
    return torch.cat([tt.decode_step(model, t[:, i:i + 1], cache,
                                     cross_source=x)[0]
                      for i in range(toks.shape[1])], dim=1).cpu()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_decode_on_the_card_matches_the_cpu(cuda, arch):
    """Each SMOKE config built from one seed on the CPU and copied to the
    card decodes 8 tokens within the reference's decode-vs-forward bar
    (rtol 2e-2, atol 2e-3) of the CPU, greedy tokens equal."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tt
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = tt.init_params(cfg, torch.Generator().manual_seed(0), max_len=64,
                         device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    cross = None
    if cfg.family == "vlm" or cfg.is_enc_dec:
        cross = (rng.normal(size=(2, cfg.cross_source_len, cfg.d_model))
                 * 0.1).astype(np.float32)
    got, ref = _lm_decode(card, toks, cross), _lm_decode(cpu, toks, cross)
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-3)
    assert torch.equal(got.argmax(-1), ref.argmax(-1))


def test_lm_served_chunks_are_bitwise_on_the_card(cuda):
    """llama3.2-1b SMOKE (bf16) served on the card: four same-class streams
    batched together, async (threaded executor, worker stream) and sync,
    give every slot the tokens and final KV cache of the workload's
    batch-1 chain; one batch's logits are the same bits on the caller's
    stream and on a worker stream."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm as lm_data
    from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                          AsyncDispatchExecutor,
                                          BatchedEstimationService)
    from repro_torch.serving import LMDecodeWorkload

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="bfloat16")
    wl = LMDecodeWorkload(cfg, policy=lm_data.chunk_policy(8, 64),
                          max_len=64, return_logits=True, device=cuda)
    streams = {}
    for s in range(4):
        rng = np.random.default_rng(7 + s)
        streams[f"lm{s}"] = [lm_data.TokenChunk(rng.integers(
            0, cfg.vocab_size, size=8).astype(np.int32)) for _ in range(2)]

    def chain(chunks):
        state, out = wl.default_state(), []
        for c in chunks:
            data, sb, _ = wl.make_batch([c], [state], 8, 1)
            res = wl.executable(8, 1)(data, sb)
            toks, state, _, _ = wl.harvest(res, False)(0)
            out.append(toks)
        return out, state

    def same(a, b):
        return all(torch.equal(x[k], y[k]) if torch.is_tensor(x[k])
                   else x[k] == y[k]
                   for x, y in zip(a["cache"]["layers"],
                                   b["cache"]["layers"]) for k in x)

    ex = AsyncDispatchExecutor()
    svcs = [AsyncBatchedEstimationService(workload=wl, max_batch=4,
                                          executor=ex),
            BatchedEstimationService(workload=wl, max_batch=4)]
    chains = {sid: chain(cs) for sid, cs in streams.items()}
    for svc in svcs:
        for sid, cs in streams.items():
            for c in cs:
                svc.submit(sid, c)
        rs = svc.drain()
        assert len(rs) == 8 and all(r.batch_b == 4 for r in rs)
        for r in rs:
            assert np.array_equal(r.omega, chains[r.stream_id][0][r.seq])
        for sid in streams:
            assert same(svc._warm[sid], chains[sid][1]), sid
    firsts = [cs[0] for cs in streams.values()]
    data, st, _ = wl.make_batch(firsts, [wl.default_state()] * 4, 8, 4)
    inline = wl.executable(8, 4)(data, st)
    worker = ex.wait(ex.submit(wl.executable(8, 4), data, st, 8, 4))
    ex.close()
    assert torch.equal(inline.logits, worker.logits)
    assert torch.equal(inline.tokens, worker.tokens)


# ---- single-card LM training (no CMAX kernel on it) ----


def test_f32_product_backward_matches_the_widened_product(cuda):
    """bf16 factors on the card: the forward is one cuBLAS product with a
    float32 output, within the reference's f32 bar (rtol = atol = 1e-4,
    tests/test_kernels.py:31) of the widened product; the backward gives
    grad_x / grad_w in the factors' dtype within its bf16 bar (rtol = atol
    = 0.05, tests/test_kernels.py:55) of the widened product's."""
    from repro_torch.models.layers import f32_product
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 32, 128), generator=g, device=cuda)
    w = torch.randn((128, 256), generator=g, device=cuda) * 0.1
    r = torch.randn((2, 32, 256), generator=g, device=cuda)
    xb = x.to(torch.bfloat16).requires_grad_()
    wb = w.to(torch.bfloat16).requires_grad_()
    out = f32_product(xb, wb)
    assert out.dtype == torch.float32 and out.shape == (2, 32, 256)
    (out * r).sum().backward()
    xw = xb.detach().float().requires_grad_()
    ww = wb.detach().float().requires_grad_()
    ref = xw @ ww
    (ref * r).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert xb.grad.dtype == torch.bfloat16 and wb.grad.dtype == torch.bfloat16
    torch.testing.assert_close(xb.grad.float(), xw.grad, rtol=0.05,
                               atol=0.05)
    torch.testing.assert_close(wb.grad.float(), ww.grad, rtol=0.05,
                               atol=0.05)


def test_embedding_backward_sums_repeated_tokens_in_f32(cuda):
    """A bf16 table on the card, a batch where one token repeats 4,096
    times: the lookup's gradient is each row's float64 sum rounded once to
    bf16, within one bf16 rounding (relative L2 2**-8) of it. Advanced
    indexing's backward, which rounds after every repeat, misses that."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.layers import Embedding
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="bfloat16")
    emb = Embedding(cfg, torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, 8, (8, 1024), generator=g, device=cuda,
                           dtype=torch.int32)
    tokens[:4] = 3
    out = emb(tokens)
    grad_out = torch.randn(out.shape, generator=g, device=cuda).to(
        torch.bfloat16)
    (got,) = torch.autograd.grad(out, emb.table, grad_out)
    want = torch.zeros(emb.table.shape, dtype=torch.float64, device=cuda)
    want.index_add_(0, tokens.flatten().long(),
                    grad_out.double().reshape(-1, out.shape[-1]))
    assert got.dtype == torch.bfloat16
    rel = float((got.double() - want).norm() / want.norm())
    assert rel <= 2.0 ** -8, rel


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Each SMOKE config, built from one seed on the CPU and copied to the
    card: the loss and every gradient of one step (remat "full"), and the
    parameters after an AdamW update, within the reference's gradient bar
    (rtol 5e-4, atol 5e-5; tests/test_pipeline_parallel.py:54-55)."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.models import loss_and_grads
    from repro_torch.models import transformer as tt
    from repro_torch.train import optim
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    cpu = tt.init_params(cfg, torch.Generator().manual_seed(0), max_len=64,
                         device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks, labels = next(batches(LMDataConfig(cfg.vocab_size, 16, 4)))
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm" or cfg.is_enc_dec:
        batch["cross_source"] = (np.random.default_rng(0).normal(
            size=(4, cfg.cross_source_len, cfg.d_model)) * 0.1
        ).astype(np.float32)
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    out = {}
    for where, m in (("cpu", cpu), ("card", card)):
        dev = next(m.parameters()).device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, grads = loss_and_grads(m, b)
        optim.adamw_update(ocfg, grads, optim.adamw_init(ocfg, m), m)
        out[where] = (loss.cpu(), {k: v.cpu() for k, v in grads.items()},
                      {k: v.detach().cpu() for k, v in m.named_parameters()})
    torch.testing.assert_close(out["card"][0], out["cpu"][0], rtol=5e-4,
                               atol=5e-5)
    for i in (1, 2):
        for k, v in out["cpu"][i].items():
            torch.testing.assert_close(out["card"][i][k], v, rtol=5e-4,
                                       atol=5e-5, msg=f"{arch} {k}")


def test_lm_checkpoint_round_trip_on_the_card_is_bitwise(cuda, tmp_path):
    """A bf16 model and its AdamW state after one step, saved from the card
    and restored onto it: every tensor the same bits, dtypes kept."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.models import make_train_step
    from repro_torch.models import transformer as tt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="bfloat16")
    model = tt.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    toks, labels = next(batches(LMDataConfig(cfg.vocab_size, 16, 4)))
    state, _ = make_train_step(cfg, ocfg)(
        model, optim.adamw_init(ocfg, model),
        {"tokens": torch.as_tensor(toks, device=cuda),
         "labels": torch.as_tensor(labels, device=cuda)})
    tree = {"params": dict(model.named_parameters()), "opt_state": state}
    ckpt.save(tmp_path, 1, tree, extra={"next_step": 1})
    back, extra = ckpt.restore(tmp_path, tree, device=cuda)
    assert extra == {"next_step": 1} and back["opt_state"].step == 1
    dtypes = set()
    for name, p in model.named_parameters():
        got = back["params"][name]
        assert got.is_cuda and got.dtype == p.dtype, name
        assert torch.equal(got, p), name
        dtypes.add(p.dtype)
    # weights bf16, norm scales f32 (as the reference keeps them)
    assert dtypes == {torch.bfloat16, torch.float32}
    for field in ("mu", "nu"):
        for k, v in getattr(state, field).items():
            assert torch.equal(getattr(back["opt_state"], field)[k], v), k


# ---- multi-device training on a world of 1 over NCCL ----


@pytest.fixture(scope="module")
def nccl_world(cuda):
    """An NCCL world of one rank on cuda:0 (a FileStore rendezvous in a
    temporary directory), destroyed after the module's tests."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", f"file://{tmp}/rendezvous", 0, 1)
        try:
            yield cuda
        finally:
            dist.destroy_process_group()


def test_dist_train_step_on_a_world_of_one_matches_the_card(nccl_world):
    """A SMOKE train step (remat "full", 2 microbatches, AdamW) with the
    parameters as DTensors on a (1, 1) ("data", "model") grid with FSDP:
    the loss, every gradient and every updated parameter within the
    reference's gradient bar (rtol 5e-4, atol 5e-5) of the plain
    single-card step from the same parameters."""
    import copy

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import loss_and_grads
    from repro_torch.models import transformer as tt
    from repro_torch.sharding import distribute_batch, distribute_model
    from repro_torch.train import optim
    cuda = nccl_world
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = device_mesh(make_mesh((1, 1), ("data", "model"), [cuda]))
    for arch in ("llama3.2-1b", "deepseek-moe-16b"):
        cfg = get_smoke_config(arch)
        one = tt.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
        grid = distribute_model(copy.deepcopy(one), mesh, fsdp=True)
        toks, labels = next(batches(LMDataConfig(cfg.vocab_size, 16, 4)))
        batch = {"tokens": torch.as_tensor(toks, device=cuda),
                 "labels": torch.as_tensor(labels, device=cuda)}
        ocfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
        out = {}
        for where, m, b in (("card", one, batch),
                            ("grid", grid, distribute_batch(batch, mesh))):
            kw = dict(mesh=mesh, use_ep=bool(cfg.n_experts)) \
                if where == "grid" else {}
            loss, grads = loss_and_grads(m, b, microbatch=2, **kw)
            optim.adamw_update(ocfg, grads, optim.adamw_init(ocfg, m), m)
            whole = lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                               else t).detach().cpu()
            out[where] = (loss.cpu(), {k: whole(v) for k, v in grads.items()},
                          {k: whole(v) for k, v in m.named_parameters()})
        torch.testing.assert_close(out["grid"][0], out["card"][0], rtol=5e-4,
                                   atol=5e-5)
        for i in (1, 2):
            for k, v in out["card"][i].items():
                torch.testing.assert_close(out["grid"][i][k], v, rtol=5e-4,
                                           atol=5e-5, msg=f"{arch} {k}")


def test_moe_ep_on_a_world_of_one_matches_dense(nccl_world):
    """deepseek-moe-16b's SMOKE MoE layer in bf16: `moe_apply_ep` over a
    (1, 1) grid (experts as DTensors, FSDP) against `moe_apply` at the same
    capacity, output and gradients within rtol / atol 2e-4
    (tests/test_sharding_subprocess.py:86-87)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models.layers import settle
    from repro_torch.models.moe import MoE, moe_apply, moe_apply_ep
    from repro_torch.sharding import place, port_layout, to_placements
    cuda = nccl_world
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              dtype="bfloat16")
    mesh = device_mesh(make_mesh((1, 1), ("data", "model"), [cuda]))
    g = torch.Generator(device=cuda).manual_seed(0)
    dense_m, ep_m = MoE(cfg, g), MoE(cfg, g)
    ep_m.load_state_dict(dense_m.state_dict())
    specs, _ = port_layout({f"layers.1.moe.{n}": p for n, p in
                            ep_m.named_parameters()}, cfg, mesh, fsdp=True)
    for name, p in list(ep_m.named_parameters()):
        owner = ep_m.shared if name.startswith("shared.") else ep_m
        d = place(p.detach(), mesh,
                  to_placements(specs[f"layers.1.moe.{name}"], mesh))
        setattr(owner, name.rpartition(".")[2], torch.nn.Parameter(d))
    x = (torch.randn((4, 16, cfg.d_model), generator=g, device=cuda) * 0.1
         ).to(torch.bfloat16)
    ct = torch.randn(x.shape, generator=g, device=cuda)
    xd = x.clone().requires_grad_(True)
    out = moe_apply(dense_m, xd, cfg)
    (out.float() * ct).sum().backward()
    xe = DTensor.from_local(x.clone(), mesh, [Replicate()] * 2,
                            run_check=False).requires_grad_(True)
    oute = settle(moe_apply_ep(ep_m, xe, cfg, mesh, fsdp_axis="data"))
    (oute.float() * DTensor.from_local(ct, mesh, [Replicate()] * 2,
                                       run_check=False)).sum().backward()
    tol = dict(rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(oute.full_tensor().float(), out.float(), **tol)
    torch.testing.assert_close(xe.grad.full_tensor().float(),
                               xd.grad.float(), **tol)
    for (n, p), q in zip(ep_m.named_parameters(), dense_m.parameters()):
        torch.testing.assert_close(p.grad.full_tensor().float(),
                                   q.grad.float(), msg=n, **tol)


def test_moe_dispatch_backward_is_deterministic_in_bf16(cuda):
    """A bf16 MoE layer on the card (top-6 of 64 experts): the input's
    gradient, where each token's 6 pairs meet, is the same bits run to
    run, and within relative L2 2e-2 of an f32 copy's (`chip_smoke.py`
    [train]'s bf16 gradient bar)."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoE, moe_apply
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), d_model=256,
                              moe_d_ff=128, n_shared_experts=0)
    g = torch.Generator(device=cuda).manual_seed(0)
    m = MoE(cfg, g)
    x = (torch.randn((4, 256, cfg.d_model), generator=g, device=cuda)
         ).to(torch.bfloat16)
    ct = torch.randn(x.shape, generator=g, device=cuda)

    def grad_x(model, inp):
        inp = inp.clone().requires_grad_(True)
        out = moe_apply(model, inp, cfg)
        (gx,) = torch.autograd.grad((out.float() * ct).sum(), inp)
        return gx
    a, b = grad_x(m, x), grad_x(m, x)
    assert torch.equal(a, b)
    f32 = MoE(dataclasses.replace(cfg, dtype="float32"), g)
    f32.load_state_dict({k: v.float() for k, v in m.state_dict().items()})
    want = grad_x(f32, x.float())
    rel = float((a.float() - want).norm() / want.norm())
    assert rel <= 2e-2, rel
