"""The port's whole slice — batched, warm-started CMAX estimation — against
the JAX package on the CPU.

`estimate_batch`, `estimate_streams` and `estimate_batch_budgeted` run under
every port engine (`reference`; `cuda` and `cuda_batched`, whose kernels run
their plain versions on the CPU) and are held to the JAX results on the
same simulator windows: omega atol=5e-4, v_final rtol=1e-3
(`tests/test_megakernel.py`'s end-to-end bars) and equal iteration counts.
The `cuda` engine is also held to the JAX `pallas` engine at a capacity
that spills. Slot independence is held to the port's own B=1 bits, and the
per-window entry points (`estimate_window`, `estimate_window_budgeted`,
`estimate_sequence`) to the bits of their slot of the batched path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.pipeline import estimate_batch_budgeted as r_budgeted
from repro.core.pipeline import estimate_streams as r_streams
from repro.data import events as r_events

import repro_torch.core as T
from repro_torch.convert import config_from_reference, result_to_numpy, \
    window_from_numpy
from repro_torch.core import pipeline as P
from repro_torch.core.types import ENGINES
from repro_torch.data import events as t_events
from repro_torch.kernels import ops
from helpers import small_camera

torch.set_num_threads(1)

S, K, N = 3, 2, 1024
CAPS = np.array([[1, 2, 1], [3, 3, 3], [0, 2, 5]], np.int32)
SCHEDULES = ["adaptive", "fixed", "ascent", "caps"]


def _jcfg():
    stages = (
        R.StageConfig(scale=0.25, tau=1e-3, max_iters=6, blur_taps=3,
                      blur_sigma=0.5, keep_ratio=0.25, step_scale=2.0),
        R.StageConfig(scale=0.5, tau=4e-4, max_iters=6, blur_taps=5,
                      blur_sigma=0.75, keep_ratio=0.5, step_scale=1.4),
        R.StageConfig(scale=1.0, tau=1.5e-4, max_iters=6, blur_taps=9,
                      blur_sigma=1.0, keep_ratio=1.0, step_scale=1.0),
    )
    return R.CmaxConfig(camera=small_camera(), stages=stages)


def _tcfg(engine):
    return dataclasses.replace(config_from_reference(_jcfg()), engine=engine)


def _scheduled(engine, schedule):
    """The config of `engine` under one of `SCHEDULES`: the adaptive one,
    a fixed one, plain gradient ascent, or (the caller applying `CAPS`)
    the adaptive one under caps."""
    cfg = _tcfg(engine)
    if schedule == "fixed":
        return dataclasses.replace(cfg, adaptive=False, fixed_iters=(2, 0, 3))
    if schedule == "ascent":
        return dataclasses.replace(cfg, use_cgpr=False)
    return cfg


def _win(w):
    return window_from_numpy(np.asarray(w.x), np.asarray(w.y),
                             np.asarray(w.t), np.asarray(w.p),
                             np.asarray(w.valid), device="cpu")


@pytest.fixture(scope="module")
def ref():
    """S simulator streams of K windows and the JAX results on them."""
    spec = r_events.SequenceSpec(name="t", n_windows=K, events_per_window=N,
                                 n_features=40, camera=small_camera(),
                                 jerk_prob=0.0)
    seqs = [r_events.make_sequence(dataclasses.replace(spec, seed=5 + s))
            for s in range(S)]
    streams = R.EventWindow(*[jnp.stack([getattr(q[0], f) for q in seqs])
                              for f in ("x", "y", "t", "p", "valid")])
    om0 = jnp.stack([q[2][0] for q in seqs])
    first = R.EventWindow(*[a[:, 0] for a in (
        streams.x, streams.y, streams.t, streams.p, streams.valid)])
    cfg = _jcfg()
    out = dict(streams=streams, first=first, om0=np.asarray(om0))
    out["batch"] = jax.device_get(R.estimate_batch(first, om0, cfg))
    out["streams_res"] = jax.device_get(r_streams(streams, om0, cfg))
    out["budgeted"] = jax.device_get(r_budgeted(
        first, jnp.array(np.asarray(om0)), jnp.asarray(CAPS), cfg))
    return out


def _assert_matches(res_t, res_j):
    np.testing.assert_allclose(res_t.omega.numpy(), np.asarray(res_j.omega),
                               atol=5e-4)
    for tt, tj in zip(res_t.stages, res_j.stages):
        np.testing.assert_array_equal(tt.iters.numpy(), np.asarray(tj.iters))
        np.testing.assert_array_equal(tt.n_retained.numpy(),
                                      np.asarray(tj.n_retained))
        np.testing.assert_allclose(tt.v_final.numpy(),
                                   np.asarray(tj.v_final), rtol=1e-3)


@pytest.mark.parametrize("engine", ENGINES)
def test_estimate_batch_matches_reference(ref, engine):
    res = T.estimate_batch(_win(ref["first"]), torch.tensor(ref["om0"]),
                           _tcfg(engine))
    _assert_matches(res, ref["batch"])


def test_estimate_batch_donated_is_estimate_batch(ref):
    """The donated form is `estimate_batch` bit for bit on the `reference`
    engine (PyTorch donates no buffer; the warm starts stay as they were),
    and it is held to the reference's donated form at ω atol 5e-4 and
    `v_final` rtol 1e-3 (`tests/test_megakernel.py:168-173`)."""
    cfg = _tcfg("reference")
    first, om0 = _win(ref["first"]), torch.tensor(ref["om0"])
    kept = om0.clone()
    got = T.estimate_batch_donated(first, om0, cfg)
    assert torch.equal(om0, kept)
    plain = T.estimate_batch(first, om0, cfg)
    assert torch.equal(got.omega, plain.omega)
    for a, b in zip(got.stages, plain.stages):
        assert torch.equal(a.v_final, b.v_final)
        assert torch.equal(a.iters, b.iters)
        np.testing.assert_array_equal(a.v_history.numpy(),
                                      b.v_history.numpy())
    want = jax.device_get(R.estimate_batch_donated(
        ref["first"], jnp.array(ref["om0"]), _jcfg()))
    _assert_matches(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_estimate_streams_matches_reference(ref, engine):
    om, res = T.estimate_streams(_win(ref["streams"]),
                                 torch.tensor(ref["om0"]), _tcfg(engine))
    assert om.shape == (S, K, 3)
    _assert_matches(res, ref["streams_res"][1])


@pytest.mark.parametrize("engine", ENGINES)
def test_estimate_batch_budgeted_matches_reference(ref, engine):
    res = T.estimate_batch_budgeted(_win(ref["first"]),
                                    torch.tensor(ref["om0"]),
                                    torch.tensor(CAPS), _tcfg(engine))
    _assert_matches(res, ref["budgeted"])
    iters = torch.stack([st.iters for st in res.stages], dim=1)
    assert bool((iters <= torch.tensor(CAPS)).all())


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("engine", ENGINES)
def test_window_and_sequence_agree_with_batch(ref, engine, schedule):
    """The per-window entry points give the bits of their slot of the
    batched path under every schedule: `estimate_window` (under caps,
    `estimate_window_budgeted`) those of `estimate_batch`
    (`estimate_batch_budgeted`), and `estimate_sequence` those of its
    stream of `estimate_streams`."""
    cfg = _scheduled(engine, schedule)
    streams = _win(ref["streams"])
    first, om0 = streams.map(lambda a: a[:, 0]), torch.tensor(ref["om0"])
    caps = torch.tensor(CAPS)
    if schedule == "caps":
        res_b = T.estimate_batch_budgeted(first, om0, caps, cfg)
    else:
        res_b = T.estimate_batch(first, om0, cfg)
    for i in range(S):
        ev = first.map(lambda a: a[i])
        res_w = T.estimate_window_budgeted(ev, om0[i], caps[i], cfg) \
            if schedule == "caps" else T.estimate_window(ev, om0[i], cfg)
        _bitwise(res_w, P.map_result(lambda a: a[i], res_b))
    oms_streams, res_streams = T.estimate_streams(streams, om0, cfg)
    for s in range(S):
        oms, res_s = T.estimate_sequence(streams.map(lambda a: a[s]), om0[s],
                                         cfg)
        assert torch.equal(oms, oms_streams[s])
        _bitwise(res_s, P.map_result(lambda a: a[s], res_streams))


@pytest.mark.parametrize("engine", ENGINES)
def test_slot_independence_bitwise(ref, engine):
    """A window's whole result is bit-identical at B=1 and in its slot of a
    B=4 batch whose other slots hold other windows."""
    cfg = _tcfg(engine)
    streams = _win(ref["streams"])
    wins = [streams.map(lambda a, s=s, k=k: a[s, k])
            for s, k in ((0, 0), (1, 1), (2, 0), (0, 1))]
    batch = t_events.batch_windows(wins)
    om0 = torch.tensor(np.concatenate([ref["om0"], ref["om0"][:1]]))
    res_b = T.estimate_batch(batch, om0, cfg)
    for i in (0, 3):
        res_1 = T.estimate_batch(batch.map(lambda a: a[i:i + 1]),
                                 om0[i:i + 1], cfg)
        assert torch.equal(res_1.omega[0], res_b.omega[i])
        for t1, tb in zip(res_1.stages, res_b.stages):
            # NaN pads the unused history slots; NaN == NaN here
            np.testing.assert_array_equal(t1.v_history[0].numpy(),
                                          tb.v_history[i].numpy())
            assert torch.equal(t1.v_final[0], tb.v_final[i])
            assert int(t1.iters[0]) == int(tb.iters[i])


def test_cuda_engine_matches_pallas_engine(ref):
    """The per-window engines of both packages on the same batch, at a
    per-tile capacity at which both spill at the coarse stages."""
    jcfg = dataclasses.replace(_jcfg(), engine="pallas", engine_capacity=512)
    expect = jax.device_get(R.estimate_batch(ref["first"],
                                             jnp.asarray(ref["om0"]), jcfg))
    cfg = config_from_reference(jcfg)
    assert (cfg.engine, cfg.engine_capacity) == ("cuda", 512)
    first, om0 = _win(ref["first"]), torch.tensor(ref["om0"])
    assert bool((ops.iwe_accum(first, om0, cfg.camera, 0.25,
                               capacity=512).spilled > 0).all())
    res = T.estimate_batch(first, om0, cfg)
    _assert_matches(res, expect)


def test_lockstep_passes_count_the_engine_calls(ref, monkeypatch):
    """Every lockstep pass of the cuda_batched engine is exactly one call of
    the kernel wrapper, and `lockstep_passes` counts them from the traces."""
    calls = []
    inner = ops.megakernel_stats

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return inner(*a, **kw)

    monkeypatch.setattr(ops, "megakernel_stats", counting)
    _, res = T.estimate_streams(_win(ref["streams"]),
                                torch.tensor(ref["om0"]),
                                _tcfg("cuda_batched"))
    assert len(calls) == P.lockstep_passes(res) > 0
    per_stage = P.lockstep_stage_passes(res)
    assert len(per_stage) == len(res.stages) and sum(per_stage) == len(calls)
    assert set(calls) == {S}


def test_fixed_schedule_and_full_resolution(ref):
    cam = _tcfg("cuda_batched").camera
    first = _win(ref["first"])
    om0 = torch.tensor(ref["om0"])
    fixed = dataclasses.replace(T.fixed_schedule_config(cam, iters=(2, 1, 3)),
                                stages=_tcfg("reference").stages)
    res = T.estimate_batch(first, om0, fixed)
    assert [st.iters.tolist() for st in res.stages] == \
        [[2] * S, [1] * S, [3] * S]
    full = T.full_resolution_config(cam, max_iters=3)
    res = T.estimate_batch(first, om0, full)
    assert len(res.stages) == 1 and bool(torch.isfinite(res.omega).all())
    gains = P.measured_stage_gains(res)
    assert gains.shape == (S, 1)
    assert result_to_numpy(res).omega.shape == (S, 3)


def _lockstep_before_graphs(ev, omega, cfg, iter_caps=None):
    """The masked lockstep as it was written before the residence loop ran
    on CUDA graphs (one loop rebinding its carry, per stage): the oracle of
    the CPU path's bits."""
    B = omega.shape[0]
    omega = omega.to(cfg.dtype)
    traces = []
    for si, stage in enumerate(cfg.stages):
        engine_b = P.make_batched_engine_pass(cfg.camera, stage, cfg)
        ost = T.cgpr.init_state(3, cfg.dtype, device="cpu", batch=(B,))
        tables = T.sort_events(ev, omega, cfg.camera, stage)
        weights = tables.weights
        v_entry, g_entry = engine_b(ev, weights, omega)
        max_iters = stage.max_iters if cfg.adaptive \
            else int(cfg.fixed_iters[si])
        cap = torch.full((B,), max_iters, dtype=torch.int32)
        if iter_caps is not None:
            cap = torch.minimum(cap, iter_caps[:, si].to(torch.int32))
        update = T.cgpr.step if cfg.use_cgpr else \
            T.cgpr.gradient_ascent_step
        alpha0 = torch.full((B,), cfg.step_size * stage.step_scale,
                            dtype=cfg.dtype)
        alpha_floor = alpha0 / 64.0
        rows = torch.arange(B)
        no = torch.zeros((B,), dtype=torch.bool)
        hist = torch.full((B, max_iters), float("nan"), dtype=v_entry.dtype)
        carry = ((omega, ost), v_entry, g_entry,
                 torch.zeros((B,), dtype=torch.int32), no, alpha0)
        active = (~carry[4]) & (carry[3] < cap)
        while bool(active.any()):
            (om, st), v_prev, g, it, done, alpha = carry
            om_p, st_p = update(om, g, st, alpha)
            v_p, g_p = engine_b(ev, weights, om_p)
            it_c = it.clamp(0, max(max_iters - 1, 0)).long()
            hist[rows, it_c] = torch.where(active, v_p, hist[rows, it_c])
            improved = v_p > v_prev
            sel = lambda new, old: P._masked_select(improved, new, old)
            if cfg.adaptive:
                g_norm = (v_p - v_prev) / torch.clamp(torch.abs(v_prev),
                                                      min=1e-12)
                done_ok = improved & (g_norm < stage.tau)
            else:
                done_ok = no
            alpha_n = torch.where(improved, alpha, alpha * 0.5)
            done_stuck = ((~improved) & (alpha_n < alpha_floor)) \
                if cfg.adaptive else no
            new = ((sel(om_p, om), sel(st_p, st)), sel(v_p, v_prev),
                   sel(g_p, g), it + 1, done_ok | done_stuck, alpha_n)
            carry = P._masked_select(active, new, carry)
            active = (~carry[4]) & (carry[3] < cap)
        (om, _), v_fin, _, iters, _, _ = carry
        traces.append(T.StageTrace(
            iters=iters, passes=iters + 1, n_retained=tables.n_retained,
            v_final=v_fin, v_entry=v_entry, v_history=hist,
            omega_entry=omega, omega_exit=om))
        omega = om
    return T.WindowResult(omega=omega, stages=tuple(traces))


def _bitwise(res_a, res_b):
    leaves = lambda r: [r.omega] + [a for st in r.stages for a in st]
    for a, b in zip(leaves(res_a), leaves(res_b), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("engine", ENGINES)
def test_cpu_lockstep_is_eager_and_keeps_its_bits(ref, engine, schedule):
    """On the CPU the residence loop captures no CUDA graph and counts no
    replay or eager pass, and every engine gives the bits of the lockstep
    as it was before graphs: the adaptive and fixed schedules, plain
    gradient ascent, and caps below `max_iters`."""
    from repro_torch.core import graphs as G
    cfg = _scheduled(engine, schedule)
    caps = torch.tensor(CAPS) if schedule == "caps" else None
    first, om0 = _win(ref["first"]), torch.tensor(ref["om0"])
    n_classes = len(G._CLASSES)
    with G.graph_tally() as counts:
        res = T.estimate_batch(first, om0, cfg) if caps is None \
            else T.estimate_batch_budgeted(first, om0, caps, cfg)
    assert counts == {} and len(G._CLASSES) == n_classes
    _bitwise(res, _lockstep_before_graphs(first, om0, cfg, caps))
