"""The port's whole slice — batched, warm-started CMAX estimation — against
the JAX package on the CPU.

`estimate_batch`, `estimate_streams` and `estimate_batch_budgeted` run under
every port engine (`reference`; `cuda` and `cuda_batched`, whose kernels run
their plain versions on the CPU) and are held to the JAX results on the
same simulator windows: omega atol=5e-4, v_final rtol=1e-3
(`tests/test_megakernel.py`'s end-to-end bars) and equal iteration counts.
The `cuda` engine is also held to the JAX `pallas` engine at a capacity
that spills. Slot independence is held to the port's own B=1 bits.
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


@pytest.mark.parametrize("engine", ENGINES)
def test_window_and_sequence_agree_with_batch(ref, engine):
    """The per-window entry points equal the batched path's slot."""
    cfg = _tcfg(engine)
    streams = _win(ref["streams"])
    om0 = torch.tensor(ref["om0"])
    res_b = T.estimate_batch(streams.map(lambda a: a[:, 0]), om0, cfg)
    res_w = T.estimate_window(streams.map(lambda a: a[1, 0]), om0[1], cfg)
    np.testing.assert_allclose(res_w.omega.numpy(), res_b.omega[1].numpy(),
                               atol=1e-5)
    for tw, tb in zip(res_w.stages, res_b.stages):
        assert int(tw.iters) == int(tb.iters[1])
    oms, res_s = T.estimate_sequence(streams.map(lambda a: a[2]), om0[2], cfg)
    oms_streams, _ = T.estimate_streams(streams, om0, cfg)
    np.testing.assert_allclose(oms.numpy(), oms_streams[2].numpy(),
                               atol=1e-5)
    caps = torch.tensor([2, 0, 1], dtype=torch.int32)
    res_c = T.estimate_window_budgeted(streams.map(lambda a: a[0, 0]),
                                       om0[0], caps, cfg)
    assert all(int(st.iters) <= int(c)
               for st, c in zip(res_c.stages, caps))
    assert int(res_c.stages[1].iters) == 0


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
