"""The port's device grid (`launch/mesh.py`), data-parallel estimation
(`core/distributed.py`) and the services under a grid, on the CPU.

  * on a (4, 2) grid of repeated `cpu` entries, with the small camera and
    the two-stage config of `tests/test_sharding_subprocess.py`,
    `estimate_batch_sharded` / `estimate_streams_sharded` /
    `estimate_batch_distributed` are bitwise equal to the port's local
    `estimate_windows_parallel` / `estimate_streams`; an indivisible batch
    is refused; a shard's exception re-raises in the caller;
  * the port's `estimate_batch_sharded` against the reference's on a
    one-device `jax.make_mesh((1, 1), ("data", "model"))` (omega
    atol=5e-4, v_final rtol=1e-3 where iterations match, the bar of
    `tests/test_megakernel.py:168-173`);
  * `CmaxWorkload(mesh=grid)` through both services: every served omega
    bitwise equal to the batch-1 chain of the same workload without a
    grid; batch classes as the reference's `_batch_class`; budgeted QoS
    classes refused with the reference's message.

The plain path is slot-invariant bitwise only single-threaded, so the file
sets `torch.set_num_threads(1)`.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.distributed import \
    estimate_batch_sharded as r_estimate_batch_sharded
from repro.data import events as r_events
from repro.launch import serve as r_serve

import repro_torch.core as T
from repro_torch.convert import config_from_reference
from repro_torch.core import distributed as D
from repro_torch.data import events as t_events
from repro_torch.launch import mesh as M
from repro_torch.launch import serve as t_serve
from repro_torch.serving import CmaxWorkload

torch.set_num_threads(1)

R_CAM = R.Camera(width=64, height=48, fx=53.0, fy=53.0, cx=32.0, cy=24.0)
R_CFG = R.CmaxConfig(camera=R_CAM, stages=(
    R.StageConfig(scale=0.5, tau=4e-4, max_iters=3, blur_taps=3,
                  blur_sigma=0.5, keep_ratio=0.5),
    R.StageConfig(scale=1.0, tau=1.5e-4, max_iters=3, blur_taps=5,
                  blur_sigma=1.0, keep_ratio=1.0)))
CFG = config_from_reference(R_CFG)                 # engine "reference"


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for o in obj for t in _leaves(o)]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.device == y.device
        if x.is_floating_point():      # bit patterns: NaN marks unrun steps
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


def _win(ev) -> T.EventWindow:
    return T.EventWindow(*[torch.tensor(np.asarray(a))
                           for a in (ev.x, ev.y, ev.t, ev.p, ev.valid)])


@pytest.fixture(scope="module")
def seq():
    spec = r_events.SequenceSpec(name="t", n_windows=8,
                                 events_per_window=256, n_features=30,
                                 seed=5, window_dt=0.03, camera=R_CAM)
    wins, om_true, om_imu = r_events.make_sequence(spec)
    return wins, np.asarray(om_true), np.asarray(om_imu)


@pytest.fixture(scope="module")
def grid():
    return M.make_smoke_mesh(8, model=2, device_type="cpu")


def test_grid_shape_axes_and_shard_devices():
    g = M.make_mesh((2, 2, 2), ("pod", "data", "model"),
                    devices=[f"cpu:{i}" for i in range(8)])
    assert g.axis_names == ("pod", "data", "model")
    assert g.shape == {"pod": 2, "data": 2, "model": 2} and g.size == 8
    assert M.dp_axes(g) == D._dp_axes(g) == ("pod", "data")
    assert D._dp_extent(g) == 4
    # one shard per (pod, data) index, on its model-0 device, row-major
    assert [d.index for d in D._shard_devices(g)] == [0, 2, 4, 6]
    g2 = M.make_mesh((2, 2), ("model", "data"),
                     devices=[f"cpu:{i}" for i in range(4)])
    assert [d.index for d in D._shard_devices(g2)] == [0, 1]
    with pytest.raises(ValueError):
        M.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        M.make_smoke_mesh(3, model=2, device_type="cpu")
    with pytest.raises(ValueError, match="unsupported device type"):
        M.make_smoke_mesh(2, device_type="mps")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            M.make_smoke_mesh()


def test_batch_sharded_bitwise_equals_local(seq, grid):
    wins, _, om_imu = seq
    w, om = _win(wins), torch.tensor(om_imu)
    res = D.estimate_batch_sharded(w, om, CFG, grid)
    _assert_bitwise(res, T.estimate_windows_parallel(w, om, CFG))
    assert res.omega.shape == (8, 3)


def test_streams_sharded_bitwise_equals_local(seq, grid):
    wins, _, om_imu = seq
    w = _win(wins)
    # 4 streams of 2 consecutive windows, warm-started at the IMU
    sw = w.map(lambda a: a.reshape((4, 2) + a.shape[1:]))
    om0 = torch.tensor(om_imu[::2])
    out = D.estimate_streams_sharded(sw, om0, CFG, grid)
    _assert_bitwise(out, T.estimate_streams(sw, om0, CFG))
    assert out[0].shape == (4, 2, 3)


def test_uneven_batch_distributed_and_refused_when_sharded(seq, grid):
    wins, _, om_imu = seq
    w3 = _win(wins).map(lambda a: a[:3])
    om3 = torch.tensor(om_imu[:3])
    res = D.estimate_batch_distributed(w3, om3, CFG, grid)
    _assert_bitwise(res, T.estimate_windows_parallel(w3, om3, CFG))
    with pytest.raises(ValueError, match="divisible"):
        D.estimate_batch_sharded(w3, om3, CFG, grid)
    with pytest.raises(ValueError, match="divisible"):
        D.estimate_streams_sharded(w3.map(lambda a: a[:, None]), om3, CFG,
                                   grid)


def test_a_shards_exception_reraises_in_the_caller(seq, grid, monkeypatch):
    wins, _, om_imu = seq
    calls = []
    real = D.estimate_windows_parallel

    def flaky(w, o, cfg):
        calls.append(float(o[0, 0]))
        if float(o[0, 0]) == 99.0:
            raise ArithmeticError("shard failed")
        return real(w, o, cfg)

    monkeypatch.setattr(D, "estimate_windows_parallel", flaky)
    om = torch.tensor(om_imu)
    om[4, 0] = 99.0                                   # the third shard
    with pytest.raises(ArithmeticError, match="shard failed"):
        D.estimate_batch_sharded(_win(wins), om, CFG, grid)
    assert len(calls) == 4          # every shard ran to its end first


@pytest.mark.parametrize("engine", ["reference", "cuda_batched"])
def test_batch_sharded_agrees_with_the_reference(seq, engine):
    wins, _, om_imu = seq
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = r_estimate_batch_sharded(wins, jnp.asarray(om_imu), R_CFG, jmesh)
    cfg = dataclasses.replace(CFG, engine=engine)
    tmesh = M.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    res = D.estimate_batch_sharded(_win(wins), torch.tensor(om_imu), cfg,
                                   tmesh)
    np.testing.assert_allclose(res.omega.numpy(), np.asarray(ref.omega),
                               atol=5e-4)
    for tr_r, tr_t in zip(ref.stages, res.stages):
        same = tr_t.iters.numpy() == np.asarray(tr_r.iters)
        assert same.any()
        np.testing.assert_allclose(tr_t.v_final.numpy()[same],
                                   np.asarray(tr_r.v_final)[same], rtol=1e-3)


# ---- the services under a grid ----


def _fast_cfg():
    cam = T.Camera(width=64, height=48, fx=53.0, fy=53.0, cx=32.0, cy=24.0)
    return T.CmaxConfig(camera=cam, stages=(
        T.StageConfig(scale=0.5, tau=4e-4, max_iters=4, blur_taps=3,
                      blur_sigma=0.5, keep_ratio=0.5, step_scale=1.5),
        T.StageConfig(scale=1.0, tau=1.5e-4, max_iters=4, blur_taps=5,
                      blur_sigma=1.0, keep_ratio=1.0)))


def _streams(cam, n_streams=3, n_windows=3, n_max=512):
    """{stream: ([ragged windows], omega_true (K, 3))} on the CPU, from the
    reference's generator."""
    out = {}
    r_cam = R.Camera(width=cam.width, height=cam.height, fx=cam.fx,
                     fy=cam.fy, cx=cam.cx, cy=cam.cy)
    for s in range(n_streams):
        spec = r_events.SequenceSpec(
            name=f"s{s}", n_windows=n_windows, events_per_window=n_max,
            n_features=40, seed=60 + s, window_dt=0.03, camera=r_cam)
        wins, om_true, _ = r_events.make_sequence(spec)
        lens = r_events.ragged_lengths(n_windows, n_max // 3, n_max, seed=s)
        w = _win(wins)
        out[f"s{s}"] = ([w.map(lambda a: a[k, :int(n)])
                         for k, n in enumerate(lens)], np.asarray(om_true))
    return out


def _chain(wl, wins, hint):
    state = np.asarray(hint, np.float32)
    out = []
    for w in wins:
        b = wl.bucket_of(w)
        data, sb, _ = wl.make_batch([w], [state], b, 1)
        _, state, _, _ = wl.harvest(wl.executable(b, 1)(data, sb), False)(0)
        out.append(state)
    return out


@pytest.mark.parametrize("service", ["async", "sync"])
def test_service_under_a_grid_matches_the_batch_1_chain(service):
    cfg = _fast_cfg()
    policy = t_events.pow2_policy(min_bucket=128, max_bucket=512)
    grid = M.make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"])
    gwl = CmaxWorkload(cfg, policy=policy, mesh=grid)
    plain = CmaxWorkload(cfg, policy=policy, device="cpu")
    streams = _streams(cfg.camera)
    if service == "async":
        svc = t_serve.AsyncBatchedEstimationService(
            workload=gwl, max_batch=4, max_in_flight=2)
    else:
        svc = t_serve.BatchedEstimationService(workload=gwl, max_batch=4)
    for sid, (wins, om_true) in streams.items():
        for k, w in enumerate(wins):
            svc.submit(sid, w, omega_hint=om_true[0] if k == 0 else None)
    rs = svc.drain()
    if service == "async":
        svc.executor.close()
    assert len(rs) == 9 and all(r.status == "ok" for r in rs)
    assert all(r.batch_b % 2 == 0 for r in rs)
    by = {(r.stream_id, r.seq): r.omega for r in rs}
    for sid, (wins, om_true) in streams.items():
        for k, om in enumerate(_chain(plain, wins, om_true[0])):
            assert np.array_equal(by[(sid, k)], om), (sid, k)


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_batch_class_matches_the_reference(dp):
    r_mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                   shape={"data": dp, "model": 1})
    t_mesh = M.make_mesh((dp, 1), ("data", "model"), devices=["cpu"] * dp)
    for max_batch in (1, 2, 4, 8):
        for b in range(1, max_batch + 1):
            want = r_serve._batch_class(b, max_batch, r_mesh)
            assert t_serve._batch_class(b, max_batch, t_mesh) == want
            assert want % dp == 0
            assert t_serve._batch_class(b, max_batch, None) == \
                r_serve._batch_class(b, max_batch, None)


def test_budgets_under_a_grid_are_refused_with_the_reference_message():
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    grid = M.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    msgs = []
    for svc, q, cfg, mesh in (
            (r_serve.AsyncBatchedEstimationService, r_serve.QosClass,
             R_CFG, jmesh),
            (t_serve.AsyncBatchedEstimationService, t_serve.QosClass,
             CFG, grid)):
        with pytest.raises(ValueError) as e:
            svc(cfg, mesh=mesh, qos_classes=[q("eco", budget_uj=5.0)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "not supported with a mesh" in msgs[1]
