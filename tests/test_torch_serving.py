"""The port's serving layer on the CPU: the scheduler contracts of the
reference's serving tests, held to the port's own batch-1 chain, and the
slice as a whole against the JAX service.

  * the CMAX contracts of `tests/test_serving_async.py` (all 13), the CMAX
    harness of `tests/test_workload_conformance.py` (its 7 contracts) and
    the service-level tests of `tests/test_telemetry.py`, on the small
    camera with the two-stage `fast_cfg`, under the port's default engine
    (`cuda_batched`, whose kernel runs its plain version on the CPU). Every
    omega is held bitwise to a sequential batch-1 chain of the port;
  * the same ragged streams through the JAX service and the port's, both
    on the `reference` engine with `InlineExecutor` and a `FakeClock`:
    omega atol=5e-4 (the reference's end-to-end bar,
    `tests/test_megakernel.py:168-173`), equal iterations, statuses,
    sequence numbers, classes and stats;
  * one drain on the per-window `cuda` engine, bitwise to its own chain;
  * the threaded executor on the CPU, and the `cmax` CLI at a tiny size.

The plain path is slot-invariant bitwise only single-threaded, so the file
sets `torch.set_num_threads(1)`.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import repro.core as R
from repro.data import events as r_events
from repro.launch import serve as r_serve

from repro_torch.convert import config_from_reference
from repro_torch.core import CmaxConfig, StageConfig, estimate_window
from repro_torch.core.adaptive import residence_verdict
from repro_torch.core.types import Camera
from repro_torch.data import events as ev_data
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                      AsyncDispatchExecutor,
                                      BatchedEstimationService, FakeClock,
                                      InlineExecutor, ManualExecutor,
                                      QosClass, main)
from repro_torch.serving import CmaxWorkload
from repro_torch.telemetry import (DECISION_FIELDS, SPAN_FIELDS, NullTracer,
                                   Telemetry, read_jsonl, write_jsonl)
from helpers import small_camera as r_small_camera

torch.set_num_threads(1)


def small_camera() -> Camera:
    return Camera(**dataclasses.asdict(r_small_camera()))


def fast_cfg(cam=None, engine="cuda_batched") -> CmaxConfig:
    """Two cheap stages on the tiny camera — adaptive logic intact."""
    return CmaxConfig(camera=cam or small_camera(), engine=engine, stages=(
        StageConfig(scale=0.5, tau=4e-4, max_iters=4, blur_taps=3,
                    blur_sigma=0.5, keep_ratio=0.5, step_scale=1.5),
        StageConfig(scale=1.0, tau=1.5e-4, max_iters=4, blur_taps=5,
                    blur_sigma=1.0, keep_ratio=1.0),
    ))


POLICY = ev_data.pow2_policy(min_bucket=128, max_bucket=512)


def ragged_streams(cam, n_streams=2, n_windows=3, n_max=512, fixed=False):
    """{stream: [ragged windows]} on the tiny camera, on the CPU."""
    out = {}
    for s in range(n_streams):
        spec = ev_data.SequenceSpec(
            name=f"s{s}", n_windows=n_windows, events_per_window=n_max,
            n_features=40, seed=50 + s, window_dt=0.03, camera=cam)
        wins, _, _ = ev_data.make_sequence(spec, device="cpu")
        lens = (np.full(n_windows, n_max) if fixed else
                ev_data.ragged_lengths(n_windows, n_max // 3, n_max, seed=s))
        out[f"s{s}"] = ev_data.ragged_from_sequence(wins, lens)
    return out


def one_window(cam, seed=0, n=256):
    spec = ev_data.SequenceSpec(name="w", n_windows=1, events_per_window=n,
                                n_features=40, seed=seed, camera=cam)
    wins, _, _ = ev_data.make_sequence(spec, device="cpu")
    return ev_data.window_slice(wins, 0)


def make_svc(cam, **kw):
    kw.setdefault("policy", POLICY)
    kw.setdefault("clock", FakeClock())
    kw.setdefault("executor", ManualExecutor())
    kw.setdefault("device", "cpu")
    return AsyncBatchedEstimationService(fast_cfg(cam), **kw)


def reference_chain(windows, policy, cfg):
    """Sequential per-window warm-start chain (`estimate_window` on the
    padded window, a batch of one under `cuda_batched`): the ground truth
    every service schedule must reproduce."""
    om = np.zeros(3, np.float32)
    out = []
    for w in windows:
        res = estimate_window(ev_data.pad_window(w, policy.bucket_of(w.n)),
                              torch.as_tensor(om), cfg)
        om = res.omega.numpy()
        out.append(om)
    return out


def workload_chain(wl, payloads):
    """Sequential batch-1 chain through the workload's own machinery
    (make_batch -> executable -> harvest, carried state chained)."""
    state = wl.default_state()
    outs = []
    for p in payloads:
        b = wl.bucket_of(p)
        data, sb, _ = wl.make_batch([p], [state], b, 1)
        res = wl.executable(b, 1, donate=False)(data, sb)
        out, state, _, _ = wl.harvest(res, False)(0)
        outs.append(np.asarray(out))
    return outs


# ===========================================================================
# tests/test_serving_async.py, ported
# ===========================================================================


def test_deadline_expiry_sheds_queued_requests():
    cam = small_camera()
    clock = FakeClock()
    ex = ManualExecutor()
    svc = make_svc(cam, clock=clock, executor=ex, max_batch=1,
                   max_in_flight=1)
    w = one_window(cam)
    svc.submit("a", w)                                 # no SLO, dispatches
    assert svc.poll() == []
    assert ex.in_flight() and svc.in_flight() == 1
    svc.submit("a", w, deadline=clock.now() + 1.0)
    clock.advance(2.0)
    shed = svc.poll()
    assert [r.status for r in shed] == ["shed"]
    assert shed[0].seq == 1 and shed[0].batch_b == 0 and shed[0].iters == ()
    assert shed[0].latency == 2.0                      # time spent queued
    assert svc.stats["shed"] == 1
    ex.release()
    done = svc.poll()
    assert [r.status for r in done] == ["ok"] and done[0].seq == 0


def test_deadline_in_future_is_not_shed():
    cam = small_camera()
    clock = FakeClock()
    svc = make_svc(cam, clock=clock, executor=InlineExecutor())
    svc.submit("a", one_window(cam), deadline=clock.now() + 10.0)
    rs = svc.drain()
    assert [r.status for r in rs] == ["ok"]
    assert svc.stats["shed"] == 0


def test_shed_window_skips_warm_start_chain():
    cam = small_camera()
    cfg = fast_cfg(cam)
    wins = ragged_streams(cam, 1, n_windows=3)["s0"]
    clock = FakeClock()
    svc = make_svc(cam, clock=clock, executor=InlineExecutor())
    svc.submit("a", wins[0])
    rs = svc.drain()
    svc.submit("a", wins[1], deadline=clock.now() - 1.0)   # already late
    svc.submit("a", wins[2])
    rs += svc.drain()
    by = {r.seq: r for r in rs}
    assert by[1].status == "shed"
    ref = reference_chain([wins[0], wins[2]], POLICY, cfg)  # chain skips w1
    np.testing.assert_array_equal(by[0].omega, ref[0])
    np.testing.assert_array_equal(by[2].omega, ref[1])


def test_priority_preempts_fifo_order():
    cam = small_camera()
    ex = ManualExecutor()
    svc = make_svc(cam, executor=ex, max_batch=2, max_in_flight=1)
    w = one_window(cam)
    svc.submit("a", w, priority=0)
    svc.submit("b", w, priority=0)
    svc.submit("c", w, priority=5)     # submitted last, highest priority
    svc.poll()
    assert svc.in_flight() == 2 and svc.pending() == 1
    ex.release()
    first = [r.stream_id for r in svc.poll() if r.status == "ok"]
    assert first == ["c", "a"]         # c leads, then FIFO among prio 0
    ex.release()
    assert [r.stream_id for r in svc.drain()] == ["b"]


def test_priority_cannot_reorder_one_stream():
    cam = small_camera()
    cfg = fast_cfg(cam)
    wins = ragged_streams(cam, 1, n_windows=2)["s0"]
    svc = make_svc(cam, executor=InlineExecutor(), max_batch=1)
    svc.submit("a", wins[0], priority=0)
    svc.submit("a", wins[1], priority=9)
    rs = [r for r in svc.drain() if r.status == "ok"]
    assert [r.seq for r in rs] == [0, 1]
    ref = reference_chain(wins, POLICY, cfg)
    np.testing.assert_array_equal(rs[0].omega, ref[0])
    np.testing.assert_array_equal(rs[1].omega, ref[1])


def test_admission_continues_while_batch_in_flight():
    cam = small_camera()
    ex = ManualExecutor()
    svc = make_svc(cam, executor=ex, max_batch=2, max_in_flight=2)
    w = one_window(cam)
    svc.submit("a", w)
    svc.submit("b", w)
    svc.poll()
    assert svc.in_flight() == 2 and len(ex.in_flight()) == 1
    svc.submit("c", w)
    svc.submit("d", w)
    svc.poll()
    assert svc.in_flight() == 4 and len(ex.in_flight()) == 2
    assert svc.pending() == 0
    ex.release()
    assert len(svc.poll()) == 4


def test_slot_refill_does_not_wait_for_older_batches():
    cam = small_camera()
    ex = ManualExecutor()
    svc = make_svc(cam, executor=ex, max_batch=2, max_in_flight=2)
    w = one_window(cam)
    for sid in "abcd":
        svc.submit(sid, w)
    svc.poll()                             # batch0 = (a,b), batch1 = (c,d)
    h0, h1 = ex.in_flight()
    svc.submit("e", w)
    svc.submit("f", w)
    ex.release(h1)                         # the YOUNGER batch finishes first
    done = svc.poll()
    assert sorted(r.stream_id for r in done) == ["c", "d"]
    assert svc.in_flight() == 4 and svc.pending() == 0
    assert h0 in ex.in_flight() and len(ex.in_flight()) == 2
    ex.release()
    assert sorted(r.stream_id for r in svc.drain()) == list("abef")


def test_stream_never_has_two_windows_in_flight():
    cam = small_camera()
    ex = ManualExecutor()
    svc = make_svc(cam, executor=ex, max_batch=1, max_in_flight=4)
    wins = ragged_streams(cam, 1, n_windows=2, n_max=256)["s0"]
    svc.submit("a", wins[0])
    svc.submit("a", wins[1])
    svc.poll()
    assert svc.in_flight() == 1 and svc.pending() == 1   # w1 held back
    ex.release()
    svc.poll()
    assert svc.in_flight() == 1 and svc.pending() == 0   # w1 launched now
    ex.release()
    assert [r.seq for r in svc.poll()] == [1]


def test_warm_start_survives_out_of_order_refill():
    cam = small_camera()
    cfg = fast_cfg(cam)
    streams = ragged_streams(cam, 2, n_windows=3)
    ex = ManualExecutor()
    svc = make_svc(cam, executor=ex, max_batch=1, max_in_flight=2)
    for sid, wins in streams.items():
        for w in wins:
            svc.submit(sid, w)
    rs = []
    flip = False
    while svc.pending() or svc.in_flight():
        rs.extend(svc.poll())
        pending = ex.in_flight()
        if pending:                       # alternate which batch finishes
            ex.release(pending[-1] if flip else pending[0])
            flip = not flip
    rs.extend(svc.poll())
    assert len(rs) == 6
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, wins in streams.items():
        ref = reference_chain(wins, POLICY, cfg)
        for k in range(len(wins)):
            np.testing.assert_array_equal(by[(sid, k)].omega, ref[k])
        seqs = [r.seq for r in rs if r.stream_id == sid]
        assert seqs == sorted(seqs)


def test_async_drain_exactly_matches_sequential_reference():
    """The full async service (the threaded dispatch executor, continuous
    refill) reproduces the sequential per-window chain exactly on the
    CPU — same bits, any schedule."""
    cam = small_camera()
    cfg = fast_cfg(cam)
    streams = ragged_streams(cam, 3, n_windows=3)
    svc = AsyncBatchedEstimationService(cfg, policy=POLICY, max_batch=4,
                                        max_in_flight=2, device="cpu")
    assert isinstance(svc.executor, AsyncDispatchExecutor)
    for sid, wins in streams.items():
        for w in wins:
            svc.submit(sid, w)
    rs = svc.drain()
    svc.executor.close()
    assert len(rs) == 9 and all(r.status == "ok" for r in rs)
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, wins in streams.items():
        ref = reference_chain(wins, POLICY, cfg)
        for k in range(len(wins)):
            assert by[(sid, k)].omega.dtype == np.float32
            np.testing.assert_array_equal(by[(sid, k)].omega, ref[k])


def test_async_matches_sync_service_exactly():
    cam = small_camera()
    cfg = fast_cfg(cam)
    streams = ragged_streams(cam, 3, n_windows=2)
    a = AsyncBatchedEstimationService(cfg, policy=POLICY, max_batch=4,
                                      device="cpu")
    b = BatchedEstimationService(cfg, policy=POLICY, max_batch=4,
                                 device="cpu")
    for sid, wins in streams.items():
        for w in wins:
            a.submit(sid, w)
            b.submit(sid, w)
    ra = {(r.stream_id, r.seq): r.omega for r in a.drain()}
    a.executor.close()
    rb = {(r.stream_id, r.seq): r.omega for r in b.drain()}
    assert ra.keys() == rb.keys()
    for k in ra:
        np.testing.assert_array_equal(ra[k], rb[k])


def test_padding_stats_and_executable_cache():
    cam = small_camera()
    svc = make_svc(cam, executor=InlineExecutor(), max_batch=4)
    streams = ragged_streams(cam, 3, n_windows=2)
    for sid, wins in streams.items():
        for w in wins:
            svc.submit(sid, w)
    svc.drain()
    assert svc.stats["windows"] == 6
    assert svc.stats["compiles"] == len(svc._cache)
    assert 0.0 <= svc.padded_slot_frac < 1.0
    first = svc.stats["compiles"]
    for sid, wins in streams.items():   # same shapes -> no new classes
        for w in wins:
            svc.submit(sid, w)
    svc.drain()
    assert svc.stats["compiles"] == first


def test_latency_timestamps_on_fake_clock():
    cam = small_camera()
    clock = FakeClock(100.0)
    ex = ManualExecutor()
    svc = make_svc(cam, clock=clock, executor=ex, max_batch=1)
    svc.submit("a", one_window(cam))
    svc.poll()
    clock.advance(0.25)
    ex.release()
    (r,) = svc.poll()
    assert r.t_submit == 100.0 and r.t_done == 100.25
    assert abs(r.latency - 0.25) < 1e-12


# ===========================================================================
# tests/test_workload_conformance.py, the CMAX harness, ported
# ===========================================================================


@pytest.fixture(scope="module")
def wl():
    return CmaxWorkload(fast_cfg(), policy=POLICY, device="cpu")


def conf_svc(wl, **kw):
    kw.setdefault("clock", FakeClock())
    return AsyncBatchedEstimationService(workload=wl, **kw)


def conf_streams(n_streams=2, n_payloads=3, fixed=False):
    return ragged_streams(small_camera(), n_streams, n_payloads, fixed=fixed)


def test_fifo_carried_state_any_completion_order(wl):
    streams = conf_streams(2, 3)
    ex = ManualExecutor()
    svc = conf_svc(wl, executor=ex, max_batch=1, max_in_flight=2)
    for sid, ps in streams.items():
        for p in ps:
            svc.submit(sid, p)
    rs = []
    flip = False
    while svc.pending() or svc.in_flight():
        rs.extend(svc.poll())
        pending = ex.in_flight()
        if pending:
            ex.release(pending[-1] if flip else pending[0])
            flip = not flip
    rs.extend(svc.poll())
    assert len(rs) == 6 and all(r.status == "ok" for r in rs)
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, ps in streams.items():
        ref = workload_chain(wl, ps)
        for k in range(len(ps)):
            np.testing.assert_array_equal(by[(sid, k)].omega, ref[k])
        seqs = [r.seq for r in rs if r.stream_id == sid]
        assert seqs == sorted(seqs)


def test_slot_independence_at_fixed_batch(wl):
    streams = conf_streams(4, 2, fixed=True)
    svc = conf_svc(wl, executor=InlineExecutor(), max_batch=4)
    for sid, ps in streams.items():
        for p in ps:
            svc.submit(sid, p)
    rs = svc.drain()
    assert all(r.batch_b == 4 for r in rs)     # actually batched together
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, ps in streams.items():
        ref = workload_chain(wl, ps)
        for k in range(len(ps)):
            np.testing.assert_array_equal(by[(sid, k)].omega, ref[k])


def test_deadline_shed_semantics_and_chain_skip(wl):
    (_, ps), = conf_streams(1, 3).items()
    clock = FakeClock()
    svc = conf_svc(wl, clock=clock, executor=InlineExecutor(), max_batch=1)
    svc.submit("a", ps[0])
    rs = svc.drain()
    svc.submit("a", ps[1], deadline=clock.now() - 1.0)     # already late
    svc.submit("a", ps[2])
    rs += svc.drain()
    by = {r.seq: r for r in rs}
    assert by[1].status == "shed"
    assert by[1].batch_b == 0 and by[1].iters == ()
    assert svc.stats["shed"] == 1
    ref = workload_chain(wl, [ps[0], ps[2]])   # skips ps[1]
    np.testing.assert_array_equal(by[0].omega, ref[0])
    np.testing.assert_array_equal(by[2].omega, ref[1])


def test_shed_before_first_completion_uses_default_placeholder(wl):
    clock = FakeClock()
    svc = conf_svc(wl, clock=clock, executor=InlineExecutor())
    (_, (p, *_)), = conf_streams(1, 1).items()
    svc.submit("fresh", p, deadline=clock.now() - 1.0)
    (r,) = svc.drain()
    assert r.status == "shed"
    np.testing.assert_array_equal(r.omega, wl.shed_output(None))


def test_qos_budget_behavior(wl):
    qos = [QosClass("tight", budget_uj=1e-3)]
    streams = conf_streams(2, 2)

    def total_iters(**kw):
        svc = conf_svc(wl, executor=InlineExecutor(), max_batch=2, **kw)
        for sid, ps in streams.items():
            for p in ps:
                svc.submit(sid, p, **({"qos": "tight"} if kw else {}))
        rs = svc.drain()
        return sum(sum(r.iters) for r in rs), svc.stats

    free_iters, _ = total_iters()
    tight_iters, stats = total_iters(qos_classes=qos)
    assert tight_iters < free_iters
    assert stats["budgeted_windows"] == 4
    assert stats["budget_spent_uj"] >= 0.0


def test_executable_cache_hit_accounting(wl):
    streams = conf_streams(3, 2)
    svc = conf_svc(wl, executor=InlineExecutor(), max_batch=4)
    for sid, ps in streams.items():
        for p in ps:
            svc.submit(sid, p)
    svc.drain()
    first = svc.stats["compiles"]
    assert first == len(svc._cache) > 0
    batches0 = svc.stats["batches"]
    for sid, ps in streams.items():    # same shapes -> no new classes
        for p in ps:
            svc.submit(sid, p)
    svc.drain()
    assert svc.stats["compiles"] == first
    assert svc.stats["batches"] > batches0
    assert 0.0 <= svc.padded_slot_frac < 1.0


def test_span_schema_conformance(wl):
    streams = conf_streams(2, 2)
    tel = Telemetry(spans=True)
    svc = conf_svc(wl, executor=InlineExecutor(), max_batch=2, telemetry=tel)
    for sid, ps in streams.items():
        for p in ps:
            svc.submit(sid, p)
    rs = svc.drain()
    spans = tel.tracer.spans
    assert len(spans) == len(rs) == 4
    by = {(r.stream_id, r.seq): r for r in rs}
    for s in spans:
        d = s.to_dict()
        assert tuple(d) == SPAN_FIELDS          # exact schema, exact order
        assert [e for e, _ in s.events] == ["submit", "admit", "dispatch",
                                            "harvest"]
        r = by[(s.stream_id, s.seq)]
        assert d["status"] == "ok" and d["qos"] == "standard"
        assert d["iters"] == list(r.iters)
        assert d["bucket_n"] == r.bucket_n and d["batch_b"] == r.batch_b
        assert isinstance(d["compile"], bool)
        assert d["latency_s"] == r.latency      # same clock reads
        assert sum(d["phases"].values()) == pytest.approx(r.latency,
                                                          abs=1e-12)


# ===========================================================================
# tests/test_telemetry.py, the service-level tests, ported
# ===========================================================================


def test_span_lifecycle_out_of_order_harvest():
    cam = small_camera()
    clock, ex = FakeClock(), ManualExecutor()
    tel = Telemetry(spans=True)
    svc = make_svc(cam, clock=clock, executor=ex, max_batch=1,
                   max_in_flight=2, telemetry=tel)
    svc.submit("a", one_window(cam, seed=0))
    clock.advance(0.25)
    svc.submit("b", one_window(cam, seed=1))
    svc.poll()                               # both dispatched (depth 2)
    h0, h1 = ex.in_flight()
    clock.advance(1.0)
    ex.release(h1)                           # newest batch finishes first
    done = svc.poll()
    clock.advance(0.5)
    ex.release(h0)
    done += svc.poll()
    rs = {r.stream_id: r for r in done}
    spans = {s.stream_id: s for s in tel.tracer.spans}
    assert set(spans) == {"a", "b"}
    assert [s.stream_id for s in tel.tracer.spans] == ["b", "a"]
    for sid in ("a", "b"):
        s, r = spans[sid], rs[sid]
        assert [e for e, _ in s.events] == ["submit", "admit", "dispatch",
                                            "harvest"]
        assert s.status == "ok" and s.iters == tuple(r.iters)
        assert s.latency_s == r.latency
        assert sum(s.phases().values()) == pytest.approx(r.latency,
                                                         abs=1e-12)
    assert spans["a"].phases()["execute"] == pytest.approx(1.5)
    assert spans["b"].phases()["execute"] == pytest.approx(1.0)
    assert spans["a"].phases()["queue_wait"] == pytest.approx(0.25)


def test_shed_span_and_reason_labels():
    cam = small_camera()
    clock, ex = FakeClock(), ManualExecutor()
    tel = Telemetry(spans=True)
    svc = make_svc(cam, clock=clock, executor=ex, max_batch=1,
                   max_in_flight=1, telemetry=tel)
    svc.submit("a", one_window(cam))
    svc.poll()
    svc.submit("a", one_window(cam), deadline=clock.now() + 1.0)
    clock.advance(2.0)
    svc.poll()                                         # sheds seq 1
    shed = [s for s in tel.tracer.spans if s.status == "shed"]
    assert len(shed) == 1 and shed[0].seq == 1
    assert [e for e, _ in shed[0].events] == ["submit", "shed"]
    assert shed[0].phases() == {"queue_wait": pytest.approx(2.0)}
    snap = tel.registry.snapshot()
    assert snap["repro_serving_shed_total"]['reason="deadline"'] == 1
    assert svc.stats["shed"] == 1


def test_fakeclock_traces_are_deterministic():
    cam = small_camera()

    def run():
        tel = Telemetry(spans=True, decisions=True)
        svc = make_svc(cam, clock=FakeClock(), executor=InlineExecutor(),
                       max_batch=2, telemetry=tel)
        for k in range(2):
            svc.submit("a", one_window(cam, seed=k))
            svc.submit("b", one_window(cam, seed=10 + k))
        svc.drain()
        return json.dumps(tel.trace_records(), sort_keys=True)

    assert run() == run()


def test_disabled_mode_is_noop():
    cam = small_camera()
    svc = make_svc(cam, clock=FakeClock(), executor=InlineExecutor())
    assert isinstance(svc.telemetry.tracer, NullTracer)
    assert not svc.telemetry.enabled
    svc.submit("a", one_window(cam))
    svc.drain()
    assert svc.telemetry.tracer.spans == ()
    assert svc.telemetry.decisions.records == ()
    assert svc.telemetry.trace_records() == []
    assert svc.stats["windows"] == 1       # the registry is still on


def test_stats_compat_view():
    cam = small_camera()
    svc = make_svc(cam, clock=FakeClock(), executor=InlineExecutor())
    assert sorted(svc.stats) == sorted(
        ["windows", "batches", "compiles", "event_slots", "raw_events",
         "fill_slots", "shed", "budgeted_windows", "budget_spent_uj"])
    svc.submit("a", one_window(cam))
    svc.drain()
    assert svc.stats["windows"] == 1 and svc.stats["batches"] == 1
    assert dict(svc.stats)["windows"] == 1            # Mapping protocol
    svc.stats["budgeted_windows"] += 3
    assert svc.telemetry.registry.snapshot()[
        "repro_serving_budgeted_windows_total"] == 3
    with pytest.raises(TypeError):
        svc.stats["shed"] = 0                          # derived: read-only
    with pytest.raises(KeyError):
        svc.stats["nope"]
    sync = BatchedEstimationService(fast_cfg(cam), policy=svc.policy,
                                    max_batch=2, device="cpu")
    assert sorted(sync.stats) == sorted(
        ["windows", "batches", "compiles", "event_slots", "raw_events",
         "fill_slots"])
    assert 0.0 <= sync.padded_slot_frac <= 1.0


def test_residence_verdicts():
    assert residence_verdict(0, None, 8) == "skip"
    assert residence_verdict(3, None, 8) == "run"
    assert residence_verdict(8, None, 8) == "max"
    assert residence_verdict(5, 5, 8) == "cap"
    assert residence_verdict(8, 12, 8) == "max"
    assert residence_verdict(4, 5, 8) == "run"
    assert residence_verdict(2, 2, None) == "cap"


def test_decision_log_reproduces_response_iters():
    cam = small_camera()
    tel = Telemetry(decisions=True)
    svc = make_svc(cam, clock=FakeClock(), executor=InlineExecutor(),
                   max_batch=2, telemetry=tel)
    for k in range(2):
        svc.submit("a", one_window(cam, seed=k))
        svc.submit("b", one_window(cam, seed=10 + k))
    rs = svc.drain()
    assert rs and all(r.status == "ok" for r in rs)
    logged = tel.decisions.iters_by_request()
    for r in rs:
        assert logged[(r.stream_id, r.seq)] == tuple(r.iters)
    assert len(tel.decisions.records) == len(rs) * len(svc.cfg.stages)
    for rec in tel.decisions.records:
        assert tuple(rec) == DECISION_FIELDS
        assert rec["verdict"] in ("run", "cap", "max", "skip")
        assert rec["cap"] is None                 # unbudgeted run
        assert rec["max_iters"] == int(svc.cfg.stages[rec["stage"]].max_iters)
        assert np.isfinite(rec["gain"])


def test_decision_log_budget_caps():
    cam = small_camera()
    tel = Telemetry(decisions=True)
    qos = [QosClass("tight", budget_uj=1e-3)]   # floor-only allocation
    svc = make_svc(cam, clock=FakeClock(), executor=InlineExecutor(),
                   max_batch=2, qos_classes=qos, telemetry=tel)
    svc.submit("a", one_window(cam, seed=0), qos="tight")
    svc.submit("b", one_window(cam, seed=1), qos="tight")
    rs = svc.drain()
    assert all(r.status == "ok" for r in rs)
    assert tel.decisions.records
    for rec in tel.decisions.records:
        assert rec["cap"] is not None
        assert rec["iters"] <= rec["cap"]
        if rec["iters"] == rec["cap"] and rec["cap"] < rec["max_iters"]:
            assert rec["verdict"] == "cap"
    logged = tel.decisions.iters_by_request()
    for r in rs:
        assert logged[(r.stream_id, r.seq)] == tuple(r.iters)


def test_strict_budget_refuses_unaffordable_windows():
    cam = small_camera()
    tel = Telemetry(spans=True)
    qos = [QosClass("hard", budget_uj=1e-6, strict=True)]
    svc = make_svc(cam, clock=FakeClock(), executor=InlineExecutor(),
                   max_batch=2, qos_classes=qos, telemetry=tel)
    w = one_window(cam)
    seq = svc.submit("a", w, qos="hard")
    rs = svc.drain()
    assert [r.status for r in rs] == ["refused"]
    assert rs[0].seq == seq and rs[0].iters == ()
    snap = tel.registry.snapshot()
    assert snap["repro_serving_shed_total"]['reason="budget"'] == 1
    assert svc.stats["shed"] == 1
    span = tel.tracer.spans[0]
    assert span.status == "refused"
    assert [e for e, _ in span.events] == ["submit", "shed"]
    svc2 = make_svc(cam, clock=FakeClock(), executor=InlineExecutor(),
                    qos_classes=[QosClass("hard", budget_uj=1e9,
                                          strict=True)])
    svc2.submit("a", w, qos="hard")
    assert [r.status for r in svc2.drain()] == ["ok"]
    assert svc.stats["windows"] == 0


def test_floor_cost_and_affordable():
    from repro_torch.costmodel import BudgetScheduler, load_profile
    sched = BudgetScheduler(load_profile("paper_fpga_45nm"))
    plan = sched.plan_window(fast_cfg(), 512)
    uj, ms = sched.floor_cost(plan)
    assert uj > 0 and ms > 0
    assert uj == pytest.approx(sum(sp.cost_uj for sp in plan.stages))
    assert sched.affordable(plan, budget_uj=uj)          # exactly at floor
    assert not sched.affordable(plan, budget_uj=uj * 0.5)
    assert not sched.affordable(plan, budget_ms=ms * 0.5)
    assert sched.affordable(plan)                        # no budget: always


def test_jsonl_roundtrip_and_summary(tmp_path):
    cam = small_camera()
    tel = Telemetry(spans=True, decisions=True)
    svc = make_svc(cam, clock=FakeClock(), executor=InlineExecutor(),
                   telemetry=tel)
    svc.submit("a", one_window(cam))
    svc.drain()
    trace = tmp_path / "trace.jsonl"
    n = tel.write_trace(str(trace))
    records = read_jsonl(str(trace))
    assert len(records) == n > 0
    span_recs = [r for r in records if r["type"] == "span"]
    assert span_recs and all(set(r) == set(SPAN_FIELDS) for r in span_recs)
    dec_recs = [r for r in records if r["type"] == "decision"]
    assert dec_recs and all(set(r) == set(DECISION_FIELDS)
                            for r in dec_recs)
    metrics = tmp_path / "metrics.prom"
    tel.write_metrics(str(metrics))
    text = metrics.read_text()
    assert "repro_serving_windows_total 1" in text
    assert "# TYPE repro_serving_queue_wait_seconds histogram" in text
    summary = tel.summary()
    assert "spans: 1" in summary and "adaptation verdicts:" in summary
    write_jsonl(str(trace), records)
    assert read_jsonl(str(trace)) == records


# ===========================================================================
# the slice as a whole: the JAX service and the port's on the same streams
# ===========================================================================


def _reference_streams(n_streams, n_windows):
    """The JAX package's ragged streams of `ragged_streams`."""
    cam = r_small_camera()
    out = {}
    for s in range(n_streams):
        spec = r_events.SequenceSpec(
            name=f"s{s}", n_windows=n_windows, events_per_window=512,
            n_features=40, seed=50 + s, window_dt=0.03, camera=cam)
        wins, _, _ = r_events.make_sequence(spec)
        lens = r_events.ragged_lengths(n_windows, 512 // 3, 512, seed=s)
        out[f"s{s}"] = r_events.ragged_from_sequence(wins, lens)
    return out


def test_port_service_matches_jax_service():
    r_cfg = R.CmaxConfig(camera=r_small_camera(), stages=tuple(
        R.StageConfig(**dataclasses.asdict(st))
        for st in fast_cfg().stages))
    t_cfg = config_from_reference(r_cfg)
    assert t_cfg.engine == "reference"
    r_pol = r_events.pow2_policy(min_bucket=128, max_bucket=512)
    r_svc = r_serve.AsyncBatchedEstimationService(
        r_cfg, policy=r_pol, max_batch=2, clock=r_serve.FakeClock(),
        executor=r_serve.InlineExecutor())
    t_svc = AsyncBatchedEstimationService(
        t_cfg, policy=POLICY, max_batch=2, clock=FakeClock(),
        executor=InlineExecutor(), device="cpu")
    r_streams = _reference_streams(3, 2)
    t_streams = ragged_streams(small_camera(), 3, 2)
    for sid in r_streams:
        for k, (rw, tw) in enumerate(zip(r_streams[sid], t_streams[sid])):
            assert rw.n == tw.n
            hint = [0.2, -0.1, 0.3] if k == 0 else None
            r_svc.submit(sid, rw, omega_hint=hint, priority=k % 2)
            t_svc.submit(sid, tw, omega_hint=hint, priority=k % 2)
    r_svc.submit("late", r_streams["s0"][0], deadline=-1.0)
    t_svc.submit("late", t_streams["s0"][0], deadline=-1.0)
    rr, tr = r_svc.drain(), t_svc.drain()
    assert len(rr) == len(tr) == 7
    for a, b in zip(rr, tr):
        assert (b.stream_id, b.seq, b.status, b.bucket_n, b.batch_b,
                b.iters) == (a.stream_id, a.seq, a.status, a.bucket_n,
                             a.batch_b, a.iters)
        assert b.omega.dtype == np.float32
        np.testing.assert_allclose(b.omega, np.asarray(a.omega), rtol=0,
                                   atol=5e-4)
    for key in ("batches", "compiles", "event_slots", "raw_events",
                "fill_slots", "shed", "windows"):
        assert t_svc.stats[key] == r_svc.stats[key], key


def test_per_window_engine_drain_matches_its_chain():
    """The `cuda` engine (tile accumulation + blur statistics; their plain
    versions on the CPU) served in batches equals its own batch-1 chain."""
    cam = small_camera()
    wl = CmaxWorkload(fast_cfg(cam, engine="cuda"), policy=POLICY,
                      device="cpu")
    streams = ragged_streams(cam, 3, n_windows=2)
    svc = AsyncBatchedEstimationService(workload=wl, max_batch=4,
                                        clock=FakeClock())
    for sid, wins in streams.items():
        for w in wins:
            svc.submit(sid, w)
    rs = svc.drain()
    svc.executor.close()
    assert len(rs) == 6 and max(r.batch_b for r in rs) > 1
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, wins in streams.items():
        ref = workload_chain(wl, wins)
        for k in range(len(wins)):
            np.testing.assert_array_equal(by[(sid, k)].omega, ref[k])


# ===========================================================================
# the threaded executor and the workload on the CPU, the CLI
# ===========================================================================


def test_dispatch_executor_runs_in_order_and_reports_done():
    ex = AsyncDispatchExecutor()
    gate = threading.Event()
    order = []

    def slow(w, o):
        assert gate.wait(timeout=30)
        order.append("slow")
        return w + o

    def fast(w, o):
        order.append("fast")
        return w * o

    one = torch.ones(3)
    h0 = ex.submit(slow, one, one, 0, 1)
    h1 = ex.submit(fast, one, 2 * one, 0, 1)
    assert not ex.done(h0) and not ex.done(h1)   # the worker is held
    gate.set()
    assert torch.equal(ex.wait(h1), 2 * one)
    assert ex.done(h0) and ex.done(h1)
    assert torch.equal(ex.wait(h0), 2 * one)
    assert order == ["slow", "fast"]             # one worker: submit order

    def fails(w, o):
        raise ValueError("bad batch")

    h2 = ex.submit(fails, one, one, 0, 1)
    with pytest.raises(ValueError, match="bad batch"):
        ex.wait(h2)
    assert ex.done(h2)
    ex.close()


def test_workload_batches_on_its_device_and_refuses_a_mesh(monkeypatch):
    wl = CmaxWorkload(fast_cfg(), policy=POLICY, device="cpu")
    ps = ragged_streams(small_camera(), 1, 2)["s0"]
    ev, om, n_fill = wl.make_batch(ps, [np.ones(3, np.float32)], 512, 4)
    assert n_fill == 2 and ev.x.shape == (4, 512)
    assert om.shape == (4, 3) and om.device.type == "cpu"
    assert bool((om == 1).all())
    # donate gives the donated form, as the reference's executable does
    from repro_torch.core import pipeline
    called = []
    for name in ("estimate_batch", "estimate_batch_donated"):
        monkeypatch.setattr(pipeline, name,
                            lambda w, o, c, name=name: called.append(name))
    wl.executable(512, 4, donate=True)(ev, om)
    wl.executable(512, 4, donate=False)(ev, om)
    assert called == ["estimate_batch_donated", "estimate_batch"]
    monkeypatch.undo()
    # a device grid is served (core/distributed.py), on its first device,
    # and budgeted QoS classes under it are refused
    grid = make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"])
    gwl = CmaxWorkload(fast_cfg(), policy=POLICY, mesh=grid)
    assert gwl.mesh is grid and gwl.device == torch.device("cpu")
    assert not gwl.supports_budgets and wl.supports_budgets
    with pytest.raises(ValueError, match="not supported with a mesh"):
        AsyncBatchedEstimationService(
            workload=gwl, qos_classes=[QosClass("eco", budget_uj=5.0)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CmaxWorkload(fast_cfg())


def test_cmax_cli_smoke(tmp_path, capsys):
    trace = tmp_path / "trace.jsonl"
    main(["cmax", "--device", "cpu", "--streams", "2", "--windows", "2",
          "--min-events", "300", "--max-events", "600", "--min-bucket",
          "256", "--max-batch", "2", "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "served 4/4 windows" in out and "engine cuda_batched" in out
    assert "rmse vs ground truth" in out and "latency p50=" in out
    assert len(read_jsonl(str(trace))) == 4 + 4 * 3   # spans + decisions
