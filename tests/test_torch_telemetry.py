"""The port's telemetry layer against the JAX package's: the same calls on a
`FakeClock` give the same Prometheus text, the same JSONL trace records and
the same human summary, so one trace reader serves both packages."""
import json

import pytest

import repro.telemetry as R
from repro.launch.serve import FakeClock as RClock

import repro_torch.telemetry as T
from repro_torch.launch.serve import FakeClock as TClock


def _drive(tel_mod, clock):
    """One scripted telemetry run: labeled and unlabeled families,
    histogram observations on and between bounds, spans through the ok,
    shed and refused paths, budgeted and unbudgeted decisions."""
    tel = tel_mod.Telemetry(spans=True, decisions=True)
    tel.bind_clock(clock)
    reg = tel.registry
    reg.counter("repro_serving_windows_total", "served").inc(3)
    shed = reg.counter("repro_serving_shed_total", "dropped",
                       labels=("reason",))
    shed.labels(reason="deadline").inc(2)
    shed.labels(reason="budget").inc()
    reg.gauge("repro_serving_queue_depth", "queued").set(7)
    reg.counter("repro_serving_budget_spent_uj_total").inc(12.5)
    h = reg.histogram("repro_serving_execute_seconds", "dispatch->harvest")
    for v in (0.0005, 0.003, 0.025, 0.7, 42.0):
        h.observe(v)
    reg.histogram("repro_test_seconds", buckets=(0.1, 1.0),
                  labels=("qos",)).labels(qos="gold").observe(0.1)
    tr = tel.tracer
    for sid, seq in (("a", 0), ("b", 0)):
        tr.start(sid, seq, "standard", 512)
        clock.advance(0.25)
    tr.mark("a", 0, "admit")
    tr.mark("b", 0, "admit")
    clock.advance(0.125)
    tr.mark("a", 0, "dispatch", batch_b=2, compile=True)
    tr.mark("b", 0, "dispatch", batch_b=2, compile=False)
    clock.advance(1.5)
    tr.finish("b", 0, "harvest", "ok", iters=(2, 3))
    tr.finish("a", 0, "harvest", "ok", iters=(4, 1))
    tr.start("a", 1, "gold", 1024)
    clock.advance(2.0)
    tr.finish("a", 1, "shed", "shed")
    tr.start("c", 0, "hard", 256, t=clock.now())
    tr.finish("c", 0, "shed", "refused", t=clock.now())
    dec = tel.decisions
    dec.record("a", 0, 0, 4, None, 4, 0.031, "max")
    dec.record("a", 0, 1, 1, 1, 4, 0.002, "cap")
    dec.record("b", 0, 0, 0, None, 4, None, "skip")
    dec.record("b", 0, 1, 3, 8, 4, -0.5, "run")
    return tel


def test_same_calls_give_the_same_text_records_and_summary(tmp_path):
    r = _drive(R, RClock(10.0))
    t = _drive(T, TClock(10.0))
    assert t.registry.to_prometheus() == r.registry.to_prometheus()
    assert t.registry.snapshot() == r.registry.snapshot()
    assert t.trace_records() == r.trace_records()
    assert t.summary() == r.summary()
    rp, tp = tmp_path / "r.jsonl", tmp_path / "t.jsonl"
    assert t.write_trace(str(tp)) == r.write_trace(str(rp))
    assert tp.read_bytes() == rp.read_bytes()
    assert T.read_jsonl(str(tp)) == R.read_jsonl(str(rp))
    rm, tm = tmp_path / "r.prom", tmp_path / "t.prom"
    r.write_metrics(str(rm))
    t.write_metrics(str(tm))
    assert tm.read_bytes() == rm.read_bytes()
    assert t.decisions.verdict_counts() == r.decisions.verdict_counts()
    assert t.decisions.iters_by_request() == r.decisions.iters_by_request()
    for rs, ts in zip(r.tracer.spans, t.tracer.spans):
        assert ts.phases() == rs.phases() and ts.latency_s == rs.latency_s


def test_schema_constants_and_errors_match_reference():
    assert T.SPAN_FIELDS == R.SPAN_FIELDS
    assert T.SPAN_EVENTS == R.SPAN_EVENTS
    assert T.DECISION_FIELDS == R.DECISION_FIELDS
    assert T.LATENCY_BUCKETS_S == R.LATENCY_BUCKETS_S
    assert sorted(T.__all__) == sorted(R.__all__)
    for mod in (R, T):
        reg = mod.MetricsRegistry()
        reg.counter("repro_x_total")
        with pytest.raises(ValueError):
            reg.gauge("repro_x_total")
        with pytest.raises(ValueError):
            reg.counter("bad name!")
        with pytest.raises(ValueError):
            mod.Histogram(bounds=(1.0, 1.0))
    hr, ht = R.Histogram((1.0, 2.0, 4.0)), T.Histogram((1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 3.9, 9.0):
        hr.observe(v)
        ht.observe(v)
    assert [ht.quantile(q) for q in (0.0, 0.3, 0.5, 0.99, 1.0)] == \
        [hr.quantile(q) for q in (0.0, 0.3, 0.5, 0.99, 1.0)]
    null = T.Telemetry()
    assert not null.enabled and null.trace_records() == []
    assert json.dumps(null.registry.snapshot()) == "{}"


# ===========================================================================
# the port's step spans (the reference has none)
# ===========================================================================


def _walk(tracer):
    """A scripted batch under a tracer's scope: two stages, a failing
    step inside the second, then a step outside any scope."""
    from repro_torch.telemetry import step

    def batch_fn(x):
        for si in range(2):
            with step("stage", stage=si):
                with step("sort"):
                    pass
                with step("pass"):
                    with step("engine"):
                        with step("megakernel"):
                            pass
        with pytest.raises(ValueError):
            with step("select"):
                raise ValueError("raised inside a step")
        return x + 1

    attrs = {"windows": [["a", 0]], "n_real": 1}
    fn = tracer.batch(batch_fn, 7, attrs, lambda out: out)
    with tracer.step("make_batch", 7):
        pass
    assert fn(1) == 2
    attrs["t_dispatch"] = 1.5             # added after the batch ran
    return fn


def test_step_spans_nest_under_the_batch_scope():
    from repro_torch.telemetry import STEP_SPANS, step
    tr = T.Tracer()
    _walk(tr)
    by_id = {s.id: s for s in tr.steps}
    assert len(by_id) == len(tr.steps) == 13
    assert all(s.name in STEP_SPANS for s in tr.steps)
    assert all(s.batch == 7 for s in tr.steps)
    roots = [s for s in tr.steps if s.parent is None]
    assert sorted(s.name for s in roots) == ["batch", "make_batch"]
    batch = next(s for s in roots if s.name == "batch")
    assert batch.attrs == {"windows": [["a", 0]], "n_real": 1,
                           "t_dispatch": 1.5}
    kids = lambda sp: [s for s in tr.steps if s.parent == sp.id]
    stages = [s for s in kids(batch) if s.name == "stage"]
    assert [s.attrs["stage"] for s in stages] == [0, 1]
    assert [s.name for s in kids(batch)] == ["stage", "stage", "select"]
    for st in stages:
        assert sorted(s.name for s in kids(st)) == ["pass", "sort"]
    for s in tr.steps:                    # every child inside its parent
        assert s.t0_ns <= s.t1_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    # the scope ends with the batch: outside it a step is the shared no-op
    # and records nothing
    n = len(tr.steps)
    with step("pass") as sp:
        assert sp is None
    assert step("engine") is step("sort") and len(tr.steps) == n
    assert [s.id for s in tr.drain_steps()] == [s.id for s in by_id.values()]
    assert tr.steps == []


def test_null_tracer_runs_the_batch_function_itself():
    null = T.NullTracer()
    fn = lambda x: x
    assert null.batch(fn, 0, {}, None) is fn
    with null.step("make_batch", 0) as sp:
        assert sp is None
    assert null.steps == () and null.drain_steps() == ()


def test_step_records_export_and_summary(tmp_path):
    from repro_torch.telemetry import STEP_FIELDS, step_totals
    tel = T.Telemetry(spans=True, decisions=True)
    tel.bind_clock(TClock(2.0))
    tel.tracer.start("a", 0, "standard", 512)
    tel.tracer.finish("a", 0, "harvest", "ok", iters=(1,))
    _walk(tel.tracer)
    assert {s.t0_ns for s in tel.tracer.steps} == {2_000_000_000}
    recs = tel.trace_records()
    assert [r["type"] for r in recs] == ["span"] + ["step"] * 13
    assert tuple(recs[0]) == T.SPAN_FIELDS
    assert all(tuple(r) == STEP_FIELDS for r in recs[1:])
    path = tmp_path / "t.jsonl"
    assert tel.write_trace(str(path)) == 14
    back = T.read_jsonl(str(path))
    assert set(back[0]) == set(T.SPAN_FIELDS) and back[1:] == recs[1:]
    totals = step_totals(back[1:])
    assert totals == step_totals(tel.tracer.steps)
    assert totals["stage"]["count"] == 2 and totals["pass"]["count"] == 2
    batch = totals["batch"]["total_s"]
    under_batch = ("stage", "sort", "pass", "engine", "megakernel",
                   "select")
    assert sum(totals[n]["own_s"] for n in under_batch) \
        + totals["batch"]["own_s"] == pytest.approx(batch, abs=1e-12)
    text = tel.summary()
    assert "step spans: 13 (1 batches, 2 lockstep passes)" in text
    assert "    step megakernel: count=2 " in text
