"""The port's LM decode serving (`LMDecodeWorkload` through the async and
synchronous services) on the CPU.

  * the conformance contracts of `tests/test_workload_conformance.py` for
    the LM harness (llama3.2-1b SMOKE, chunk classes 8..64, max_len 64):
    FIFO with carried caches under any completion order, bitwise slot
    independence at a fixed batch size, deadline shedding and its chain
    skip, the shed placeholder, budgeted classes refused, executable-cache
    accounting and the span schema — every response held bitwise to the
    workload's own sequential batch-1 chain;
  * the properties of `tests/test_lm_properties.py`: padding never
    influences a real position (tokens, logits and the carried cache), and
    the async service equals a plain per-stream `decode_step` loop;
  * the port's service against the JAX `LMDecodeWorkload` service on
    converted parameters: the same tokens, statuses and classes;
  * `python -m repro_torch.launch.serve lm --device cpu`.

The CPU path is bitwise reproducible only single-threaded, so the file
sets `torch.set_num_threads(1)`.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.data import lm as r_lm
from repro.launch import serve as r_serve
from repro.serving import LMDecodeWorkload as RLMDecodeWorkload

import repro_torch
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data import lm as lm_data
from repro_torch.launch.serve import (AsyncBatchedEstimationService,
                                      AsyncDispatchExecutor,
                                      BatchedEstimationService, FakeClock,
                                      InlineExecutor, ManualExecutor,
                                      QosClass, main)
from repro_torch.models import transformer as tt
from repro_torch.serving import LMChunkResult, LMDecodeWorkload
from repro_torch.telemetry import SPAN_FIELDS, Telemetry, read_jsonl

torch.set_num_threads(1)

ARCH = "llama3.2-1b"
POLICY = lm_data.chunk_policy(min_bucket=8, max_bucket=64)


@pytest.fixture(scope="module")
def wl():
    """One workload for the module: the model is built once (seed 0 of a
    CPU generator); services are per test."""
    return LMDecodeWorkload(get_smoke_config(ARCH), policy=POLICY,
                            max_len=64, return_logits=True, device="cpu")


def streams(cfg, n_streams=2, n_payloads=3, fixed=False, seed=0):
    """The LM harness's streams: token_streams of 5..14 tokens, or (fixed)
    chunks of 8 tokens each, so every chunk shares one class."""
    if fixed:
        out = {}
        for s in range(n_streams):
            rng = np.random.default_rng(7 + s)
            out[f"lm{s}"] = [lm_data.TokenChunk(rng.integers(
                0, cfg.vocab_size, size=8).astype(np.int32))
                for _ in range(n_payloads)]
        return out
    dcfg = lm_data.LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=1, seed=seed)
    return lm_data.token_streams(dcfg, n_streams, n_payloads, 5, 14,
                                 seed=seed)


def workload_chain(wl, payloads):
    """Sequential batch-1 chain through the workload's own machinery — the
    ground truth every service schedule must reproduce bitwise."""
    state = wl.default_state()
    outs = []
    for p in payloads:
        b = wl.bucket_of(p)
        data, sb, _ = wl.make_batch([p], [state], b, 1)
        res = wl.executable(b, 1, donate=False)(data, sb)
        out, state, _, _ = wl.harvest(res, False)(0)
        outs.append(np.asarray(out))
    return outs


def make_svc(wl, **kw):
    kw.setdefault("clock", FakeClock())
    return AsyncBatchedEstimationService(workload=wl, **kw)


def submit_all(svc, ss):
    for sid, ps in ss.items():
        for p in ps:
            svc.submit(sid, p)


def assert_chain(wl, ss, rs):
    by = {(r.stream_id, r.seq): r for r in rs}
    for sid, ps in ss.items():
        ref = workload_chain(wl, ps)
        for k in range(len(ps)):
            got = np.asarray(by[(sid, k)].omega)
            assert got.dtype == np.int32 and got.shape == (ps[k].n,)
            np.testing.assert_array_equal(got, ref[k])


# ---------------------------------------------------------------------------
# the conformance contracts
# ---------------------------------------------------------------------------


def test_fifo_carried_state_any_completion_order(wl):
    ss = streams(wl.cfg, 2, 3)
    ex = ManualExecutor()
    svc = make_svc(wl, executor=ex, max_batch=1, max_in_flight=2)
    submit_all(svc, ss)
    rs, flip = [], False
    while svc.pending() or svc.in_flight():
        rs.extend(svc.poll())
        pending = ex.in_flight()
        if pending:                        # alternate which batch finishes
            ex.release(pending[-1] if flip else pending[0])
            flip = not flip
    rs.extend(svc.poll())
    assert len(rs) == 6 and all(r.status == "ok" for r in rs)
    assert_chain(wl, ss, rs)
    for sid in ss:
        seqs = [r.seq for r in rs if r.stream_id == sid]
        assert seqs == sorted(seqs)


@pytest.mark.parametrize("sync", [False, True])
def test_slot_independence_at_fixed_batch(wl, sync):
    """Four same-class streams in one dispatch give, per slot, exactly the
    bits of the batch-1 chain — async and sync."""
    ss = streams(wl.cfg, 4, 2, fixed=True)
    svc = (BatchedEstimationService(workload=wl, max_batch=4) if sync else
           make_svc(wl, executor=InlineExecutor(), max_batch=4))
    submit_all(svc, ss)
    rs = svc.drain()
    assert all(r.batch_b == 4 for r in rs)     # actually batched together
    assert_chain(wl, ss, rs)


def test_fill_slots_take_the_leaders_results(wl):
    """Three chunks in a class of 4: the fill slot repeats the leader's
    tokens, logits and state; real rows hold -1 and zero logits past their
    length."""
    ss = streams(wl.cfg, 3, 1)
    chunks = [ps[0] for ps in ss.values()]
    b = max(wl.bucket_of(c) for c in chunks)
    data, st, n_fill = wl.make_batch(chunks, [wl.default_state()] * 3, b, 4)
    assert n_fill == 1 and len(st) == 4
    res = wl.executable(b, 4)(data, st)
    assert isinstance(res, LMChunkResult)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (4, b)
    assert torch.equal(res.tokens[3], res.tokens[0])
    assert torch.equal(res.logits[3], res.logits[0])
    assert res.state[3] is res.state[0]
    for i, c in enumerate(chunks):
        assert (res.tokens[i, c.n:] == -1).all()
        assert (res.logits[i, c.n:] == 0).all()
        assert tt.cache_position(res.state[i]["cache"]) == c.n
    # the state read by the batch is left as it was
    assert tt.cache_position(st[0]["cache"]) == 0


def test_deadline_shed_semantics_and_chain_skip(wl):
    (_, ps), = streams(wl.cfg, 1, 3).items()
    clock = FakeClock()
    svc = make_svc(wl, clock=clock, executor=InlineExecutor(), max_batch=1)
    svc.submit("a", ps[0])
    rs = svc.drain()
    svc.submit("a", ps[1], deadline=clock.now() - 1.0)     # already late
    svc.submit("a", ps[2])
    rs += svc.drain()
    by = {r.seq: r for r in rs}
    assert by[1].status == "shed"
    assert by[1].batch_b == 0 and by[1].iters == ()
    assert svc.stats["shed"] == 1
    ref = workload_chain(wl, [ps[0], ps[2]])               # skips ps[1]
    np.testing.assert_array_equal(np.asarray(by[0].omega), ref[0])
    np.testing.assert_array_equal(np.asarray(by[2].omega), ref[1])


def test_shed_before_first_completion_uses_default_placeholder(wl):
    clock = FakeClock()
    svc = make_svc(wl, clock=clock, executor=InlineExecutor())
    (_, (p, *_)), = streams(wl.cfg, 1, 1).items()
    svc.submit("fresh", p, deadline=clock.now() - 1.0)
    (r,) = svc.drain()
    assert r.status == "shed"
    np.testing.assert_array_equal(np.asarray(r.omega),
                                  np.zeros((0,), np.int32))


def test_budgeted_classes_are_refused(wl):
    with pytest.raises(ValueError, match="budget"):
        make_svc(wl, qos_classes=[QosClass("tight", budget_uj=1e-3)])
    with pytest.raises(NotImplementedError, match="budgeted"):
        wl.executable(8, 1, budgeted=True)


def test_executable_cache_hit_accounting(wl):
    ss = streams(wl.cfg, 3, 2)
    svc = make_svc(wl, executor=InlineExecutor(), max_batch=4)
    submit_all(svc, ss)
    svc.drain()
    first = svc.stats["compiles"]
    assert first == len(svc._cache) > 0
    batches0 = svc.stats["batches"]
    submit_all(svc, ss)                 # same shapes -> no new classes
    svc.drain()
    assert svc.stats["compiles"] == first
    assert svc.stats["batches"] > batches0
    assert 0.0 <= svc.padded_slot_frac < 1.0


def test_span_schema_conformance(wl):
    ss = streams(wl.cfg, 2, 2)
    tel = Telemetry(spans=True)
    svc = make_svc(wl, executor=InlineExecutor(), max_batch=2, telemetry=tel)
    submit_all(svc, ss)
    rs = svc.drain()
    spans = tel.tracer.spans
    assert len(spans) == len(rs) == 4
    by = {(r.stream_id, r.seq): r for r in rs}
    for s in spans:
        d = s.to_dict()
        assert tuple(d) == SPAN_FIELDS
        assert [e for e, _ in s.events] == ["submit", "admit", "dispatch",
                                            "harvest"]
        r = by[(s.stream_id, s.seq)]
        assert d["status"] == "ok" and d["qos"] == "standard"
        assert d["iters"] == list(r.iters) == [r.omega.shape[0]]
        assert d["bucket_n"] == r.bucket_n and d["batch_b"] == r.batch_b
        assert isinstance(d["compile"], bool)
        assert d["latency_s"] == r.latency
        assert sum(d["phases"].values()) == pytest.approx(r.latency,
                                                          abs=1e-12)


# ---------------------------------------------------------------------------
# properties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 3), (2, 5), (3, 7), (4, 8),
                                    (5, 2)])
def test_padding_never_influences_real_positions(wl, seed, n):
    """The same chunk in its tight class and in a 4x larger one: equal
    tokens and logits bits on every real position, and the carried cache
    advanced by exactly n steps with equal bits either way."""
    rng = np.random.default_rng(seed)
    c = lm_data.TokenChunk(rng.integers(0, wl.cfg.vocab_size, n
                                        ).astype(np.int32))
    outs = {}
    for bucket in (8, 32):
        data, sb, _ = wl.make_batch([c], [wl.default_state()], bucket, 1)
        res = wl.executable(bucket, 1, donate=False)(data, sb)
        outs[bucket] = (res.tokens[0, :n], res.logits[0, :n],
                        res.state[0]["cache"])
    assert torch.equal(outs[8][0], outs[32][0])
    assert torch.equal(outs[8][1], outs[32][1])
    for a, b in zip(outs[8][2]["layers"], outs[32][2]["layers"]):
        assert a["idx"] == b["idx"] == n
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_async_service_matches_unbatched_decode_loop(wl):
    """The async service with the threaded dispatch executor (bucketed
    batches, continuous refill) reproduces a plain per-stream loop over
    `decode_step` — no batching, no padding — including the carried cache
    across each stream's chunks."""
    ss = streams(wl.cfg, 3, 3, seed=3)
    ex = AsyncDispatchExecutor()
    svc = AsyncBatchedEstimationService(workload=wl, max_batch=4,
                                        max_in_flight=2, executor=ex)
    submit_all(svc, ss)
    try:
        rs = svc.drain()
    finally:
        ex.close()
    assert len(rs) == 9 and all(r.status == "ok" for r in rs)
    by = {(r.stream_id, r.seq): np.asarray(r.omega) for r in rs}
    for sid, chunks in ss.items():
        cache = tt.init_cache(wl.cfg, 1, wl.max_len, device="cpu")
        for k, c in enumerate(chunks):
            preds = []
            for t in range(c.n):
                logits, cache = tt.decode_step(
                    wl.params, torch.as_tensor(c.tokens[t:t + 1])[None],
                    cache)
                preds.append(int(torch.argmax(logits[0, -1])))
            np.testing.assert_array_equal(
                by[(sid, k)], np.asarray(preds, np.int32),
                err_msg=f"stream {sid} chunk {k} diverged from the "
                        f"unbatched decode loop")


def test_port_service_gives_the_jax_services_tokens():
    """The same streams through the JAX LM service and the port's, on the
    reference's parameters carried across: equal tokens, statuses,
    sequence numbers, classes and stats."""
    rcfg, cfg = r_smoke(ARCH), get_smoke_config(ARCH)
    rwl = RLMDecodeWorkload(rcfg, policy=r_lm.chunk_policy(8, 64),
                            max_len=64)
    model = lm_params_from_reference(jax.tree.map(np.asarray, rwl.params),
                                     cfg, device="cpu")
    pwl = LMDecodeWorkload(cfg, params=model, policy=POLICY, max_len=64,
                           device="cpu")
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=1,
                seed=5)
    rss = r_lm.token_streams(r_lm.LMDataConfig(**dcfg), 3, 3, 5, 14, seed=5)
    pss = lm_data.token_streams(lm_data.LMDataConfig(**dcfg), 3, 3, 5, 14,
                                seed=5)
    rsvc = r_serve.AsyncBatchedEstimationService(
        workload=rwl, max_batch=4, clock=r_serve.FakeClock(),
        executor=r_serve.InlineExecutor())
    psvc = make_svc(pwl, executor=InlineExecutor(), max_batch=4)
    for svc, ss in ((rsvc, rss), (psvc, pss)):
        submit_all(svc, ss)
    rr, pr = rsvc.drain(), psvc.drain()
    assert len(rr) == len(pr) == 9
    for a, b in zip(pr, rr):
        assert (a.stream_id, a.seq, a.status, a.bucket_n, a.batch_b,
                a.iters) == (b.stream_id, b.seq, b.status, b.bucket_n,
                             b.batch_b, b.iters)
        np.testing.assert_array_equal(np.asarray(a.omega),
                                      np.asarray(b.omega))
    for key in ("batches", "compiles", "windows", "event_slots",
                "raw_events", "fill_slots"):
        assert psvc.stats[key] == rsvc.stats[key], key


def test_workload_device_checks(wl):
    """The workload serves on the card unless told otherwise (and raises
    without one), and refuses a model that lives elsewhere."""
    meta = tt.init_params(wl.cfg, torch.Generator().manual_seed(0),
                          device="meta")
    with pytest.raises(ValueError, match="serves on cpu"):
        LMDecodeWorkload(wl.cfg, params=meta, device="cpu")
    if torch.cuda.is_available():
        return                # the default device resolves to the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMDecodeWorkload(wl.cfg)


def test_lm_cli_smoke(tmp_path, capsys):
    trace = tmp_path / "trace.jsonl"
    main(["lm", "--arch", "xlstm-1.3b", "--device", "cpu", "--streams", "2",
          "--chunks", "2", "--max-tokens", "20", "--sync",
          "--trace-out", str(trace)])
    out = capsys.readouterr().out
    assert "xlstm-1.3b: served 4/4 chunks" in out and "sync FIFO" in out
    assert "on cpu" in out and "greedy continuation ids" in out
    recs = read_jsonl(str(trace))
    assert [r["type"] for r in recs].count("span") == 4   # one span each
    steps = [r for r in recs if r["type"] == "step"]      # one of each a
    names = [r["name"] for r in steps]                    # batch, no stage
    assert len(recs) == 4 + len(steps) and names
    assert sorted(set(names)) == ["batch", "harvest", "make_batch"]
    assert names.count("batch") == names.count("harvest") \
        == names.count("make_batch")
    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
         ARCH, "--device", "cpu", "--streams", "2", "--chunks", "2"],
        env={**os.environ, "PYTHONPATH": src}, capture_output=True,
        text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "llama3.2-1b: served 4/4 chunks" in run.stdout
    assert "async continuous batching" in run.stdout
