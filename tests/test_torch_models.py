"""The port's LM models against the reference, on the CPU at each
architecture's `SMOKE` config (float32).

Parameters are initialized by the reference (`init_params`) and carried
across with `convert.lm_params_from_reference`; token ids and stub
frontend embeddings are numpy-seeded. For every architecture: `forward`
logits (with a cross source for the VLM and whisper configs), an 8-token
`decode_step` chain, and the port's decode against its own forward — all
at the reference's bar for decode against forward
(`tests/test_arch_smoke.py::test_decode_matches_forward`: rtol 2e-2,
atol 2e-3), with the greedy tokens equal. Then unit cases: RoPE over half
the head, the local ring cache decoding past its window, query-chunked
attention, the MoE dispatch at the reference's property bars
(`tests/test_moe_properties.py`), each recurrent cell's step against its
sequence form, the clamped cache write past `max_len`, and the step
factories.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_smoke_config as r_smoke
from repro.models import layers as r_layers
from repro.models import model as r_model
from repro.models import moe as r_moe
from repro.models import recurrent as r_rec
from repro.models import transformer as rt

from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import (SHAPES, loss_fn, make_eval_step,
                                make_prefill_step, make_serve_step,
                                shape_applicable)
from repro_torch.models import layers, moe, recurrent
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference_only():
    """These are forward / decode parity checks: the parameters are
    trainable, so record no graph (outputs convert with `.numpy()`)."""
    with torch.no_grad():
        yield


RTOL, ATOL = 2e-2, 2e-3
T = 8
MAX_LEN = 64


def close(got, ref, what, rtol=RTOL, atol=ATOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    diff = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                               err_msg=f"{what}: largest |diff| {diff:.3e}")
    return diff


def same_argmax(got, ref, what):
    np.testing.assert_array_equal(np.asarray(got).argmax(-1),
                                  np.asarray(ref).argmax(-1),
                                  err_msg=f"{what}: greedy tokens differ")


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's parameters for an architecture's SMOKE config (seed
    0), shared by every test of the file: the parameter shapes do not
    depend on `local_window` or `attn_q_chunk`, which the unit cases
    vary."""
    init = jax.jit(functools.partial(rt.init_params, cfg=r_smoke(arch),
                                     max_len=MAX_LEN))
    return init(jax.random.key(0))


def ref_decode(rcfg, params, toks, max_len, cross=None):
    """The reference's decode chain over toks (B, n): (B, n, V) logits."""
    dec = jax.jit(functools.partial(rt.decode_step, cfg=rcfg))
    cache = rt.init_cache(rcfg, toks.shape[0], max_len)
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = dec(params, token=jnp.asarray(toks[:, t:t + 1]),
                            cache=cache, cross_source=cross)
        outs.append(np.asarray(logits[:, 0]))
    return np.stack(outs, axis=1)


def port_decode(model, toks, max_len, cross=None):
    cache = tt.init_cache(model.cfg, toks.shape[0], max_len, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = tt.decode_step(model, torch.as_tensor(toks[:, t:t + 1]),
                                       cache, cross_source=cross)
        assert logits.dtype == torch.float32
        outs.append(logits[:, 0].numpy())
    return np.stack(outs, axis=1), cache


def port_model(params, cfg):
    return lm_params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                    device="cpu")


class Case:
    """One architecture: converted parameters, seeded inputs, and the
    reference's forward logits and 8-token decode chain."""

    def __init__(self, arch):
        self.rcfg, self.cfg = r_smoke(arch), get_smoke_config(arch)
        self.params = ref_params(arch)
        self.model = port_model(self.params, self.cfg)
        rng = np.random.default_rng(sum(map(ord, arch)))
        cfg = self.cfg
        self.toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
        self.cross = None
        if cfg.family == "vlm" or cfg.is_enc_dec:
            self.cross = (rng.normal(size=(2, cfg.cross_source_len,
                                           cfg.d_model)) * 0.1
                          ).astype(np.float32)
        fwd = jax.jit(functools.partial(rt.forward, cfg=self.rcfg))
        self.ref_fwd = np.asarray(fwd(
            self.params, tokens=jnp.asarray(self.toks),
            cross_source=None if self.cross is None
            else jnp.asarray(self.cross)))
        # decode consumes the encoded memory (whisper) or the patches (vlm)
        rcross = None
        if cfg.family == "vlm":
            rcross = jnp.asarray(self.cross)
        elif cfg.is_enc_dec:
            rcross = rt.encode(self.params, self.rcfg,
                               jnp.asarray(self.cross))
        self.ref_dec = ref_decode(self.rcfg, self.params, self.toks, 16,
                                  rcross)

    def port_cross(self, encoded: bool, rows=slice(None)):
        if self.cross is None:
            return None
        x = torch.as_tensor(self.cross[rows])
        if encoded and self.cfg.is_enc_dec:
            return tt.encode(self.model, x)
        return x

    def port_decode(self, rows=slice(None)):
        got, cache = port_decode(self.model, self.toks[rows], 16,
                                 self.port_cross(encoded=True, rows=rows))
        assert tt.cache_position(cache) == (0 if self.cfg.family == "ssm"
                                            else T)
        return got


@pytest.fixture(scope="module", params=ARCH_IDS)
def case(request):
    return Case(request.param)


def test_forward_matches_the_reference(case):
    got = tt.forward(case.model, torch.as_tensor(case.toks),
                     cross_source=case.port_cross(encoded=False))
    assert got.dtype == torch.float32
    close(got.numpy(), case.ref_fwd, f"{case.cfg.name} forward")
    same_argmax(got.numpy(), case.ref_fwd, f"{case.cfg.name} forward")


def test_decode_chain_matches_the_reference(case):
    got = case.port_decode()
    close(got, case.ref_dec, f"{case.cfg.name} decode")
    same_argmax(got, case.ref_dec, f"{case.cfg.name} decode")


def test_decode_matches_forward(case):
    """Prefill-by-decode == forward in the port, as the reference's own
    `test_decode_matches_forward` holds it: one sequence of 8 tokens (a
    MoE forward over more tokens may drop pairs past its capacity, which
    one-token decode steps never do)."""
    one = slice(0, 1)
    full = tt.forward(case.model, torch.as_tensor(case.toks[one]),
                      cross_source=case.port_cross(False, one)).numpy()
    got = case.port_decode(one)
    close(got, full, f"{case.cfg.name} decode vs forward")
    same_argmax(got, full, f"{case.cfg.name} decode vs forward")


# ---------------------------------------------------------------------------
# unit cases
# ---------------------------------------------------------------------------


def test_rope_over_half_the_head_matches_the_reference():
    cfg = get_smoke_config("chatglm3-6b")
    assert cfg.rope_fraction == 0.5
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    pos = np.array([0, 3, 7, 100, 4095], np.int32)
    ref = np.asarray(r_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         r_smoke("chatglm3-6b")))
    got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), cfg)
    close(got.numpy(), ref, "rope", rtol=1e-5, atol=1e-5)
    rot = cfg.head_dim // 2
    # the unrotated half passes through untouched
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])
    assert layers.rope_freqs(cfg).shape == (rot // 2,)


def test_local_ring_cache_decodes_past_its_window():
    """recurrentgemma's local layers keep a ring of `local_window` keys
    once max_len exceeds the window: 14 tokens through a window of 4."""
    rcfg = dataclasses.replace(r_smoke("recurrentgemma-9b"), local_window=4)
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              local_window=4)
    params = ref_params("recurrentgemma-9b")
    model = port_model(params, cfg)
    n = 14
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, n)
                                             ).astype(np.int32)
    ref = ref_decode(rcfg, params, toks, 32)
    got, pc = port_decode(model, toks, 32)
    ring = [c for c in pc["layers"] if "pos" in c]
    assert ring and all(c["k"].shape[1] == 4 for c in ring)
    close(got, ref, "ring decode")
    same_argmax(got, ref, "ring decode")
    assert sorted(ring[0]["pos"].tolist()) == list(range(n - 4, n))
    full = tt.forward(model, torch.as_tensor(toks)).numpy()
    close(got, full, "ring decode vs forward (local mask)")


def test_query_chunked_attention_matches_the_reference():
    rcfg = dataclasses.replace(r_smoke("llama3.2-1b"), attn_q_chunk=4)
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              attn_q_chunk=4)
    params = ref_params("llama3.2-1b")
    model = port_model(params, cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)
                                             ).astype(np.int32)
    ref = np.asarray(jax.jit(functools.partial(rt.forward, cfg=rcfg))(
        params, tokens=jnp.asarray(toks)))
    got = tt.forward(model, torch.as_tensor(toks)).numpy()
    close(got, ref, "chunked forward")
    same_argmax(got, ref, "chunked forward")
    unchunked = port_model(params, get_smoke_config("llama3.2-1b"))
    close(got, tt.forward(unchunked, torch.as_tensor(toks)).numpy(),
          "chunked vs unchunked", rtol=1e-5, atol=1e-5)


def test_cache_write_past_max_len_clamps_as_the_reference():
    """dynamic_update_slice clamps a start beyond the buffer to its last
    row; the port mirrors the clamp (and the unclamped mask)."""
    rcfg, cfg = r_smoke("llama3.2-1b"), get_smoke_config("llama3.2-1b")
    params = ref_params("llama3.2-1b")
    model = port_model(params, cfg)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 7)
                                             ).astype(np.int32)
    got, pc = port_decode(model, toks, 4)
    close(got, ref_decode(rcfg, params, toks, 4), "clamped decode")
    assert tt.cache_position(pc) == 7


def _moe_cfg(E=8, k=2, d=16, f=8):
    kw = dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
              n_kv_heads=2, d_ff=f, vocab_size=64, block_pattern=("moe",),
              n_experts=E, experts_per_token=k, moe_d_ff=f, dtype="float32")
    return ModelConfig(**kw), r_moe.ModelConfig(**kw)


@pytest.mark.parametrize("T_,E,k,seed", [(4, 2, 1, 0), (17, 5, 2, 1),
                                         (64, 12, 3, 2), (33, 8, 3, 3),
                                         (9, 3, 3, 4)])
def test_pack_dispatch_invariants_and_reference(T_, E, k, seed):
    """Every kept pair occupies a unique slot in its expert's buffer, the
    buffer row equals the token vector, drops are only due to capacity —
    and buffer and slots equal the reference's."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T_, 8)).astype(np.float32)
    ids = rng.integers(0, E, size=(T_, k)).astype(np.int32)
    cap = int(rng.integers(1, T_ * k + 1))
    buf, pair_slot = moe._pack_dispatch(torch.as_tensor(x),
                                        torch.as_tensor(ids), E, cap)
    ps = pair_slot.numpy()
    kept = ps >= 0
    assert len(np.unique(ps[kept])) == kept.sum()
    flat_e = ids.reshape(-1)
    assert (ps[kept] // cap == flat_e[kept]).all()
    bufn = buf.numpy().reshape(E * cap, -1)
    tok = np.repeat(np.arange(T_), k)
    np.testing.assert_allclose(bufn[ps[kept]], x[tok[kept]], rtol=1e-6)
    for e in range(E):
        cnt = (flat_e == e).sum()
        assert (kept & (flat_e == e)).sum() == min(cnt, cap)
    rbuf, rps = r_moe._pack_dispatch(jnp.asarray(x), jnp.asarray(ids), E, cap)
    np.testing.assert_array_equal(ps, np.asarray(rps))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))


def test_gates_normalized_topk_ties_and_reference():
    rng = np.random.default_rng(0)
    router = rng.normal(size=(16, 8)).astype(np.float32)
    x = rng.normal(size=(12, 16)).astype(np.float32)
    gates, ids = moe._gate(torch.as_tensor(router), torch.as_tensor(x), 3)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    for row in ids.numpy():
        assert len(set(row.tolist())) == len(row)
    rg, rids = r_moe._gate(jnp.asarray(router), jnp.asarray(x), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    close(gates.numpy(), np.asarray(rg), "gates", rtol=1e-5, atol=1e-6)
    # equal probabilities go to the lower expert id first (lax.top_k)
    _, tie = moe._gate(torch.zeros(16, 8), torch.ones(2, 16), 3)
    assert tie.tolist() == [[0, 1, 2], [0, 1, 2]]


def test_combine_is_inverse_of_pack():
    cfg, _ = _moe_cfg()
    rng = np.random.default_rng(0)
    T_ = 16
    x = torch.as_tensor(rng.normal(size=(T_, cfg.d_model)).astype(np.float32))
    gates = torch.full((T_, 2), 0.5)
    ids = torch.as_tensor(rng.integers(0, cfg.n_experts, size=(T_, 2)))
    buf, pair_slot = moe._pack_dispatch(x, ids, cfg.n_experts, T_ * 2)
    out = moe._combine(buf, pair_slot, gates, T_)
    np.testing.assert_allclose(out.numpy(), x.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches_the_reference(shared):
    cfg, rcfg = _moe_cfg(E=6, k=2, d=16, f=8)
    cfg = dataclasses.replace(cfg, n_shared_experts=shared)
    rcfg = dataclasses.replace(rcfg, n_shared_experts=shared)
    p = jax.jit(functools.partial(r_moe.moe_init, cfg=rcfg))(
        jax.random.key(shared))
    m = moe.moe_init(cfg, torch.Generator().manual_seed(0))
    m.load_state_dict({
        name: torch.as_tensor(np.array(a)) for name, a in [
            ("router", p["router"]), ("wg", p["wg"]), ("wu", p["wu"]),
            ("wd", p["wd"])] + ([("shared.wg", p["shared"]["wg"]),
                                 ("shared.wu", p["shared"]["wu"]),
                                 ("shared.wd", p["shared"]["wd"])]
                                if shared else [])})
    x = np.random.default_rng(5).normal(size=(2, 7, 16)).astype(np.float32)
    for cap in (None, 8, 2):                 # 2 drops pairs
        ref = np.asarray(jax.jit(functools.partial(
            r_moe.moe_apply, cfg=rcfg, capacity=cap))(p, jnp.asarray(x)))
        got = m(torch.as_tensor(x), cap).numpy()
        close(got, ref, f"moe_apply capacity {cap}", rtol=1e-5, atol=1e-6)
    assert moe.capacity_of(cfg, 1) == r_moe.capacity_of(rcfg, 1) == 8
    assert moe.capacity_of(cfg, 1000) == r_moe.capacity_of(rcfg, 1000)


@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_recurrent_step_matches_sequence_and_reference(kind):
    arch = "recurrentgemma-9b" if kind == "rglru" else "xlstm-1.3b"
    cfg, rcfg = get_smoke_config(arch), r_smoke(arch)
    init = {"mlstm": r_rec.mlstm_init, "slstm": r_rec.slstm_init,
            "rglru": r_rec.rglru_init}[kind]
    apply = {"mlstm": r_rec.mlstm_apply, "slstm": r_rec.slstm_apply,
             "rglru": r_rec.rglru_apply}[kind]
    cls = {"mlstm": recurrent.MLSTM, "slstm": recurrent.SLSTM,
           "rglru": recurrent.RGLRU}[kind]
    init_cache = {"mlstm": recurrent.mlstm_init_cache,
                  "slstm": recurrent.slstm_init_cache,
                  "rglru": recurrent.rglru_init_cache}[kind]
    p = jax.jit(functools.partial(init, cfg=rcfg))(jax.random.key(7))
    cell = cls(cfg, torch.Generator().manual_seed(0))
    own = cell.state_dict()
    cell.load_state_dict({k: torch.as_tensor(np.array(p[k])).reshape(
        own[k].shape) for k in own})
    x = (np.random.default_rng(8).normal(size=(2, 9, cfg.d_model)) * 0.5
         ).astype(np.float32)
    ref = np.asarray(jax.jit(functools.partial(apply, cfg=rcfg))(
        p, jnp.asarray(x)))
    seq = cell(torch.as_tensor(x)).numpy()
    close(seq, ref, f"{kind} sequence form")
    cache = init_cache(cfg, 2)
    steps = []
    for t in range(x.shape[1]):
        out, cache = cell.step(torch.as_tensor(x[:, t:t + 1]), cache)
        steps.append(out.numpy()[:, 0])
    close(np.stack(steps, 1), seq, f"{kind} step vs sequence")


def test_step_factories_and_shapes_match_the_reference():
    rcfg, cfg = r_smoke("deepseek-moe-16b"), get_smoke_config(
        "deepseek-moe-16b")
    params = ref_params("deepseek-moe-16b")
    model = port_model(params, cfg)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    r_ev = jax.jit(r_model.make_eval_step(rcfg))(params, rb)
    p_ev = make_eval_step(cfg)(model, pb)
    close(p_ev["loss"].numpy(), np.asarray(r_ev["loss"]), "eval loss",
          rtol=1e-5, atol=1e-5)
    close(p_ev["logits_mean"].numpy(), np.asarray(r_ev["logits_mean"]),
          "logits mean", rtol=1e-4, atol=1e-6)
    close(make_prefill_step(cfg)(model, pb).numpy(),
          np.asarray(jax.jit(r_model.make_prefill_step(rcfg))(params, rb)),
          "prefill")
    logits = rng.normal(size=(2, 3, 11)).astype(np.float32)
    lab = rng.integers(0, 11, (2, 3)).astype(np.int32)
    close(loss_fn(torch.as_tensor(logits), torch.as_tensor(lab)).numpy(),
          np.asarray(r_model.loss_fn(jnp.asarray(logits), jnp.asarray(lab))),
          "loss_fn", rtol=1e-6, atol=1e-6)
    rserve = jax.jit(r_model.make_serve_step(rcfg))
    pserve = make_serve_step(cfg)
    rc, pc = rt.init_cache(rcfg, 2, 8), tt.init_cache(cfg, 2, 8, "cpu")
    rtok, ptok = jnp.asarray(toks[:, :1]), torch.as_tensor(toks[:, :1])
    for _ in range(3):
        rtok, rl, rc = rserve(params, rc, rtok)
        ptok, pl, pc = pserve(model, pc, ptok)
        assert ptok.dtype == torch.int32 and ptok.shape == (2, 1)
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(rtok))
        close(pl.numpy(), np.asarray(rl), "serve step logits")
    with pytest.raises(ValueError, match="step built for"):
        make_serve_step(get_smoke_config("llama3.2-1b"))(model, pc, ptok)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            r_model.SHAPES[name])
        for arch in ARCH_IDS:
            assert shape_applicable(get_smoke_config(arch), shape) == \
                r_model.shape_applicable(r_smoke(arch), r_model.SHAPES[name])
