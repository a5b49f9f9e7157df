"""The port's training step against the reference, on the CPU at each
architecture's `SMOKE` config (float32).

Parameters are initialized by the reference (`init_params`, seed 0) and
carried across with `convert.lm_params_from_reference`; batches come from
`data/lm.py::batches` (numpy-seeded). The loss and every gradient, mapped
back onto the reference's leaves (`models.leaves`), match the reference's
`jax.value_and_grad` of `loss_fn(forward(...))` within the reference's
gradient bar, rtol 5e-4 / atol 5e-5
(`tests/test_pipeline_parallel.py:54-55`); all ten architectures meet it.
Then: the remat policies and microbatching give the same gradients, one
whole AdamW train step matches the reference's, the meta-device stand-ins
have the reference's leaves for the ten published configs, and serving
after a train step records no graph.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS, get_config as r_full
from repro.configs import get_smoke_config as r_smoke
from repro.models import model as r_model
from repro.models import transformer as rt
from repro.train import optim as r_optim

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import _leaves, lm_params_from_reference
from repro_torch.data.lm import LMDataConfig, batches, chunk_policy
from repro_torch.data.lm import TokenChunk
from repro_torch.models import (SHAPES, abstract_opt_state, abstract_params,
                                input_specs, loss_and_grads, loss_fn,
                                make_serve_step, make_train_step)
from repro_torch.models import transformer as tt
from repro_torch.models.leaves import leaf_groups
from repro_torch.serving import LMDecodeWorkload
from repro_torch.train import optim

torch.set_num_threads(1)

G_RTOL, G_ATOL = 5e-4, 5e-5     # tests/test_pipeline_parallel.py:54-55
B, S = 4, 16
MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    init = jax.jit(functools.partial(rt.init_params, cfg=r_smoke(arch),
                                     max_len=MAX_LEN))
    return init(jax.random.key(0))


def port_model(arch):
    return lm_params_from_reference(jax.tree.map(np.asarray,
                                                 ref_params(arch)),
                                    get_smoke_config(arch), device="cpu")


def batch_np(cfg, seed=0):
    toks, labels = next(batches(LMDataConfig(cfg.vocab_size, S, B,
                                             seed=seed)))
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm" or cfg.is_enc_dec:
        out["cross_source"] = (np.random.default_rng(seed).normal(
            size=(B, cfg.cross_source_len, cfg.d_model)) * 0.1
        ).astype(np.float32)
    return out


def to_port(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def ref_loss_and_grads(arch, b):
    rcfg = r_smoke(arch)

    def loss(p):
        logits = rt.forward(p, rcfg, jnp.asarray(b["tokens"]),
                            cross_source=None if "cross_source" not in b
                            else jnp.asarray(b["cross_source"]))
        return r_model.loss_fn(logits, jnp.asarray(b["labels"]))
    l, g = jax.jit(jax.value_and_grad(loss))(ref_params(arch))
    return float(l), dict(_leaves(jax.tree.map(np.asarray, g), ""))


def on_reference_leaves(model, tree):
    """A {port name: tensor} tree as {reference leaf: array} in the
    reference's layout (stacked repeats, heads as an axis)."""
    groups = leaf_groups(model.cfg, {n: tuple(p.shape) for n, p in
                                     model.named_parameters()})
    out = {}
    for key, leaf in groups.items():
        parts = [tree[n].detach().float().numpy().reshape(leaf.slice_shape)
                 for n, _ in leaf.members]
        out[key] = np.stack(parts) if leaf.stacked else parts[0]
    return out


def ref_shapes(tree):
    """{dotted path: shape} of a reference tree (arrays or shape
    stand-ins)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(leaf.shape)
    return out


def assert_grads_close(got, ref, what, rtol=G_RTOL, atol=G_ATOL):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for key in ref:
        g, r = got[key], np.asarray(ref[key], np.float32)
        assert g.shape == r.shape, (what, key, g.shape, r.shape)
        np.testing.assert_allclose(
            g, r, rtol=rtol, atol=atol,
            err_msg=f"{what}: leaf {key}, largest |diff| "
                    f"{float(np.abs(g - r).max()):.3e}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_the_reference(arch):
    cfg = get_smoke_config(arch)
    b = batch_np(cfg)
    model = port_model(arch)
    loss, grads = loss_and_grads(model, to_port(b))
    ref_l, ref_g = ref_loss_and_grads(arch, b)
    np.testing.assert_allclose(float(loss), ref_l, rtol=G_RTOL, atol=G_ATOL)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    assert_grads_close(on_reference_leaves(model, grads), ref_g, arch)


def _block_calls(model):
    """Count each decoder layer's forward calls (a recomputed layer runs
    twice). A pre-hook: the recomputation stops once it has rebuilt what
    the backward needs, before the layer returns."""
    calls = [0] * len(model.layers)

    def hook(i):
        def count(*_):
            calls[i] += 1
        return count
    handles = [blk.register_forward_pre_hook(hook(i))
               for i, blk in enumerate(model.layers)]
    return calls, handles


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D matrix products (`aten.mm`, `aten.addmm`) that reach
    the dispatcher, forward, recompute and backward; a product that
    selective checkpointing replays from its saved output is not counted."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", "xlstm-1.3b"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_gradients(arch, policy):
    cfg = get_smoke_config(arch)
    model = port_model(arch)
    b = to_port(batch_np(cfg, seed=1))
    params = [p for _, p in model.named_parameters()]
    with _CountProducts() as plain_products:
        plain_loss = loss_fn(tt.forward(model, b["tokens"],
                                        remat_scan=False), b["labels"])
        plain = torch.autograd.grad(plain_loss, params, allow_unused=True,
                                    materialize_grads=True)
    calls, handles = _block_calls(model)
    try:
        with _CountProducts() as products:
            loss, grads = loss_and_grads(model, b, remat_policy=policy)
    finally:
        for h in handles:
            h.remove()
    plan = tt.DepthPlan(cfg)
    n_pre = len(plan.prefix)
    n_scan = plan.n_rep * len(plan.period_kinds)
    # the repeated periods run again in the backward; prefix and suffix not
    assert calls == [1] * n_pre + [2] * n_scan + \
        [1] * (len(calls) - n_pre - n_scan), calls
    # "full" recomputes the periods' weight products; "dots" keeps them
    if policy == "dots":
        assert products.n == plain_products.n, (products.n,
                                                plain_products.n)
    else:
        assert products.n > plain_products.n, (products.n, plain_products.n)
    np.testing.assert_allclose(float(loss), float(plain_loss.detach()),
                               rtol=G_RTOL, atol=G_ATOL)
    named = {n: g for (n, _), g in zip(model.named_parameters(), plain)}
    assert_grads_close(on_reference_leaves(model, grads),
                       on_reference_leaves(model, named), policy)
    with pytest.raises(ValueError, match="remat_policy"):
        loss_and_grads(model, b, remat_policy="everything")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny"])
def test_microbatch_matches_the_whole_batch(arch):
    cfg = get_smoke_config(arch)
    model = port_model(arch)
    b = to_port(batch_np(cfg, seed=2))
    loss1, g1 = loss_and_grads(model, b)
    loss2, g2 = loss_and_grads(model, b, microbatch=2)
    assert all(g.dtype == torch.float32 for g in g2.values())
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=G_RTOL,
                               atol=G_ATOL)
    assert_grads_close(on_reference_leaves(model, g2),
                       on_reference_leaves(model, g1), "microbatch 2")


def test_train_step_matches_the_reference_step():
    """One AdamW step of `make_train_step` (microbatch 2), both packages
    from the same parameters and batch: the loss and every updated
    parameter within the gradient bar."""
    arch = "llama3.2-1b"
    rcfg, cfg = r_smoke(arch), get_smoke_config(arch)
    b = batch_np(cfg, seed=3)
    ocfg = r_optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    rstep = jax.jit(r_model.make_train_step(rcfg, ocfg, microbatch=2))
    params = ref_params(arch)
    rparams, ropt, rmet = rstep(params, r_optim.adamw_init(ocfg, params),
                                {k: jnp.asarray(v) for k, v in b.items()})
    model = port_model(arch)
    pcfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    step = make_train_step(cfg, pcfg, microbatch=2)
    st, met = step(model, optim.adamw_init(pcfg, model), to_port(b))
    assert st.step == int(ropt.step) == 1
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               rtol=G_RTOL, atol=G_ATOL)
    got = on_reference_leaves(model, dict(model.named_parameters()))
    assert_grads_close(got, dict(_leaves(jax.tree.map(np.asarray, rparams),
                                         "")), "updated parameters")
    # the multi-device arguments: `mesh` is read only by EP, as in the
    # reference, and EP needs a mesh, so on one device they change nothing
    tokens = to_port(b)["tokens"]
    with torch.no_grad():
        plain = tt.forward(model, tokens)
        torch.testing.assert_close(tt.forward(model, tokens, mesh=object()),
                                   plain, rtol=0, atol=0)
        torch.testing.assert_close(tt.forward(model, tokens, use_ep=True),
                                   plain, rtol=0, atol=0)
    assert callable(make_train_step(cfg, use_ep=True))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_match_the_reference(arch):
    """`abstract_params` / `abstract_opt_state` of the published config,
    on the meta device: the reference's `eval_shape` leaves, one for one,
    by shape and size (kimi-k2-1t included, nothing allocated)."""
    cfg = get_config(arch)
    model = abstract_params(cfg)
    assert all(p.is_meta for p in model.parameters())
    ref_tree = r_model.abstract_params(r_full(arch))
    ref = ref_shapes(ref_tree)
    groups = leaf_groups(cfg, {n: tuple(p.shape) for n, p in
                               model.named_parameters()})
    assert {k: g.shape for k, g in groups.items()} == ref
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(v)) for v in ref.values())
    for name in ("adamw", "adafactor"):
        st = abstract_opt_state(model, name)
        rst = r_model.abstract_opt_state(ref_tree, name)
        for field in st._fields[1:]:
            got = {k: tuple(v.shape) for k, v in getattr(st, field).items()}
            assert got == ref_shapes(getattr(rst, field)), (arch, name, field)
            assert all(v.is_meta for v in getattr(st, field).values())


def test_input_specs_match_the_reference():
    for arch in ("llama3.2-1b", "whisper-tiny", "llama-3.2-vision-11b",
                 "recurrentgemma-9b"):
        cfg, rcfg = get_config(arch), r_full(arch)
        for shape in SHAPES.values():
            got = input_specs(cfg, shape, batch_override=2)
            want = r_model.input_specs(rcfg, r_model.SHAPES[shape.name],
                                       batch_override=2)
            assert set(got) == set(want)
            for k in want:
                if k == "cache":
                    tensors = [v for c in got[k]["layers"]
                               for v in c.values()
                               if isinstance(v, torch.Tensor)]
                    assert all(v.is_meta for v in tensors)
                    ref_n = sum(int(np.prod(v)) for p, v in
                                ref_shapes(want[k]).items()
                                if not p.endswith("idx"))
                    assert sum(v.numel() for v in tensors) == ref_n
                    continue
                assert got[k].is_meta
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[1] == \
                    np.dtype(want[k].dtype).name


def test_serving_after_a_train_step_records_no_graph():
    """The parameters are trainable; a train step, then a served chunk and
    a serve step: their outputs carry no graph, and the chunk's tokens are
    the batch-1 decode chain's."""
    cfg = get_smoke_config("llama3.2-1b")
    model = port_model("llama3.2-1b")
    assert all(p.requires_grad for p in model.parameters())
    pcfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1)
    make_train_step(cfg, pcfg)(model, optim.adamw_init(pcfg, model),
                               to_port(batch_np(cfg)))
    wl = LMDecodeWorkload(cfg, params=model, policy=chunk_policy(8, 64),
                          max_len=32, return_logits=True, device="cpu")
    chunk = TokenChunk(np.arange(5, 12, dtype=np.int32) % cfg.vocab_size)
    bucket = wl.bucket_of(chunk)
    data, st, _ = wl.make_batch([chunk], [wl.default_state()], bucket, 1)
    res = wl.executable(bucket, 1)(data, st)
    assert not res.tokens.requires_grad and not res.logits.requires_grad
    assert not any(v.requires_grad for c in res.state[0]["cache"]["layers"]
                   for v in c.values() if isinstance(v, torch.Tensor))
    cache = tt.init_cache(cfg, 1, 32, device="cpu")
    tok = torch.as_tensor(chunk.tokens[None, :1])
    logits, cache = tt.decode_step(model, tok, cache)
    assert not logits.requires_grad
    nxt, logits, cache = make_serve_step(cfg)(model, cache, tok)
    assert not nxt.requires_grad and not logits.requires_grad
    chain = tt.init_cache(cfg, 1, 32, device="cpu")
    want = [int(tt.decode_step(model, torch.as_tensor(chunk.tokens[None,
                                                                   t:t + 1]),
                               chain)[0][0, -1].argmax())
            for t in range(chunk.n)]
    assert res.tokens[0, :chunk.n].tolist() == want
