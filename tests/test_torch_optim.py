"""The port's optimizers, gradient compression, checkpointing and
fault-tolerance primitives against the reference, on the CPU.

Both packages get the same parameters, gradients and state: the
reference's tree, carried into the port by `convert.lm_params_from_reference`
and `convert.opt_state_from_reference`. AdamW, Adafactor and int8
`compress_grads` then give updates and states within rtol 2e-5 / atol 2e-5
(`tests/test_pipeline_parallel.py:44-45`). The configs hold scan-stacked
leaves, 3-D head weights, stacked norm vectors (whose Adafactor moments
reach across the repeats) and MoE expert stacks, so the per-leaf
reductions run over the reference's leaf geometry. Then the port's
versions of `tests/test_checkpoint_ft.py`, and a directory written by the
port read by the reference's checkpoint scan.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.models import transformer as rt
from repro.train import checkpoint as r_ckpt
from repro.train import optim as r_optim

from repro_torch.configs import get_smoke_config
from repro_torch.convert import (_leaves, lm_params_from_reference,
                                 opt_state_from_reference)
from repro_torch.models.leaves import leaf_groups
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim as optim_lib
from repro_torch.train.ft import FaultInjector, RetryPolicy, StragglerDetector

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-5      # tests/test_pipeline_parallel.py:44-45
ARCHS = ["llama3.2-1b", "xlstm-1.3b", "deepseek-moe-16b"]


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    init = jax.jit(functools.partial(rt.init_params, cfg=r_smoke(arch),
                                     max_len=64))
    return jax.tree.map(np.asarray, init(jax.random.key(0)))


def ref_grads(arch, seed):
    """Seeded gradients shaped like the reference's parameters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.normal(size=p.shape) * 0.01
                                   ).astype(np.float32), ref_params(arch))


def port_tree(tree_np, arch):
    """A reference tree of numpy arrays as {port name: tensor}."""
    m = lm_params_from_reference(tree_np, get_smoke_config(arch),
                                 device="cpu")
    return {n: p.detach() for n, p in m.named_parameters()}


def flat(tree):
    return dict(_leaves(jax.tree.map(np.asarray, tree), ""))


def on_reference_leaves(model, tree):
    groups = leaf_groups(model.cfg, {n: tuple(p.shape) for n, p in
                                     model.named_parameters()})
    out = {}
    for key, leaf in groups.items():
        parts = [tree[n].detach().float().numpy().reshape(leaf.slice_shape)
                 for n, _ in leaf.members]
        out[key] = np.stack(parts) if leaf.stacked else parts[0]
    return out


def assert_trees_close(got, want, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        g = np.asarray(got[k], np.float32)
        w = np.asarray(want[k], np.float32)
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL,
            err_msg=f"{what} {k}: largest |diff| "
                    f"{float(np.abs(g - w).max()):.3e}")


def state_np(state):
    return {k: {n: t.numpy() for n, t in v.items()}
            for k, v in state._asdict().items() if k != "step"}


OPTS = {
    "adamw": (r_optim.AdamWConfig(lr=1e-2, warmup_steps=3),
              optim_lib.AdamWConfig(lr=1e-2, warmup_steps=3),
              "adamw_init", "adamw_update"),
    "adafactor": (r_optim.AdafactorConfig(lr=1e-2, weight_decay=0.1),
                  optim_lib.AdafactorConfig(lr=1e-2, weight_decay=0.1),
                  "adafactor_init", "adafactor_update"),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_the_reference(arch, name):
    """Reference step 1 from zeros; its parameters and state carried into
    the port; step 2 in both from the same gradients."""
    rcfg_o, pcfg_o, init, update = OPTS[name]
    cfg = get_smoke_config(arch)
    params = ref_params(arch)
    g1, g2 = ref_grads(arch, 1), ref_grads(arch, 2)
    rupd = jax.jit(functools.partial(getattr(r_optim, update), rcfg_o))
    p1, s1 = rupd(g1, getattr(r_optim, init)(rcfg_o, params), params)
    p2, s2 = rupd(g2, s1, p1)

    model = lm_params_from_reference(jax.tree.map(np.asarray, p1), cfg,
                                     device="cpu")
    state = opt_state_from_reference(jax.tree.map(np.asarray, s1), cfg,
                                     optimizer=name, device="cpu")
    assert state.step == 1
    zero = getattr(optim_lib, init)(pcfg_o, model)
    for field in zero._fields[1:]:          # the same leaves and shapes
        assert {k: v.shape for k, v in getattr(zero, field).items()} == \
            {k: v.shape for k, v in getattr(state, field).items()}
    state = getattr(optim_lib, update)(pcfg_o, port_tree(
        jax.tree.map(np.asarray, g2), arch), state, model)
    assert state.step == int(s2.step) == 2
    assert_trees_close(on_reference_leaves(model,
                                           dict(model.named_parameters())),
                       flat(p2), f"{name} parameters")
    want = {k: flat(v) for k, v in s2._asdict().items() if k != "step"}
    got = state_np(state)
    for k in want:
        assert_trees_close(got[k], want[k], f"{name} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_compression_matches_the_reference(arch):
    """Two compressions in a row (the second with a nonzero residual):
    one scale per reference leaf, stacked repeats included."""
    cfg = get_smoke_config(arch)
    model = lm_params_from_reference(ref_params(arch), cfg, device="cpu")
    rcomp = r_optim.compression_init(ref_params(arch))
    comp = optim_lib.compression_init(model)
    for seed in (3, 4):
        g = ref_grads(arch, seed)
        rdq, rcomp = jax.jit(r_optim.compress_grads)(g, rcomp)
        dq, comp = optim_lib.compress_grads(port_tree(g, arch), comp, model)
        assert all(t.dtype == torch.float32 for t in dq.values())
        assert_trees_close(on_reference_leaves(model, dq), flat(rdq),
                           "dequantized")
        assert_trees_close({k: t.numpy() for k, t in comp.residual.items()},
                           flat(rcomp.residual), "residual")


def test_global_norm_and_schedule_match_the_reference():
    g = ref_grads("llama3.2-1b", 5)
    np.testing.assert_allclose(
        float(optim_lib._global_norm(port_tree(g, "llama3.2-1b"))),
        float(r_optim._global_norm(g)), rtol=RTOL, atol=ATOL)
    cfg = optim_lib.AdamWConfig(warmup_steps=7)
    rcfg = r_optim.AdamWConfig(warmup_steps=7)
    for step in (0, 3, 6, 10):
        np.testing.assert_allclose(
            optim_lib._schedule(cfg, step),
            float(r_optim._schedule(rcfg, jnp.int32(step))), rtol=RTOL)


# ---------------- the port's tests/test_checkpoint_ft.py ----------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn((8, 16), generator=g),
                  "b": torch.zeros((16,))},
            "scan": torch.randn((3, 4, 4), generator=g),
            "step": 7}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 10, t, extra={"next_step": 10})
    restored, extra = ckpt.restore(tmp_path, t, device="cpu")
    assert extra["next_step"] == 10
    assert restored["step"] == 7
    for k in ("w", "b"):
        assert torch.equal(restored["a"][k], t["a"][k])
    assert torch.equal(restored["scan"], t["scan"])


def test_latest_and_rotation(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, t, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    assert sorted(ckpt.committed_steps(tmp_path)) == [4, 5]


def test_uncommitted_checkpoint_ignored(tmp_path):
    t = _tree()
    ckpt.save(tmp_path, 1, t)
    # simulate a crash mid-save: step_2 exists without _COMMITTED
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / "manifest.json").write_text(json.dumps({"step": 2, "leaves": {},
                                                 "extra": {}}))
    assert ckpt.latest_step(tmp_path) == 1


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, _tree(), device="cpu")


def test_restore_casts_dtype(tmp_path):
    t = {"w": torch.ones((4,), dtype=torch.float32)}
    ckpt.save(tmp_path, 1, t)
    like = {"w": torch.empty((4,), dtype=torch.bfloat16, device="meta")}
    restored, _ = ckpt.restore(tmp_path, like, device="cpu")
    assert restored["w"].dtype == torch.bfloat16
    assert restored["w"].device.type == "cpu"


def test_retry_policy_restarts_then_succeeds():
    calls = []

    def body(restarts):
        calls.append(restarts)
        if restarts < 2:
            raise RuntimeError("injected")

    n = RetryPolicy(max_restarts=5, backoff_s=0.0).run(body)
    assert n == 2
    assert calls == [0, 1, 2]


def test_retry_policy_gives_up():
    def body(restarts):
        raise RuntimeError("always")
    with pytest.raises(RuntimeError):
        RetryPolicy(max_restarts=2, backoff_s=0.0).run(body)


def test_straggler_detector_flags_outliers():
    det = StragglerDetector(warmup=5, z_threshold=3.0, patience=2)
    flags = [det.observe(0.1 + 0.001 * (i % 3)) for i in range(20)]
    assert not any(flags)
    assert det.observe(1.5)          # 15x slower -> straggler
    assert not det.should_remesh     # patience=2
    assert det.observe(1.5)
    assert det.should_remesh


def test_fault_injector_fires_once():
    inj = FaultInjector(fail_at=(3,))
    inj.maybe_fail(2)
    with pytest.raises(RuntimeError):
        inj.maybe_fail(3)
    inj.maybe_fail(3)   # second pass after restart: no failure


def test_adamw_decreases_quadratic_loss():
    cfg = optim_lib.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0], requires_grad=True)}
    st = optim_lib.adamw_init(cfg, params)
    loss = lambda p: torch.sum(p["w"] ** 2)
    for _ in range(200):
        g = dict(zip(params, torch.autograd.grad(loss(params),
                                                 list(params.values()))))
        st = optim_lib.adamw_update(cfg, g, st, params)
    assert float(loss(params).detach()) < 1e-2


def test_adafactor_decreases_quadratic_loss():
    cfg = optim_lib.AdafactorConfig(lr=0.05)
    params = {"w": torch.full((4, 4), 3.0, requires_grad=True)}
    st = optim_lib.adafactor_init(cfg, params)
    loss = lambda p: torch.sum(p["w"] ** 2)
    for _ in range(300):
        g = dict(zip(params, torch.autograd.grad(loss(params),
                                                 list(params.values()))))
        st = optim_lib.adafactor_update(cfg, g, st, params)
    assert float(loss(params).detach()) < 1e-2


def test_adafactor_memory_is_factored():
    params = {"w": torch.zeros((128, 256))}
    st = optim_lib.adafactor_init(optim_lib.AdafactorConfig(), params)
    n_state = sum(x.numel() for t in (st.vr, st.vc) for x in t.values())
    assert n_state == 128 + 256   # vs 128*256 for adam


def test_int8_compression_error_feedback():
    """Compressed grads converge to the true gradient on average: the
    residual carries quantization error to the next step."""
    g = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=(64,)),
                              dtype=torch.float32)}
    comp = optim_lib.compression_init(g)
    acc = torch.zeros((64,))
    for _ in range(50):
        dq, comp = optim_lib.compress_grads(g, comp)
        acc = acc + dq["w"]
    # mean transmitted grad ~ true grad (error feedback kills the bias)
    np.testing.assert_allclose((acc / 50).numpy(), g["w"].numpy(),
                               atol=2e-3)


def test_int8_quantize_range():
    x = torch.tensor([-1.0, 0.0, 0.5, 1.0])
    q, s = optim_lib.quantize_int8(x)
    assert q.dtype == torch.int8
    assert int(q.abs().max()) <= 127
    np.testing.assert_allclose(optim_lib.dequantize_int8(q, s).numpy(),
                               x.numpy(), atol=0.02)


# ---------------- the on-disk protocol across packages ----------------

def test_reference_reads_a_directory_written_by_the_port(tmp_path):
    """The port's model and optimizer state, bf16 leaves included: the
    reference's `latest_step` / `committed_steps` read the directory, the
    manifest has the reference's keys for the state's fields, and a
    restore into the port is bitwise."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="bfloat16")
    from repro_torch.models import transformer as tt
    model = tt.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = optim_lib.adamw_init(optim_lib.AdamWConfig(
        moment_dtype="bfloat16"), model)
    state = state._replace(step=3, mu={k: v + 0.5 for k, v in
                                       state.mu.items()})
    tree = {"params": dict(model.named_parameters()), "opt_state": state}
    for s in (2, 4, 6):
        ckpt.save(tmp_path, s, tree, extra={"next_step": s}, keep=2)
    assert r_ckpt.latest_step(tmp_path) == 6
    assert sorted(r_ckpt.committed_steps(tmp_path)) == [4, 6]
    manifest = json.loads((tmp_path / "step_00000006" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["opt_state/.step"]["dtype"] == "int32"
    assert manifest["leaves"]["params/embed.table"]["dtype"] == "bfloat16"
    assert "opt_state/.mu/scan.0.attn.wq" in manifest["leaves"]
    back, extra = ckpt.restore(tmp_path, tree, device="cpu")
    assert extra == {"next_step": 6} and back["opt_state"].step == 3
    for name, p in model.named_parameters():
        assert back["params"][name].dtype == p.dtype
        assert torch.equal(back["params"][name], p)
    for k, v in state.mu.items():
        assert torch.equal(back["opt_state"].mu[k], v)


def test_opt_state_from_reference_refuses_a_mismatch():
    params = ref_params("llama3.2-1b")
    state = jax.tree.map(np.asarray, r_optim.adamw_init(
        r_optim.AdamWConfig(), params))
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt_state_from_reference(state, get_smoke_config("llama3.2-1b"),
                                 optimizer="sgd", device="cpu")
    with pytest.raises(ValueError, match="trees differ"):
        opt_state_from_reference(state, get_smoke_config("xlstm-1.3b"),
                                 device="cpu")
    with pytest.raises(ValueError, match="reference shape"):
        opt_state_from_reference(
            state._replace(mu={**state.mu, "final_norm": {"scale": np.zeros(
                (3,), np.float32)}}),
            get_smoke_config("llama3.2-1b"), device="cpu")
