"""The pieces of the port's multi-device training on the CPU, each in a
`gloo` world of 4 (one process per rank):

- `moe_apply_ep` over a (2, 2) ("data", "model") grid, with and without
  FSDP of the expert weights, against the port's dense `moe_apply` at 8x
  capacity: output and every gradient within rtol / atol 2e-4
  (`tests/test_sharding_subprocess.py:86-87`); the dense path against the
  reference's at the same bar;
- `pipeline_apply` over 4 stages of 8 tanh layers, D 16, 4 microbatches,
  against `sequential_reference`: forward 2e-5, gradients rtol 5e-4 /
  atol 5e-5 (`tests/test_pipeline_parallel.py:44-55`), with the stacked
  weights as a DTensor and as a plain tensor;
- elastic checkpoints: a single-device checkpoint restores bitwise onto
  (2, 2) and (4, 1); one written on (2, 2) restores bitwise onto (4, 1),
  onto one device in every rank and, after the world ends, in the test's
  own process;
- the optimizers alone: the same gradients and state through Adafactor
  and through int8 compression + AdamW on a (2, 2) grid with FSDP and on
  one device, at rtol 2e-5 (PR 18's optimizer bar,
  `tests/test_pipeline_parallel.py:44-45`);
- `python -m repro_torch.launch.train` under `torchrun` on two CPU ranks
  (data-parallel, FSDP) against the same CLI run alone.

Parameters come from the reference's initializers (JAX), converted.
"""
import numpy as np
import pytest
import torch

from torch_dist_helpers import grid, spawn, start_rank, stop_rank

torch.set_num_threads(1)

EP_TOL = 2e-4                    # tests/test_sharding_subprocess.py:86-87
PIPE_FWD = 2e-5                  # tests/test_pipeline_parallel.py:44-45
PIPE_RTOL, PIPE_ATOL = 5e-4, 5e-5    # tests/test_pipeline_parallel.py:54-55
O_RTOL, O_ATOL = 2e-5, 2e-5      # tests/test_pipeline_parallel.py:44-45
MOE = "deepseek-moe-16b"
LLAMA = "llama3.2-1b"


def reference_model(arch):
    """The port's SMOKE model holding the reference's initial parameters
    (seed 0)."""
    import jax
    from repro.configs import get_smoke_config as r_smoke
    from repro.models import transformer as rt

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_reference
    params = jax.tree.map(np.asarray, rt.init_params(
        jax.random.key(0), r_smoke(arch), max_len=16))
    return lm_params_from_reference(params, get_smoke_config(arch),
                                    device="cpu")


def _placed(t, like):
    """Whole tensor `t` placed as DTensor `like` (a local slice)."""
    from repro_torch.sharding import place
    return place(t, like.device_mesh, like.placements)


def _whole(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t
            ).detach().numpy().copy()


# ----------------------------------------------------------------------
# moe_apply_ep
# ----------------------------------------------------------------------

def _moe_inputs():
    """The reference's MoE layer (moe_init, key 0) and input (key 1, x 0.1)
    as numpy, the port's dense output and gradients of sum(out * ct), and
    the reference's dense output."""
    import jax
    from repro.configs import get_smoke_config as r_smoke
    from repro.models import moe as r_moe

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import MoE, capacity_of, moe_apply
    rcfg, cfg = r_smoke(MOE), get_smoke_config(MOE)
    rp = r_moe.moe_init(jax.random.key(0), rcfg)
    x = np.asarray(jax.random.normal(jax.random.key(1), (2, 16, cfg.d_model))
                   ) * 0.1
    cap = capacity_of(cfg, 2 * 16 // 4)
    ref = np.asarray(r_moe.moe_apply(rp, x, rcfg, capacity=8 * cap))
    params = {"router": rp["router"], "wg": rp["wg"], "wu": rp["wu"],
              "wd": rp["wd"], **{f"shared.{k}": v
                                 for k, v in rp["shared"].items()}}
    params = {k: np.array(v) for k, v in params.items()}
    ct = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)

    m = MoE(cfg, torch.Generator().manual_seed(0))
    m.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = moe_apply(m, xt, cfg, capacity=8 * cap)
    (out * torch.from_numpy(ct)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    return params, x, ct, cap, ref, out.detach().numpy(), xt.grad.numpy(), \
        grads


def _moe_rank(rank, world, init, params, x, ct, cap, dense, dx, dgrads):
    start_rank(rank, world, init)
    try:
        from repro_torch.configs import get_smoke_config
        from repro_torch.models.layers import settle
        from repro_torch.models.moe import MoE, moe_apply_ep
        from repro_torch.sharding import place, port_layout, to_placements
        from torch.distributed.tensor import Replicate, Shard
        cfg = get_smoke_config(MOE)
        _, mesh = grid((2, 2))
        for fsdp in (False, True):
            m = MoE(cfg, torch.Generator().manual_seed(0))
            m.load_state_dict({k: torch.from_numpy(v)
                               for k, v in params.items()})
            # the layer's specs as they sit in a model (layer 1 is MoE)
            full = {f"layers.1.moe.{k}": v for k, v in params.items()}
            specs, _ = port_layout(full, cfg, mesh, fsdp=fsdp)
            for name, p in list(m.named_parameters()):
                owner = m.shared if name.startswith("shared.") else m
                d = place(p.detach(), mesh, to_placements(
                    specs[f"layers.1.moe.{name}"], mesh))
                setattr(owner, name.rpartition(".")[2],
                        torch.nn.Parameter(d))
            xd = place(torch.from_numpy(x), mesh,
                       [Shard(0), Replicate()]).requires_grad_(True)
            out = moe_apply_ep(m, xd, cfg, mesh, capacity=cap,
                               fsdp_axis="data" if fsdp else None)
            out = settle(out)       # the shared experts' row-parallel sum
            (out * _placed(torch.from_numpy(ct), out)).sum().backward()
            np.testing.assert_allclose(_whole(out), dense, rtol=EP_TOL,
                                       atol=EP_TOL)
            np.testing.assert_allclose(_whole(xd.grad), dx, rtol=EP_TOL,
                                       atol=EP_TOL)
            for n, p in m.named_parameters():
                np.testing.assert_allclose(_whole(p.grad), dgrads[n],
                                           rtol=EP_TOL, atol=EP_TOL,
                                           err_msg=f"fsdp={fsdp}: {n}")
    finally:
        stop_rank()


def test_moe_ep_matches_dense_dispatch(tmp_path):
    params, x, ct, cap, ref, dense, dx, dgrads = _moe_inputs()
    np.testing.assert_allclose(dense, ref, rtol=EP_TOL, atol=EP_TOL)
    spawn(_moe_rank, 4, tmp_path, params, x, ct, cap, dense, dx, dgrads,
          timeout=60)


# ----------------------------------------------------------------------
# pipeline_apply
# ----------------------------------------------------------------------

L, D = 8, 16                     # 8 layers -> 4 stages x 2 layers


def stage_fn(w_stack, h):
    for w in w_stack:
        h = torch.tanh(h @ w)
    return h


def _pipe_inputs():
    import jax
    W = np.asarray(jax.random.normal(jax.random.key(0), (L, D, D))
                   ) * (0.5 / np.sqrt(D))
    x = np.asarray(jax.random.normal(jax.random.key(1), (8, D)))
    return W.astype(np.float32), x.astype(np.float32)


def _pipe_rank(rank, world, init, W, x):
    start_rank(rank, world, init)
    try:
        from repro_torch.train.pipeline import (pipeline_apply,
                                                sequential_reference)
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.launch.mesh import device_mesh, make_mesh
        mesh = device_mesh(make_mesh((4,), ("pipe",), ["cpu"] * 4))
        Wt, xt = torch.from_numpy(W), torch.from_numpy(x)
        ref = sequential_reference(stage_fn, Wt, xt, 4)
        g_ref = torch.func.grad(lambda w: (sequential_reference(
            stage_fn, w, xt, 4) ** 2).sum())(Wt)
        gx_ref = torch.func.grad(lambda v: (sequential_reference(
            stage_fn, Wt, v, 4) ** 2).sum())(xt)
        for as_dtensor in (True, False):
            w = Wt.clone()
            if as_dtensor:
                w = DTensor.from_local(w, mesh, [Replicate()],
                                       run_check=False)
            w.requires_grad_(True)
            xv = xt.clone().requires_grad_(True)
            got = pipeline_apply(stage_fn, w, xv, mesh, n_microbatches=4)
            np.testing.assert_allclose(got.detach().numpy(), ref.numpy(),
                                       rtol=PIPE_FWD, atol=PIPE_FWD)
            (got ** 2).sum().backward()
            np.testing.assert_allclose(_whole(w.grad), g_ref.numpy(),
                                       rtol=PIPE_RTOL, atol=PIPE_ATOL)
            np.testing.assert_allclose(xv.grad.numpy(), gx_ref.numpy(),
                                       rtol=PIPE_RTOL, atol=PIPE_ATOL)
    finally:
        stop_rank()


def test_pipeline_matches_sequential_and_differentiates(tmp_path):
    W, x = _pipe_inputs()
    spawn(_pipe_rank, 4, tmp_path, W, x, timeout=60)


# ----------------------------------------------------------------------
# elastic checkpoints
# ----------------------------------------------------------------------

def _state_tree(model, mesh=None, fsdp=True):
    """{"params", "opt_state"} of `model` (placed on `mesh` when given)
    with AdamW state after one update by seeded gradients."""
    from repro_torch.sharding import distribute_model
    from repro_torch.train import optim
    if mesh is not None:
        distribute_model(model, mesh, fsdp=fsdp)
    ocfg = optim.AdamWConfig(warmup_steps=1)
    st = optim.adamw_init(ocfg, model)
    rng = np.random.default_rng(5)
    grads = {}
    for n, p in model.named_parameters():
        g = torch.from_numpy((rng.normal(size=p.shape) * 0.01
                              ).astype(np.float32)).to(p.dtype)
        grads[n] = _placed(g, p) if mesh is not None else g
    st = optim.adamw_update(ocfg, grads, st, model)
    return {"params": dict(model.named_parameters()), "opt_state": st}


def _flat_whole(tree):
    from repro_torch.train.checkpoint import _flatten
    return {k: _whole(v) if isinstance(v, torch.Tensor) else v
            for k, v in _flatten(tree).items()}


def _assert_bitwise(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, (what, k)
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what}: {k}")
        else:
            assert got[k] == v, (what, k)


def _ckpt_rank(rank, world, init, tmp, single):
    start_rank(rank, world, init)
    try:
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import transformer as tfm
        from repro_torch.train import checkpoint as ckpt
        cfg = get_smoke_config(LLAMA)
        fresh = lambda: tfm.Transformer(cfg, torch.Generator().manual_seed(7))
        _, m22 = grid((2, 2))
        _, m41 = grid((4, 1))
        # a single-device checkpoint onto (2, 2) and (4, 1)
        for mesh in (m22, m41):
            like = _state_tree(fresh(), mesh)
            got, extra = ckpt.restore(tmp / "single", like,
                                      shardings=ckpt.shardings_of(like))
            assert extra == {"next_step": 1}
            assert got["params"]["embed.table"].device_mesh is mesh
            _assert_bitwise(_flat_whole(got), single, "single -> grid")
        # one written on (2, 2) onto (4, 1) and onto one device
        tree = _state_tree(fresh(), m22)
        written = _flat_whole(tree)
        ckpt.save(tmp / "grid", 2, tree, extra={"next_step": 2})
        like = _state_tree(fresh(), m41)
        got, _ = ckpt.restore(tmp / "grid", like,
                              shardings=ckpt.shardings_of(like))
        _assert_bitwise(_flat_whole(got), written, "(2, 2) -> (4, 1)")
        got, _ = ckpt.restore(tmp / "grid", _state_tree(fresh()),
                              device="cpu")
        _assert_bitwise(_flat_whole(got), written, "(2, 2) -> one device")
        if rank == 0:
            torch.save(written, tmp / "written.pt")
    finally:
        stop_rank()


def test_checkpoints_restore_bitwise_across_grids(tmp_path):
    from repro_torch.train import checkpoint as ckpt
    tree = _state_tree(reference_model(LLAMA))
    ckpt.save(tmp_path / "single", 1, tree, extra={"next_step": 1})
    spawn(_ckpt_rank, 4, tmp_path, tmp_path, _flat_whole(tree), timeout=60)
    assert ckpt.committed_steps(tmp_path / "grid") == [2]
    # written on (2, 2), read back here, after the world ended
    got, extra = ckpt.restore(tmp_path / "grid", tree, device="cpu")
    assert extra == {"next_step": 2}
    _assert_bitwise(_flat_whole(got), torch.load(tmp_path / "written.pt",
                                                 weights_only=False),
                    "(2, 2) -> this process")
# ----------------------------------------------------------------------
# the optimizers alone: the same gradients and state, grid vs one device
# ----------------------------------------------------------------------

def _opt_model(arch, state):
    """The port's SMOKE model holding `state` ({name: numpy array})."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    model = tfm.Transformer(get_smoke_config(arch),
                            torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _opt_inputs(arch):
    """The reference's initial parameters and two seeded gradient trees
    (numpy), by port parameter name."""
    model = reference_model(arch)
    rng = np.random.default_rng(3)
    grads = [{n: (rng.normal(size=p.shape) * 0.01).astype(np.float32)
              for n, p in model.named_parameters()} for _ in range(2)]
    return {n: p.detach().numpy().copy()
            for n, p in model.named_parameters()}, grads


def _opt_steps(model, grads, kind, mesh=None):
    """Two optimizer steps of `kind` from fresh state: ({name: whole
    parameter}, {leaf: whole state tensor})."""
    from repro_torch.sharding import distribute_model
    from repro_torch.train import optim
    if mesh is not None:
        distribute_model(model, mesh, fsdp=True)
    named = dict(model.named_parameters())

    def placed(g):
        out = {}
        for n, a in g.items():
            t = torch.from_numpy(a)
            p = named[n]
            out[n] = _placed(t, p) if hasattr(p, "device_mesh") else t
        return out

    if kind == "adafactor":
        ocfg = optim.AdafactorConfig(lr=1e-2)
        st = optim.adafactor_init(ocfg, model)
        for g in grads:
            st = optim.adafactor_update(ocfg, placed(g), st, model)
        state = {**{f"vr/{k}": v for k, v in st.vr.items()},
                 **{f"vc/{k}": v for k, v in st.vc.items()}}
    else:
        ocfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1)
        st = optim.adamw_init(ocfg, model)
        comp = optim.compression_init(model)
        for g in grads:
            dq, comp = optim.compress_grads(placed(g), comp, model)
            st = optim.adamw_update(ocfg, dq, st, model)
        state = {**{f"mu/{k}": v for k, v in st.mu.items()},
                 **{f"nu/{k}": v for k, v in st.nu.items()},
                 **{f"res/{k}": v for k, v in comp.residual.items()}}
    whole = lambda t: (t.full_tensor() if hasattr(t, "full_tensor")
                       else t).detach().numpy().copy()
    return ({n: whole(p) for n, p in model.named_parameters()},
            {k: whole(v) for k, v in state.items()})


def _opt_rank(rank, world, init, arch, kind, state0, grads, expected):
    start_rank(rank, world, init)
    try:
        _, mesh = grid((2, 2))
        params, state = _opt_steps(_opt_model(arch, state0), grads, kind,
                                   mesh)
        want_p, want_s = expected
        for n, v in params.items():
            np.testing.assert_allclose(v, want_p[n], rtol=O_RTOL,
                                       atol=O_ATOL, err_msg=n)
        for k, v in state.items():
            np.testing.assert_allclose(v, want_s[k], rtol=O_RTOL,
                                       atol=O_ATOL, err_msg=k)
    finally:
        stop_rank()


@pytest.mark.parametrize("kind", ["adafactor", "int8-adamw"])
def test_optimizer_steps_on_a_grid_match_one_device(tmp_path, kind):
    state0, grads = _opt_inputs(MOE)
    expected = _opt_steps(_opt_model(MOE, state0), grads, kind)
    spawn(_opt_rank, 4, tmp_path, MOE, kind, state0, grads, expected,
          timeout=60)


# ----------------------------------------------------------------------
# the CLI under torchrun
# ----------------------------------------------------------------------

def test_cli_trains_data_parallel_under_torchrun(tmp_path):
    import os
    import re
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = {**os.environ, "PYTHONPATH": src, "OMP_NUM_THREADS": "1"}
    args = ["-m", "repro_torch.launch.train", "--arch", LLAMA, "--smoke",
            "--device", "cpu", "--steps", "3", "--seq", "16", "--batch",
            "4", "--ckpt-every", "0"]
    finals = []
    for pre, ckpt in (([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node", "2"], "two"),
                      ([sys.executable], "one")):
        flags = ["--fsdp"] if ckpt == "two" else []
        r = subprocess.run(pre + args + flags + ["--ckpt",
                                                 str(tmp_path / ckpt)],
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr[-3000:]
        finals.append(re.findall(r"final loss ([0-9.]+)", r.stdout))
    # rank 0 alone prints the summary line
    assert len(finals[0]) == 1 and finals[0] == finals[1], finals
