"""The port's multi-device training on the CPU: `gloo` worlds of 4 as a
(2, 2) ("data", "model") grid and of 2, one process per rank.

Every run starts from the reference's initial parameters (JAX-initialized,
converted), written as the port's step-0 checkpoint, which each rank
restores onto its grid. Three train steps of `train.loop.train` on the
grid (DP, DP + FSDP, TP on "model", EP for the MoE config) hold their
losses and updated parameters to the port's single-device loop on the
same batches at rtol 5e-4 / atol 5e-5 (`tests/test_pipeline_parallel.py:54-55`);
one more step on each grid reports its collectives (`StepCommMode`, the
count of each per train step).
Worlds of 2 are in `test_torch_dist_train2.py`, the rest of the
multi-device slice in `test_torch_dist_parts.py`.

The MoE config trains at capacity_factor E/k, where no token-expert pair
is dropped on one device or on any EP shard: EP sizes its buffers per
source shard, so where pairs drop, the two paths drop different ones by
design (the reference's EP test compares them at 8x capacity for the
same reason).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_dist_helpers import grid, spawn, start_rank, stop_rank

SEQ, BATCH, STEPS = 16, 4, 3
RTOL, ATOL = 5e-4, 5e-5          # tests/test_pipeline_parallel.py:54-55

torch.set_num_threads(1)


def smoke(arch):
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    return cfg


def reference_init(arch, path):
    """The reference's initial parameters, converted, with zero AdamW
    state, as the port's step-0 checkpoint at `path`."""
    import jax
    from repro.configs import get_smoke_config as r_smoke
    from repro.models import transformer as rt

    from repro_torch.convert import lm_params_from_reference
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as p_loop
    from repro_torch.train import optim
    rcfg = dataclasses.replace(r_smoke(arch),
                               capacity_factor=smoke(arch).capacity_factor)
    params = jax.tree.map(np.asarray, rt.init_params(jax.random.key(0),
                                                     rcfg, max_len=SEQ))
    model = lm_params_from_reference(params, smoke(arch), device="cpu")
    state = p_loop.TrainState(model, optim.adamw_init(optim.AdamWConfig(),
                                                      model), None, 0)
    ckpt.save(path, 0, p_loop.checkpoint_tree(state), extra={"next_step": 0})


def run_loop(arch, ckpt_dir, mesh, **kw):
    """`train` for STEPS steps from the step-0 checkpoint: (losses,
    {name: whole parameter})."""
    from repro_torch.data import lm as p_data
    from repro_torch.train import loop as p_loop
    cfg = smoke(arch)
    tc = p_loop.TrainConfig(steps=STEPS, ckpt_dir=str(ckpt_dir),
                            ckpt_every=0, log_every=0, lr=3e-3, **kw)
    data = p_data.LMDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                               global_batch=BATCH)
    it = p_data.batches(data)
    hist = p_loop.train(cfg, tc, mesh, it, max_len=SEQ)
    state = hist["state"]
    params = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
              .detach().clone()
              for n, p in state.params.named_parameters()}
    if mesh == "cpu":
        return hist["loss"], params
    # one more step, its collectives counted
    from repro_torch.sharding import distribute_batch
    from repro_torch.sharding.comms import StepCommMode
    toks, labels = next(it)
    dmesh = next(state.params.parameters()).device_mesh
    b = distribute_batch({"tokens": torch.as_tensor(toks),
                          "labels": torch.as_tensor(labels)}, dmesh)
    with StepCommMode() as comm:
        p_loop.make_step(cfg, tc, mesh)(state.params, state.opt_state,
                                        state.comp_state, b)
    return hist["loss"], params, comm.counts()


# (arch, grid shape, loop options)
CASES = {
    "llama-dp-tp": ("llama3.2-1b", (2, 2), {}),
    "llama-fsdp-tp": ("llama3.2-1b", (2, 2), dict(fsdp=True)),
    "moe-ep": ("deepseek-moe-16b", (2, 2), dict(use_ep=True)),
    "moe-ep-fsdp": ("deepseek-moe-16b", (2, 2), dict(use_ep=True,
                                                     fsdp=True)),
    "moe-dense-tp": ("deepseek-moe-16b", (1, 2), {}),
    "llama-dp-fsdp": ("llama3.2-1b", (2, 1), dict(fsdp=True)),
    "llama-tp": ("llama3.2-1b", (1, 2), {}),
}


def _loop_rank(rank, world, init, cases, ckpt_dirs, expected, tmp):
    start_rank(rank, world, init)
    try:
        from torch.distributed.tensor import DTensor
        for name in cases:
            arch, shape, kw = CASES[name]
            g, _ = grid(shape)
            losses, params, counts = run_loop(arch, ckpt_dirs[arch], g, **kw)
            if rank == 0:
                (tmp / f"collectives_{name}.json").write_text(
                    json.dumps(counts))
            want_loss, want_params = expected[arch]
            np.testing.assert_allclose(losses, want_loss, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
            for n, p in params.items():
                np.testing.assert_allclose(p.numpy(), want_params[n],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name}: {n}")
            assert not isinstance(p, DTensor)
    finally:
        stop_rank()


def train_on_grids(tmp_path, world, cases):
    """The single-device loop in this process, then `cases` in a world of
    `world` ranks, each held to it."""
    archs = sorted({CASES[c][0] for c in cases})
    ckpt_dirs, expected = {}, {}
    for arch in archs:
        ckpt_dirs[arch] = tmp_path / arch
        reference_init(arch, ckpt_dirs[arch])
        losses, params = run_loop(arch, ckpt_dirs[arch], "cpu")
        assert len(losses) == STEPS and np.all(np.isfinite(losses))
        expected[arch] = (losses, {n: p.numpy() for n, p in params.items()})
    spawn(_loop_rank, world, tmp_path, cases, ckpt_dirs, expected,
          tmp_path, timeout=80)
    for name in cases:
        counts = json.loads((tmp_path / f"collectives_{name}.json")
                            .read_text())
        print(f"{name}: collectives per step {counts}")
        arch, shape, kw = CASES[name]
        assert counts, name                        # a grid of 2+ ranks
        if shape[0] > 1:                           # gradients over "data"
            assert counts.get("all_reduce", 0) + counts.get(
                "reduce_scatter_tensor", 0) > 0, (name, counts)
        if kw.get("use_ep"):
            # two exchanges out and back per MoE layer: forward, remat's
            # re-forward and backward
            n_moe = smoke(arch).layer_kinds.count("moe")
            assert counts.get("alltoall_base") == 6 * n_moe, (name, counts)
        else:
            assert "alltoall_base" not in counts, (name, counts)


@pytest.mark.parametrize("cases", [("llama-dp-tp", "llama-fsdp-tp"),
                                   ("moe-ep", "moe-ep-fsdp")],
                         ids=["4-llama", "4-moe-ep"])
def test_grid_training_matches_one_device(tmp_path, cases):
    train_on_grids(tmp_path, 4, cases)
