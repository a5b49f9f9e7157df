"""The port's multi-device training on the CPU in `gloo` worlds of 2: TP
on "model" for the MoE config (dense dispatch on the whole batch), DP with
FSDP and TP alone for llama, held to the single-device loop as in
`test_torch_dist_train.py` (whose helpers this file uses); and
`act_sharding` against the unconstrained step."""
from test_torch_dist_train import train_on_grids


def test_grid_training_on_two_ranks_matches_one_device(tmp_path):
    train_on_grids(tmp_path, 2, ("moe-dense-tp", "llama-dp-fsdp",
                                 "llama-tp"))


def _act_rank(rank, world, init):
    import numpy as np
    import torch

    from torch_dist_helpers import grid, start_rank, stop_rank
    start_rank(rank, world, init)
    try:
        from torch.distributed.tensor import Shard

        from repro_torch.configs import get_smoke_config
        from repro_torch.data.lm import LMDataConfig, batches
        from repro_torch.models import loss_and_grads
        from repro_torch.models import transformer as tfm
        from repro_torch.sharding import distribute_batch, distribute_model
        cfg = get_smoke_config("llama3.2-1b")
        _, mesh = grid((1, 2))
        model = distribute_model(tfm.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), mesh)
        toks, labels = next(batches(LMDataConfig(cfg.vocab_size, 16, 4)))
        b = distribute_batch({"tokens": torch.as_tensor(toks),
                              "labels": torch.as_tensor(labels)}, mesh)
        # the inter-layer activation sequence-sharded over "model"
        seq = (Shard(0), Shard(1))
        out = {}
        for what, act in (("plain", None), ("seq", seq)):
            loss, grads = loss_and_grads(model, b, act_sharding=act)
            out[what] = (loss.numpy(), {n: g.full_tensor().numpy()
                                        for n, g in grads.items()})
        np.testing.assert_allclose(out["seq"][0], out["plain"][0],
                                   rtol=5e-4, atol=5e-5)
        for n, g in out["plain"][1].items():
            np.testing.assert_allclose(out["seq"][1][n], g, rtol=5e-4,
                                       atol=5e-5, err_msg=n)
    finally:
        stop_rank()


def test_act_sharding_redistributes_the_activation(tmp_path):
    """`act_sharding` (the reference's sharding constraint on the scan
    carry, here DTensor placements) on a (1, 2) grid: the sequence-sharded
    activation gives the loss and gradients of the unconstrained step
    within rtol 5e-4 / atol 5e-5 (`tests/test_pipeline_parallel.py:54-55`)."""
    from torch_dist_helpers import spawn
    spawn(_act_rank, 2, tmp_path, timeout=60)
