"""The recurrent sequence forms on a grid: xLSTM's mLSTM / sLSTM
(xlstm-1.3b) and Griffin's RG-LRU (recurrentgemma-9b) at SMOKE size,
trained through `train.loop.train` in `gloo` worlds (one process per
rank) on a (2, 2) ("data", "model") grid, with and without FSDP, and on a
(2, 1) data-parallel grid. Every run starts from the reference's initial
parameters (JAX-initialized, converted); three steps on a grid hold their
losses and whole updated parameters to the port's single-device loop at
rtol 5e-4 / atol 5e-5 (`tests/test_pipeline_parallel.py:54-55`).

On (2, 2) the heads (xLSTM) and RG-LRU channels split over "model". With
sequence-parallel activations (the dry run's layout) the prefill's
last-position logits are held to one device at 2e-5
(`tests/test_pipeline_parallel.py:44-45`), and so are those of a batch of
one row on (1, 4) (whole: "data" of size 1 does not split it), and one
step's loss and gradients at rtol 5e-4 / atol 5e-5.

The ranks import this module, so it imports neither JAX nor the
reference at the top.
"""
import numpy as np
import pytest
import torch

from test_torch_dist_train import (ATOL, BATCH, RTOL, SEQ, reference_init,
                                   run_loop, smoke)
from torch_dist_helpers import grid, spawn, start_rank, stop_rank

FWD_TOL = 2e-5                   # tests/test_pipeline_parallel.py:44-45
ARCHS = ("xlstm-1.3b", "recurrentgemma-9b")

torch.set_num_threads(1)

# (grid shape, loop options)
GRIDS = {"dp-tp": ((2, 2), {}), "fsdp-tp": ((2, 2), dict(fsdp=True)),
         "dp": ((2, 1), {})}


def _batch(cfg):
    from repro_torch.data import lm as p_data
    toks, labels = next(p_data.batches(p_data.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)))
    return {"tokens": torch.as_tensor(toks),
            "labels": torch.as_tensor(labels)}


def one_device_sp(arch, ckpt_dir):
    """The single-device prefill logits, loss and gradients from the
    step-0 checkpoint."""
    from repro_torch.models import loss_and_grads, make_prefill_step
    model, batch = _restored(arch, ckpt_dir), _batch(smoke(arch))
    prefill = make_prefill_step(smoke(arch))
    logits = prefill(model, batch)
    one_row = prefill(model, {"tokens": batch["tokens"][:1]})
    loss, grads = loss_and_grads(model, batch)
    return (logits.numpy(), one_row.numpy(), float(loss),
            {n: g.numpy() for n, g in grads.items()})


def _restored(arch, ckpt_dir):
    """The port's model holding the step-0 checkpoint's parameters."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train import checkpoint as ckpt
    model = tfm.init_params(smoke(arch), torch.Generator().manual_seed(1),
                            max_len=SEQ, device="cpu")
    tree = {"params": dict(model.named_parameters())}
    restored, _ = ckpt.restore(ckpt_dir, tree, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(restored["params"][name])
    return model


def _sp_rank(rank, world, init, ckpt_dirs, expected):
    """Prefill and one loss-and-gradients step of each arch on (2, 2)
    with sequence-parallel activations, against one device."""
    start_rank(rank, world, init)
    try:
        from torch.distributed.tensor import Shard

        from repro_torch.models import loss_and_grads, make_prefill_step
        from repro_torch.sharding import distribute_batch, distribute_model
        _, mesh = grid((2, 2))
        seq = (Shard(0), Shard(1))
        for arch in ARCHS:
            cfg = smoke(arch)
            model = distribute_model(_restored(arch, ckpt_dirs[arch]), mesh)
            b = distribute_batch(_batch(cfg), mesh)
            want_logits, want_row, want_loss, want_grads = expected[arch]
            prefill = make_prefill_step(cfg, mesh=mesh, act_sharding=seq)
            logits = prefill(model, b).full_tensor()
            np.testing.assert_allclose(logits.numpy(), want_logits,
                                       rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=f"{arch} prefill")
            # a batch of one on (1, 4): "data" (of size 1) does not split
            # it
            _, mesh14 = grid((1, 4))
            row = make_prefill_step(cfg, mesh=mesh14)(
                distribute_model(_restored(arch, ckpt_dirs[arch]), mesh14),
                distribute_batch({"tokens": _batch(cfg)["tokens"][:1]},
                                 mesh14)).full_tensor()
            np.testing.assert_allclose(row.numpy(), want_row, rtol=FWD_TOL,
                                       atol=FWD_TOL,
                                       err_msg=f"{arch} prefill of one row")
            loss, grads = loss_and_grads(model, b, mesh=mesh,
                                         act_sharding=seq)
            np.testing.assert_allclose(float(loss), want_loss, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{arch} loss")
            for n, g in grads.items():
                np.testing.assert_allclose(
                    g.full_tensor().numpy(), want_grads[n], rtol=RTOL,
                    atol=ATOL, err_msg=f"{arch} gradient {n}")
    finally:
        stop_rank()


def _loop_rank(rank, world, init, names, ckpt_dirs, expected):
    start_rank(rank, world, init)
    try:
        for arch in ARCHS:
            for name in names:
                shape, kw = GRIDS[name]
                g, _ = grid(shape)
                losses, params, counts = run_loop(arch, ckpt_dirs[arch], g,
                                                  **kw)
                want_loss, want_params = expected[arch]
                what = f"{arch} on {name}"
                np.testing.assert_allclose(losses, want_loss, rtol=RTOL,
                                           atol=ATOL, err_msg=what)
                for n, p in params.items():
                    np.testing.assert_allclose(p.numpy(), want_params[n],
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=f"{what}: {n}")
                # gradients are reduced over "data" on every grid here
                assert counts.get("all_reduce", 0) + counts.get(
                    "reduce_scatter_tensor", 0) > 0, (what, counts)
    finally:
        stop_rank()


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """Step-0 checkpoints of the reference's initial parameters and the
    single-device loop's losses and parameters, per arch."""
    tmp = tmp_path_factory.mktemp("recurrent")
    ckpt_dirs, expected = {}, {}
    for arch in ARCHS:
        ckpt_dirs[arch] = tmp / arch
        reference_init(arch, ckpt_dirs[arch])
        losses, params = run_loop(arch, ckpt_dirs[arch], "cpu")
        assert len(losses) == 3 and np.all(np.isfinite(losses))
        expected[arch] = (losses, {n: p.numpy() for n, p in params.items()})
    return ckpt_dirs, expected


@pytest.mark.parametrize("world,names", [(4, ("dp-tp", "fsdp-tp")),
                                         (2, ("dp",))],
                         ids=["2x2", "2x1"])
def test_recurrent_training_on_a_grid_matches_one_device(
        tmp_path, one_device, world, names):
    ckpt_dirs, expected = one_device
    spawn(_loop_rank, world, tmp_path, names, ckpt_dirs, expected,
          timeout=100)


def test_recurrent_prefill_and_gradients_sequence_parallel(tmp_path,
                                                           one_device):
    ckpt_dirs, _ = one_device
    expected = {arch: one_device_sp(arch, ckpt_dirs[arch])
                for arch in ARCHS}
    spawn(_sp_rank, 4, tmp_path, ckpt_dirs, expected, timeout=80)
