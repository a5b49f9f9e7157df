"""The port's fault-tolerant training loop against the reference's, on the
CPU at a tiny float32 config.

The reference's initial parameters (its `init_state`, seed 0), converted,
are written as the port's step-0 checkpoint, so the port's `train` resumes
from them through its own resume path. Over 8 steps of the same batches
(`data/lm.py::batches`, seed 0) the two loss histories agree within the
model bar, rtol 2e-2 / atol 2e-3 (`tests/test_arch_smoke.py:118-119`), for
AdamW, Adafactor and int8 compression; under a `FaultInjector` the restart
count and the steps resumed from are the reference's. Then the CLI and the
two training examples at a few steps.
"""
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.data import lm as r_data
from repro.models.config import ModelConfig as RModelConfig
from repro.train import loop as r_loop
from repro.train.ft import FaultInjector as RFaultInjector

from repro_torch.convert import lm_params_from_reference
from repro_torch.data import lm as p_data
from repro_torch.launch import mesh as p_mesh
from repro_torch.launch import train as p_launch
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as p_loop
from repro_torch.train.ft import FaultInjector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-2, 2e-3          # tests/test_arch_smoke.py:118-119
STEPS, SEQ, BATCH = 8, 16, 4

torch.set_num_threads(1)

TINY = dict(name="tiny-train", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
            block_pattern=("attn",), ffn_kind="swiglu", dtype="float32")


def run_both(tmp_path, capsys, fail_at=(), **tc_kw):
    """The reference's `train` and the port's (resumed from the
    reference's converted initial parameters): (reference history, its
    resumed-from steps, the port's history, its resumed-from steps)."""
    rcfg, cfg = RModelConfig(**TINY), ModelConfig(**TINY)
    # one CPU device; `jax.sharding.Mesh` keeps the axes in auto mode (the
    # explicit axes of `jax.make_mesh` refuse the embedding's gather)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    kw = dict(steps=STEPS, ckpt_every=3, log_every=0, lr=3e-3, **tc_kw)
    rtc = r_loop.TrainConfig(ckpt_dir=str(tmp_path / "ref"), **kw)
    ptc = p_loop.TrainConfig(ckpt_dir=str(tmp_path / "port"), **kw)
    data = dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)

    # the reference's step-0 parameters as the port's step-0 checkpoint
    rstate = r_loop.init_state(rcfg, rtc, mesh, SEQ)
    init = p_loop.init_state(cfg, ptc, "cpu", SEQ)
    init.params = lm_params_from_reference(
        jax.tree.map(np.asarray, rstate.params), cfg, device="cpu")
    ckpt.save(ptc.ckpt_dir, 0, p_loop.checkpoint_tree(init),
              extra={"next_step": 0})

    capsys.readouterr()
    rh = r_loop.train(rcfg, rtc, mesh, r_data.batches(
        r_data.LMDataConfig(**data)), max_len=SEQ,
        injector=RFaultInjector(fail_at=fail_at) if fail_at else None)
    r_resumed = [int(s) for s in re.findall(r"\[ckpt\] resumed at step "
                                            r"(\d+)",
                                            capsys.readouterr().out)]
    grid = p_mesh.make_smoke_mesh(1, model=1, device_type="cpu")
    ph = p_loop.train(cfg, ptc, grid, p_data.batches(
        p_data.LMDataConfig(**data)), max_len=SEQ,
        injector=FaultInjector(fail_at=fail_at) if fail_at else None)
    p_resumed = [int(s) for s in re.findall(r"\[ckpt\] resumed at step "
                                            r"(\d+)",
                                            capsys.readouterr().out)]
    return rh, r_resumed, ph, p_resumed


@pytest.mark.parametrize("tc_kw", [dict(optimizer="adamw"),
                                   dict(optimizer="adafactor"),
                                   dict(optimizer="adamw",
                                        grad_compression="int8")],
                         ids=["adamw", "adafactor", "int8"])
def test_loss_history_matches_the_reference(tmp_path, capsys, tc_kw):
    rh, r_resumed, ph, p_resumed = run_both(tmp_path, capsys, **tc_kw)
    assert r_resumed == [] and p_resumed == [0]    # the written step 0
    assert len(ph["loss"]) == len(rh["loss"]) == STEPS
    np.testing.assert_allclose(ph["loss"], rh["loss"], rtol=RTOL, atol=ATOL)
    assert ph["restarts"] == rh["restarts"] == 0
    state = ph["state"]
    assert state.step == STEPS and state.opt_state.step == STEPS
    assert sorted(ckpt.committed_steps(tmp_path / "port")) == [0, 3, 6]


def test_fault_injection_restarts_as_the_reference(tmp_path, capsys):
    rh, r_resumed, ph, p_resumed = run_both(
        tmp_path, capsys, fail_at=(2, 5), grad_compression="int8")
    assert ph["restarts"] == rh["restarts"] == 2
    # the failure at step 2 comes before the first checkpoint: the
    # reference starts afresh from its seed, the port from the written
    # step 0 (the same parameters); the one at step 5 resumes both at 3
    assert r_resumed == [3] and p_resumed == [0, 0, 3]
    # steps 0-1 and 3-4 ran twice, on fresh batches (the iterator is not
    # rewound)
    assert len(ph["loss"]) == len(rh["loss"]) == 12
    np.testing.assert_allclose(ph["loss"], rh["loss"], rtol=RTOL, atol=ATOL)


def test_multi_device_arguments_are_refused():
    """A grid of more entries than the started world (here: none) is
    refused, since the loop runs one process per entry; `fsdp` and
    `use_ep` on one device train as the single-device loop (nothing to
    shard; EP over one shard is the dense dispatch)."""
    cfg = ModelConfig(**TINY)
    grid = p_mesh.make_smoke_mesh(2, model=1, device_type="cpu")
    with pytest.raises(RuntimeError, match="one process per entry"):
        p_loop.make_step(cfg, p_loop.TrainConfig(), grid)
    base = p_loop.init_state(cfg, p_loop.TrainConfig(), "cpu", SEQ)
    for kw in (dict(fsdp=True), dict(use_ep=True)):
        st = p_loop.init_state(cfg, p_loop.TrainConfig(**kw), "cpu", SEQ)
        for (n, p), q in zip(st.params.named_parameters(),
                             base.params.parameters()):
            assert not hasattr(p, "device_mesh"), n
            torch.testing.assert_close(p, q, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny"])
def test_cli_trains_the_smoke_config(tmp_path, capsys, arch):
    hist = p_launch.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "4", "--seq", "16", "--batch", "2",
                          "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert f"final loss {hist['loss'][-1]:.4f}" in out and "restarts=0" in out
    assert all(np.isfinite(hist["loss"])) and len(hist["loss"]) == 4
    assert ckpt.latest_step(tmp_path) == 4


def test_cli_rerun_on_a_finished_checkpoint_trains_nothing(tmp_path, capsys):
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--steps", "2", "--seq", "16", "--batch", "2",
            "--ckpt", str(tmp_path)]
    p_launch.main(args)
    capsys.readouterr()
    hist = p_launch.main(args)
    out = capsys.readouterr().out
    assert hist["loss"] == [] and hist["restarts"] == 0
    assert "[ckpt] resumed at step 2" in out
    assert (f"nothing to train: the checkpoint in {tmp_path} is already at "
            f"step 2 of --steps 2") in out


def _example(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm_pretrain_example_runs_small(tmp_path, capsys):
    hist = _example("torch_lm_pretrain").main([
        "--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
        "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "params ~= " in out and "over 2 steps" in out
    assert all(np.isfinite(hist["loss"]))


def test_fault_tolerant_example_survives_its_failure(tmp_path, capsys):
    hist = _example("torch_fault_tolerant_train").main([
        "--device", "cpu", "--steps", "20", "--ckpt", str(tmp_path / "ft")])
    out = capsys.readouterr().out
    assert hist["restarts"] == 1          # the failure at step 17
    assert "survived 1 node failures" in out
    assert "checkpoint of step 20 restored bitwise" in out
