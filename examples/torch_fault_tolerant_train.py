"""Chaos demo on the PyTorch/CUDA port: the training loop surviving
injected node failures and stragglers. Failures trigger
checkpoint-restore restarts; stragglers are detected by the z-score
monitor. At the end the latest checkpoint is restored and must equal the
final parameters and optimizer state bit for bit.

    PYTHONPATH=src python examples/torch_fault_tolerant_train.py
    PYTHONPATH=src python examples/torch_fault_tolerant_train.py \
        --device cpu --steps 40

Defaults are the reference example's (`examples/fault_tolerant_train.py`):
60 steps, failures injected at steps 17 and 35, on the card unless
`--device` names another. Every failure inside `--steps` must be survived.
"""
import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.data.lm import LMDataConfig, batches  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train.ft import FaultInjector  # noqa: E402
from repro_torch.train.loop import (TrainConfig, checkpoint_tree,  # noqa: E402
                                    train)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt", default="checkpoints/ft_demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="demo-ft", family="dense", n_layers=4,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
                      vocab_size=4096, block_pattern=("attn",),
                      dtype="float32")
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                        global_batch=8)

    shutil.rmtree(args.ckpt, ignore_errors=True)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=10,
                     log_every=10, lr=1e-3, grad_compression="int8")

    injector = FaultInjector(fail_at=(17, 35), straggle_at=(25, 26, 27),
                             straggle_s=0.4)
    hist = train(cfg, tc, args.device, batches(data), max_len=data.seq_len,
                 injector=injector)

    print(f"\nsurvived {hist['restarts']} node failures "
          f"(resumed from checkpoints)")
    print(f"stragglers detected at steps: {hist['stragglers']}")
    print(f"re-mesh requests: {hist['remesh_requests']}")
    print(f"final loss: {hist['loss'][-1]:.3f} (start {hist['loss'][0]:.3f})")
    assert hist["restarts"] == sum(s < args.steps for s in injector.fail_at)

    # the last checkpoint holds the final state when it fell on the last step
    state = hist["state"]
    if ckpt_lib.latest_step(args.ckpt) == state.step:
        saved = checkpoint_tree(state)
        back, extra = ckpt_lib.restore(args.ckpt, saved,
                                       device=state.params.embed.table.device)
        assert extra["next_step"] == state.step
        same = all(torch.equal(back["params"][n], p)
                   for n, p in saved["params"].items()) and all(
            torch.equal(back["opt_state"][i][k], v)
            for i in (1, 2) for k, v in saved["opt_state"][i].items()) \
            and back["opt_state"].step == saved["opt_state"].step
        assert same, "the restored checkpoint differs from the final state"
        print(f"checkpoint of step {state.step} restored bitwise")
    return hist


if __name__ == "__main__":
    main()
