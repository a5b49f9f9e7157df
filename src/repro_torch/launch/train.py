"""Training launcher CLI (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 50 --seq 256 --batch 8 --smoke [--device cpu]

`--smoke` uses the arch's reduced config; without it the published config
is trained at full width. Run alone it is a world of one process: it
trains on one device, the card unless `--device` names another (`cpu`).
Under `torchrun` it trains data-parallel over the ranks it was started
with, as the reference trains over `make_smoke_mesh(model=1)`: a
("data", "model") grid of (N, 1), one card per rank (`--device cpu`: gloo
ranks on the CPU), with `--fsdp` to shard the parameters over "data":

    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \
        --arch llama3.2-1b --smoke --steps 8
"""
from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="checkpoints/train_cli")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default: the card)")
    ap.add_argument("--fsdp", action="store_true",
                    help="under torchrun: shard the parameters over data")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default: steps / 4; "
                         "0: none)")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.train.loop import TrainConfig, train

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    mesh, rank = args.device, 0
    if "WORLD_SIZE" in os.environ:            # started by torchrun
        from repro_torch.launch.mesh import init_distributed, make_mesh
        cpu = torch.device(args.device).type == "cpu"
        rank, world = init_distributed("gloo" if cpu else "nccl")
        devices = ["cpu"] * world if cpu else \
            [f"cuda:{i}" for i in range(world)]
        mesh = make_mesh((world, 1), ("data", "model"), devices)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt,
                     ckpt_every=max(args.steps // 4, 1)
                     if args.ckpt_every is None else args.ckpt_every,
                     lr=args.lr,
                     grad_compression=args.grad_compression,
                     microbatch=args.microbatch, fsdp=args.fsdp,
                     log_every=10 if rank == 0 else 0)
    extra = None
    if cfg.family == "vlm" or cfg.is_enc_dec:
        extra = {"cross_source": np.zeros(
            (args.batch, cfg.cross_source_len, cfg.d_model), np.float32)}
    try:
        hist = train(cfg, tc, mesh, batches(data), max_len=args.seq,
                     extra_batch=extra)
    finally:
        if mesh is not args.device:
            torch.distributed.destroy_process_group()
    if rank:
        return hist
    if not hist["loss"]:
        print(f"nothing to train: the checkpoint in {args.ckpt} is already "
              f"at step {hist['state'].step} of --steps {args.steps}")
        return hist
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(start {hist['loss'][0]:.4f}), "
          f"restarts={hist['restarts']}")
    return hist


if __name__ == "__main__":
    main()
