"""Training launcher CLI (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 50 --seq 256 --batch 8 --smoke [--device cpu]

`--smoke` uses the arch's reduced config; without it the published config
is trained at full width. It runs on one device: the card unless
`--device` names another (`cpu`).
"""
from __future__ import annotations

import argparse


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
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.train.loop import TrainConfig, train

    cfg = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt,
                     ckpt_every=max(args.steps // 4, 1), lr=args.lr,
                     grad_compression=args.grad_compression,
                     microbatch=args.microbatch)
    extra = None
    if cfg.family == "vlm" or cfg.is_enc_dec:
        extra = {"cross_source": np.zeros(
            (args.batch, cfg.cross_source_len, cfg.d_model), np.float32)}
    hist = train(cfg, tc, args.device, batches(data), max_len=args.seq,
                 extra_batch=extra)
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
