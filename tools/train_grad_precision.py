"""How far a bf16 model's gradient of its token table lies from an f32
copy's, on one CUDA card, and what moves it.

    python3 tools/train_grad_precision.py [--arch llama3.2-1b] [--steps 6]
        [--seq 1024] [--batch 8] [--microbatch 2] [--device cuda]

Trains the arch's published config (bf16) from seed 0 for `--steps` steps
through `train.loop.train` (AdamW, remat "full", as `chip_smoke.py`
[train] does), copies its parameters into an f32 model, and takes the
gradient of the token table (the unembedding for an untied config) on the
first batch of `data/lm.py::batches(seed=0)` through `loss_and_grads`. It
prints the relative L2 difference and the cosine between the bf16 and the
f32 gradient for three variants of the bf16 model:

- as shipped: the lookup is `F.embedding`, and `_F32Product`'s backward
  rounds the incoming f32 gradient to bf16;
- the lookup as advanced indexing (`table[tokens]`), whose backward adds a
  token's repeats into the bf16 table one rounding at a time;
- `_F32Product`'s backward keeping the f32 gradient (the other factor
  widened, products in f32).

The f32 model runs as shipped throughout. It runs on the card unless
`--device` names another (on the CPU `_F32Product` is not used, so the
first and third variants agree). Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _index_lookup(self, tokens):
    return self.table[tokens]


def _f32_cotangent(ctx, grad):
    x, w = ctx.saved_tensors
    return ((grad @ w.float().T).to(x.dtype),
            (x.float().T @ grad).to(w.dtype))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data import lm as lm_data
    from repro_torch.models import layers, loss_and_grads
    from repro_torch.models import transformer as tt
    from repro_torch.device import resolve
    from repro_torch.train import loop

    dev = resolve(args.device)
    card = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    data = lm_data.LMDataConfig(cfg.vocab_size, args.seq, args.batch, seed=0)
    empty = tempfile.mkdtemp()       # no checkpoint to resume from
    tc = loop.TrainConfig(steps=args.steps, ckpt_dir=empty, ckpt_every=0,
                          log_every=0, seed=0, microbatch=args.microbatch)
    hist = loop.train(cfg, tc, dev, lm_data.batches(data), max_len=args.seq)
    os.rmdir(empty)
    model = hist.pop("state").params
    print(f"{cfg.name} {cfg.dtype}: trained {args.steps} steps, losses "
          f"{[round(x, 4) for x in hist['loss']]}")
    f32 = tt.Transformer(dataclasses.replace(cfg, dtype="float32"), None,
                         0).to_empty(device=dev)
    f32.load_state_dict({k: v.float() for k, v in
                         model.state_dict().items()})
    toks, labels = next(lm_data.batches(data))
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
    name = "embed.table" if cfg.tie_embeddings else "lm_head.w"
    top = int(torch.bincount(batch["tokens"].flatten().long()).max())

    def table_grad(m):
        loss, grads = loss_and_grads(m, batch, microbatch=args.microbatch)
        return float(loss), grads[name].float()

    lf, gf = table_grad(f32)
    del f32
    print(f"gradient of {name} {tuple(gf.shape)} on one {args.batch} x "
          f"{args.seq} batch (its most frequent token {top} times), bf16 "
          f"against the f32 copy (loss {lf:.6f}); on {card}")
    lookup = layers.Embedding.forward
    backward = vars(layers._F32Product)["backward"]
    variants = (("as shipped", lookup, backward),
                ("lookup by advanced indexing", _index_lookup, backward),
                ("f32 cotangent in _F32Product", lookup,
                 staticmethod(_f32_cotangent)))
    for what, fwd, bwd in variants:
        layers.Embedding.forward, layers._F32Product.backward = fwd, bwd
        try:
            lb, gb = table_grad(model)
        finally:
            layers.Embedding.forward = lookup
            layers._F32Product.backward = backward
        rel = float((gb - gf).norm() / gf.norm())
        cos = float((gb * gf).sum() / (gb.norm() * gf.norm()))
        print(f"  {what:30s} loss {lb:.6f}  relative L2 {rel:.4e}  cosine "
              f"{cos:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
