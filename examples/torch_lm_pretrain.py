"""End-to-end run on the PyTorch/CUDA port: pretrain a ~100M-param
llama-style model on the synthetic token pipeline, with checkpointing and
fault-tolerant resume.

    PYTHONPATH=src python examples/torch_lm_pretrain.py [--steps 300]
    PYTHONPATH=src python examples/torch_lm_pretrain.py --device cpu \
        --steps 2 --seq 16 --batch 2

Defaults are the reference example's (`examples/lm_pretrain.py`): 300
steps of 8 x 256 tokens, on the card unless `--device` names another.
`--seq` and `--batch` shrink the run.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.data.lm import LMDataConfig, batches  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default="checkpoints/lm_pretrain")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)

    # ~100M params: 12L, d=512, llama-style
    cfg = ModelConfig(name="demo-100m", family="dense", n_layers=12,
                      d_model=512, n_heads=8, n_kv_heads=4, d_ff=1536,
                      vocab_size=32768, block_pattern=("attn",),
                      ffn_kind="swiglu", dtype="float32")
    print(f"params ~= {cfg.param_count() / 1e6:.1f}M")

    data = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch, seed=0)
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=50,
                     log_every=10, lr=6e-4)

    hist = train(cfg, tc, args.device, batches(data), max_len=data.seq_len)
    if not hist["loss"]:
        print(f"nothing to train: the checkpoint in {args.ckpt} is already "
              f"at step {hist['state'].step} of --steps {args.steps}")
        return hist
    first = sum(hist["loss"][:10]) / len(hist["loss"][:10])
    last = sum(hist["loss"][-10:]) / len(hist["loss"][-10:])
    print(f"\nloss {first:.3f} -> {last:.3f} over {len(hist['loss'])} "
          f"steps ({'improved' if last < first else 'NOT improved'})")
    return hist


if __name__ == "__main__":
    main()
