"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2d RoPE (rotary on half the head dims), strong GQA.
[arXiv:2406.12793; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    block_pattern=("attn",),
    rope_fraction=0.5,          # chatglm 2d rope
    qkv_bias=True,
    ffn_kind="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab_size=256, dtype="float32")
