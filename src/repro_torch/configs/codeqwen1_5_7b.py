"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32, i.e. MHA)
d_ff=13440 vocab=92416 — qwen1.5-arch with attention bias.
[hf:Qwen/CodeQwen1.5-7B; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    block_pattern=("attn",),
    rope_theta=1e6,
    qkv_bias=True,
    ffn_kind="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=256, dtype="float32")
