"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer; vision frontend is
a stub (input_specs supplies precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    rope_theta=5e5,
    cross_source_len=1601,     # 1 tile x (40x40 patches + cls)
    ffn_kind="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=256, cross_source_len=16, dtype="float32")
