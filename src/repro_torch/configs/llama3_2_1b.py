"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3, tied embeddings, head_dim 64.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    block_pattern=("attn",),
    rope_theta=5e5,
    tie_embeddings=True,
    ffn_kind="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=256, head_dim=16, dtype="float32")
