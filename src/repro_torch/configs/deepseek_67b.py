"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch. [arXiv:2401.02954; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    block_pattern=("attn",),
    ffn_kind="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab_size=256, dtype="float32")
