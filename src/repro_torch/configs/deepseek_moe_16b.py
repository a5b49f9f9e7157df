"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained; first layer
dense (d_ff=10944). [arXiv:2401.06066; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                 # the single dense layer's FFN
    vocab_size=102400,
    block_pattern=("moe",),
    first_dense_layers=1,
    n_experts=64,
    n_shared_experts=2,
    experts_per_token=6,
    moe_d_ff=1408,
    ffn_kind="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=256, n_experts=8, experts_per_token=2, n_shared_experts=1,
    moe_d_ff=32, dtype="float32")
