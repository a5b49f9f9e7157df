"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 routed top-8 + 1 shared, first layer dense
(d_ff=18432) — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18432,                 # first dense layer
    vocab_size=163840,
    block_pattern=("moe",),
    first_dense_layers=1,
    n_experts=384,
    n_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    ffn_kind="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
    vocab_size=256, n_experts=16, experts_per_token=4, n_shared_experts=1,
    moe_d_ff=32, dtype="float32")
