"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H d_ff=12288
vocab=256000 — Griffin: RG-LRU recurrent blocks + local attention, 2:1
pattern, window 2048. MQA (kv=1) for the attention layers. Sub-quadratic
decode state -> runs long_500k. [arXiv:2402.19427; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    local_window=2048,
    rnn_kind="rglru",
    conv1d_width=4,
    ffn_kind="gelu",
    supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=160,
    vocab_size=256, local_window=32, dtype="float32")
