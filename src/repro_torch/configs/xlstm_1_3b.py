"""xlstm-1.3b [ssm]: 48L d_model=2048 4H vocab=50304, d_ff=0 — alternating
sLSTM + mLSTM blocks (no separate FFN; the cells carry the capacity).
Sub-quadratic decode state -> runs long_500k. [arXiv:2405.04517;
unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    rnn_kind="xlstm",
    pos_embedding="none",       # recurrence encodes order
    supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    vocab_size=256, dtype="float32")
