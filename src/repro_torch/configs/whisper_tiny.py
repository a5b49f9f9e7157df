"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 —
enc-dec; conv/audio frontend is a stub (input_specs supplies precomputed
frame embeddings, 1500 frames = 30 s). [arXiv:2212.04356; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                  # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=("cross",),    # every decoder layer has cross-attn
    encoder_layers=4,
    cross_source_len=1500,
    ffn_kind="gelu",
    norm_kind="layernorm",
    pos_embedding="learned",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=256, cross_source_len=24,
    dtype="float32")
