"""Model configuration for the assigned LM-family architectures
(counterpart of `repro.models.config`, kept as the port's own copy).

One frozen dataclass covers all 10 assigned archs (dense / GQA / MoE /
SSM / hybrid / enc-dec / VLM-backbone); per-arch instances live in
src/repro_torch/configs/<id>.py.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // n_heads

    # layer pattern, cycled across depth (after first_dense_layers):
    #   "attn" | "cross" | "local" | "moe" | "mlstm" | "slstm" | "rglru"
    block_pattern: Tuple[str, ...] = ("attn",)

    # attention
    rope_theta: float = 1e4
    rope_fraction: float = 1.0     # chatglm applies RoPE to half the dims
    qkv_bias: bool = False         # qwen-style attention bias
    local_window: int = 0          # sliding-window size for "local" blocks
    cross_source_len: int = 0      # stub frontend seq len (vlm patches /
                                   # whisper audio frames)
    pos_embedding: str = "rope"    # rope | learned | none
    attn_q_chunk: int = 0          # >0: query-chunked attention (never
                                   # materialize Sq x Sk scores) — §Perf

    # ffn
    ffn_kind: str = "swiglu"       # swiglu | gelu

    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # leading dense-FFN layers (deepseek/kimi)
    capacity_factor: float = 1.25

    # encoder-decoder (whisper): decoder uses n_layers/block_pattern above
    encoder_layers: int = 0
    encoder_is_causal: bool = False

    # recurrent
    rnn_kind: str = ""             # informational; block_pattern drives use
    conv1d_width: int = 4          # recurrentgemma temporal conv width
    rnn_width: int = 0             # 0 -> d_model (RG-LRU lane width)

    # misc
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    # shape applicability
    supports_long_context: bool = False   # sub-quadratic decode state
    has_decoder: bool = True              # encoder-only archs: False

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Concrete kind of every decoder layer."""
        kinds = []
        for i in range(self.n_layers):
            if i < self.first_dense_layers:
                kinds.append("attn_dense")   # attn + dense FFN (MoE archs)
            else:
                kinds.append(
                    self.block_pattern[(i - self.first_dense_layers)
                                       % len(self.block_pattern)])
        return tuple(kinds)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    # ---- parameter counting (for MODEL_FLOPS = 6*N*D roofline terms) ----
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.ffn_kind == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _rnn_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "mlstm":
            # q,k,v projections + out + gates
            return 4 * d * d + 2 * d
        if kind == "slstm":
            dh = d // self.n_heads
            return 4 * d * d + 4 * self.n_heads * dh * dh + 2 * d
        if kind == "rglru":
            dr = self.rnn_width or d
            # in/out proj + gates + conv1d + lru params + gate branch
            return 2 * d * dr + 2 * dr * dr // max(self.n_heads, 1) \
                + self.conv1d_width * dr + 2 * dr + self._ffn_params(self.d_ff)
        return 0

    def param_count(self) -> int:
        """Approximate total parameters (embeddings included once)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for kind in self.layer_kinds:
            if kind in ("attn", "attn_dense", "local"):
                total += self._attn_params()
                total += self._ffn_params(self.d_ff if kind != "moe"
                                          else self.moe_d_ff)
            elif kind == "cross":
                total += 2 * self._attn_params()   # self + cross
                total += self._ffn_params(self.d_ff)
            elif kind == "moe":
                total += self._attn_params()
                total += self.n_experts * self._ffn_params(self.moe_d_ff)
                total += self.n_shared_experts * self._ffn_params(
                    self.moe_d_ff)
                total += self.d_model * self.n_experts   # router
            elif kind in ("mlstm", "slstm", "rglru"):
                total += self._rnn_params(kind)
                if self.d_ff and kind == "rglru":
                    pass   # ffn counted inside _rnn_params for rglru
        if self.is_enc_dec:
            total += self.encoder_layers * (self._attn_params()
                                            + self._ffn_params(self.d_ff))
            # decoder cross-attention per layer
            total += self.n_layers * self._attn_params()
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        for kind in self.layer_kinds:
            total += self._attn_params()
            if kind == "moe":
                total += (self.experts_per_token + self.n_shared_experts) \
                    * self._ffn_params(self.moe_d_ff)
                total += self.d_model * self.n_experts
            else:
                total += self._ffn_params(self.d_ff)
        return total
