"""Mixture-of-Experts with sort-based capacity dispatch (counterpart of
`repro.models.moe`, single-shard path).

`moe_apply`: sort token-expert pairs by expert, pack per-expert capacity
buffers by gather (no one-hot dispatch tensors), run all experts as one
batched product, combine by gathering each pair's output back.

Capacity: one buffer of C = ceil(cf * T * k / E) slots (rounded up to 8)
per expert; overflow drops (standard MoE contract), and the gate
normalization keeps dropped tokens' residual path intact. DeepSeek-style
shared experts run densely on every token. The expert-parallel path of the
reference (`moe_apply_ep`, an all_to_all over the model axis) belongs to
the distribution slice and is not here.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _dtype, _normal


class SharedExperts(nn.Module):
    """The dense SwiGLU of the shared experts (width moe_d_ff * n)."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, fs, dt = cfg.d_model, cfg.moe_d_ff * cfg.n_shared_experts, \
            _dtype(cfg)
        self.wg = _normal(g, (d, fs), dt)
        self.wu = _normal(g, (d, fs), dt)
        self.wd = _normal(g, (fs, d), dt)


class MoE(nn.Module):
    """Router (float32) and the stacked expert weights (`moe_init`)."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, f, E, dt = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, _dtype(cfg)
        self.router = _normal(g, (d, E), torch.float32)
        self.wg = _normal(g, (E, d, f), dt)
        self.wu = _normal(g, (E, d, f), dt)
        self.wd = _normal(g, (E, f, d), dt)
        if cfg.n_shared_experts:
            self.shared = SharedExperts(cfg, g)

    def forward(self, x: torch.Tensor,
                capacity: Optional[int] = None) -> torch.Tensor:
        return moe_apply(self, x, self.cfg, capacity)


def moe_init(cfg: ModelConfig, g: torch.Generator) -> MoE:
    return MoE(cfg, g)


def _gate(router_w: torch.Tensor, x: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (gates (T,k) f32 normalized, ids (T,k) int64).

    Top-k by a stable descending sort, so equal probabilities go to the
    lower expert id first, as `lax.top_k` breaks ties."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids


def _pack_dispatch(x: torch.Tensor, ids: torch.Tensor, n_experts: int,
                   capacity: int):
    """Sort-based capacity packing (no one-hot dispatch tensor).

    x: (T, d); ids: (T, k) expert per pair. Returns:
      buf       (E, C, d): per-expert token buffers (zero-padded)
      pair_slot (T*k,)   : flat buffer slot of each pair (-1 if dropped)
    """
    T, k = ids.shape
    dev = x.device
    flat_e = ids.reshape(-1).long()                      # (T*k,)
    pair_tok = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)           # expert-major
    e_s = flat_e[order]
    tok_s = pair_tok[order]
    cnt = torch.bincount(e_s, minlength=n_experts)
    offset = torch.cumsum(cnt, 0) - cnt
    rank = torch.arange(T * k, device=dev) - offset[e_s]
    kept = rank < capacity
    # each kept pair owns a unique slot; dropped pairs write a spare row
    # past the buffers, which is cut off (no collision decides a value)
    spare = n_experts * capacity
    slot_s = torch.where(kept, e_s * capacity + rank, spare)
    buf = torch.zeros((spare + 1, x.shape[1]), dtype=x.dtype, device=dev)
    buf[slot_s] = x[tok_s]
    pair_slot = torch.empty(T * k, dtype=torch.long, device=dev)
    pair_slot[order] = torch.where(kept, slot_s, -1)
    return buf[:spare].reshape(n_experts, capacity, x.shape[1]), pair_slot


def _expert_ffn(wg, wu, wd, buf):
    """buf: (E, C, d) -> (E, C, d), batched over experts."""
    return torch.bmm(F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu), wd)


def _combine(out_buf: torch.Tensor, pair_slot: torch.Tensor,
             gates: torch.Tensor, T: int) -> torch.Tensor:
    """Gather expert outputs back to tokens and weight by gates."""
    E, C, d = out_buf.shape
    flat = out_buf.reshape(E * C, d)
    safe = torch.clamp(pair_slot, 0, E * C - 1)
    vals = torch.where((pair_slot >= 0)[:, None], flat[safe],
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    k = pair_slot.shape[0] // T
    vals = vals * gates.reshape(-1)[:, None].to(vals.dtype)
    return vals.reshape(T, k, d).sum(dim=1)


def capacity_of(cfg: ModelConfig, tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * tokens
                      * cfg.experts_per_token / cfg.n_experts))
    return max(8, -(-c // 8) * 8)   # pad to 8, as the reference does


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              capacity: Optional[int] = None) -> torch.Tensor:
    """Single-shard MoE on (B, S, d)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T = B * S
    cap = capacity or capacity_of(cfg, T)
    gates, ids = _gate(p.router, xt, cfg.experts_per_token)
    buf, pair_slot = _pack_dispatch(xt, ids, cfg.n_experts, cap)
    out_buf = _expert_ffn(p.wg, p.wu, p.wd, buf)
    out = _combine(out_buf, pair_slot, gates, T)
    if cfg.n_shared_experts:
        sh = p.shared
        out = out + (F.silu(xt @ sh.wg) * (xt @ sh.wu)) @ sh.wd
    return out.reshape(B, S, d).to(x.dtype)
