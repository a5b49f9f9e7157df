"""Mixture-of-Experts with sort-based capacity dispatch (counterpart of
`repro.models.moe`, single-shard path).

`moe_apply`: sort token-expert pairs by expert, pack per-expert capacity
buffers by gather (no one-hot dispatch tensors), run all experts as one
batched product, combine by gathering each pair's output back.

Capacity: one buffer of C = ceil(cf * T * k / E) slots (rounded up to 8)
per expert; overflow drops (standard MoE contract), and the gate
normalization keeps dropped tokens' residual path intact. DeepSeek-style
shared experts run densely on every token.

`moe_apply_ep` is the expert-parallel path over a `DeviceMesh`, one
process per rank: tokens are sharded over (dp..., "model"), each rank packs
per-GLOBAL-expert buffers of its own tokens, an all_to_all over the model
axis routes them to the rank that owns the experts, the local experts run,
a reverse all_to_all brings the outputs back and each rank combines its
own tokens. Capacity is per (source rank, expert) buffer:
C = ceil(cf * T_local * k / E).

On DTensor inputs without EP, `moe_apply` runs on the whole (replicated)
batch and weights: its sort, search and scatters have no DTensor
sharding rules, and the reference's semantics are global (one dispatch
over every token, capacity from the global count).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _dtype, _normal, is_dtensor, settle


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
    # first sorted pair of each expert (static shape, unlike a bincount,
    # so fake tensors can run it)
    offset = torch.searchsorted(e_s, torch.arange(n_experts, device=dev))
    rank = torch.arange(T * k, device=dev) - offset[e_s]
    kept = rank < capacity
    # each kept pair owns a unique slot; dropped pairs write a spare row
    # past the buffers, which is cut off (no collision decides a value).
    # The rows are gathered by `F.embedding`, whose backward sums a token's
    # k pairs in float32 in a fixed order and rounds once; advanced
    # indexing's would add them into a bf16 gradient one rounding at a
    # time, in whatever order the card's atomics take
    spare = n_experts * capacity
    slot_s = torch.where(kept, e_s * capacity + rank, spare)
    buf = torch.zeros((spare + 1, x.shape[1]), dtype=x.dtype, device=dev)
    buf[slot_s] = F.embedding(tok_s, x)
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


def _replicated_local(t: torch.Tensor) -> torch.Tensor:
    """The whole of DTensor `t`, gathered onto every rank, as a local
    tensor; every rank computes the same from it, so its gradient is
    replicated too."""
    from torch.distributed.tensor import Replicate
    return t.redistribute(
        placements=[Replicate()] * t.device_mesh.ndim).to_local()


def _moe_replicated(p: MoE, x, cfg: ModelConfig, capacity: Optional[int]):
    """`moe_apply` of a DTensor batch: gathered, computed whole on every
    rank, handed back with `x`'s placements (a local slice)."""
    from types import SimpleNamespace

    from torch.distributed.tensor import DTensor, Replicate
    x = settle(x)           # a pending sum cannot be handed back as one
    mesh = x.device_mesh
    local = {n: _replicated_local(t) for n, t in p.named_parameters()}
    params = SimpleNamespace(**{n: local[n] for n in
                                ("router", "wg", "wu", "wd")})
    if cfg.n_shared_experts:
        params.shared = SimpleNamespace(**{n: local[f"shared.{n}"]
                                           for n in ("wg", "wu", "wd")})
    out = moe_apply(params, _replicated_local(x), cfg, capacity)
    out = DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return out.redistribute(placements=x.placements)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig,
              capacity: Optional[int] = None) -> torch.Tensor:
    """Single-shard MoE on (B, S, d)."""
    if is_dtensor(x):
        return _moe_replicated(p, x, cfg, capacity)
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


# ----------------------------------------------------------------------
# expert-parallel path (an all_to_all over the `model` mesh axis)
# ----------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """Equal-split all_to_all over `group` along dim 0; its own inverse,
    so the backward is the same exchange of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()      # before empty_like, which keeps strides
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


def moe_apply_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig, mesh,
                 ep_axis: str = "model",
                 dp_axes: Tuple[str, ...] = ("data",),
                 capacity: Optional[int] = None,
                 fsdp_axis: Optional[str] = None) -> torch.Tensor:
    """Expert-parallel MoE of DTensor `x` (B, S, d) over DeviceMesh
    `mesh`: tokens sharded over (dp_axes..., ep_axis) on the flattened
    token axis, experts over `ep_axis`. The parameters are `p`'s DTensors,
    placed by `sharding.port_layout`; an expert weight sharded on d_model
    (FSDP, over `fsdp_axis` in the reference's signature) is gathered
    here whatever the axis, so its gradient reduce-scatters back onto it
    and is never replicated. The shared experts run outside, on the whole
    batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    names = list(mesh.mesh_dim_names)
    ep = mesh.size(names.index(ep_axis))
    E, k = cfg.n_experts, cfg.experts_per_token
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} ranks of "
                         f"{ep_axis!r}")
    E_loc = E // ep
    x = settle(x)           # a pending sum has no token shards to hand out
    B, S, d = x.shape
    tok_axes = tuple(dp_axes) + (ep_axis,)
    n_tok = math.prod(mesh.size(names.index(a)) for a in tok_axes)
    if (B * S) % n_tok:
        raise ValueError(f"{B * S} tokens do not split over {n_tok} ranks")
    T_loc = B * S // n_tok
    cap = capacity or capacity_of(cfg, T_loc)

    # tokens: the flattened axis sharded over (dp..., ep) in mesh order
    tok_pl = [Shard(0) if a in tok_axes else Replicate() for a in names]
    # a rank's gradient of a replicated weight covers its own tokens only
    part_pl = [Partial() if a in tok_axes else Replicate() for a in names]
    x_flat = x.reshape(B * S, d)
    xt = x_flat.redistribute(placements=tok_pl).to_local()
    router = p.router.redistribute(
        placements=[Replicate()] * len(names)).to_local(
        grad_placements=part_pl)

    def experts(w):
        # own experts (Shard(0) on ep), whole d_model (gathered over the
        # fsdp axis); the gradient is this rank's experts, summed over the
        # token shards of the data axes
        pl = [Shard(0) if a == ep_axis else Replicate() for a in names]
        gpl = [Shard(0) if a == ep_axis else
               Partial() if a in tok_axes else Replicate() for a in names]
        return w.redistribute(placements=pl).to_local(grad_placements=gpl)

    wg, wu, wd = experts(p.wg), experts(p.wu), experts(p.wd)
    group = mesh.get_group(names.index(ep_axis))

    gates, ids = _gate(router, xt, k)
    buf, pair_slot = _pack_dispatch(xt, ids, E, cap)        # (E, cap, d)
    # (ep, E_loc, cap, d): block r goes to rank r of the ep group, which
    # then holds its E_loc experts' tokens from every source rank
    recv = _AllToAll.apply(buf.reshape(ep, E_loc, cap, d), group)
    recv = recv.transpose(0, 1).reshape(E_loc, ep * cap, d)
    out_loc = _expert_ffn(wg, wu, wd, recv)
    out_loc = out_loc.reshape(E_loc, ep, cap, d).transpose(0, 1)
    back = _AllToAll.apply(out_loc, group)                  # global order
    out = _combine(back.reshape(E, cap, d), pair_slot, gates, T_loc)
    out = DTensor.from_local(out, mesh, tok_pl, run_check=False)
    out = out.redistribute(placements=x_flat.placements)
    if cfg.n_shared_experts:     # on the flattened tokens, as `moe_apply`
        sh = p.shared
        out = out + (F.silu(x_flat @ sh.wg) * (x_flat @ sh.wu)) @ sh.wd
    return out.reshape(B, S, d).to(x.dtype)
