"""Transformer building blocks (counterpart of `repro.models.layers`):
norms, embeddings, RoPE, GQA / cross / sliding-window attention, gated
FFNs.

Each parameterized piece is an `nn.Module` whose parameter names are the
reference's pytree keys (`wq`, `wk`, ..., `scale`, `table`), so
`repro_torch.convert.lm_params_from_reference` maps a JAX parameter tree
onto the modules by path. Projections are stored as 2-D matrices: the
reference's `wq` of shape (d, H, hd) is the port's (d, H*hd) and `wo`
(H, hd, d) is (H*hd, d) — the same numbers in row-major order.

Parameters are drawn from an explicit `torch.Generator` on the generator's
device (N(0, 1) * 0.02 in float32, then cast to the config's dtype, as the
reference draws them); with no generator they are built on the meta device
(shapes and dtypes only, nothing allocated). Every parameter is trainable,
as every leaf of the reference's tree is; the serving entry points run
under `torch.inference_mode()`.

KV caches are dicts of tensors plus the write position `idx`, a Python
int. `attention_apply` writes the new keys and values into the cache's
buffers in place and advances `idx`.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

Cache = Dict[str, object]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _normal(g: Optional[torch.Generator], shape, dtype, std: float = 0.02
            ) -> nn.Parameter:
    """N(0, 1) * std drawn in float32 on the generator's device, cast; on
    the meta device without a generator."""
    if g is None:
        return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))
    w = torch.randn(shape, generator=g, device=g.device) * std
    return nn.Parameter(w.to(dtype))


def _const(shape, value: float, dtype, g: Optional[torch.Generator]
           ) -> nn.Parameter:
    dev = "meta" if g is None else g.device
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=dev))


class _F32Product(torch.autograd.Function):
    """x (m, k) @ w (k, n) -> (m, n) float32 from bf16 factors on the card:
    one cuBLAS product with a float32 output. The backward gives grad_x in
    x's dtype and grad_w in w's, each one product with a float32 output (so
    it accumulates in float32 whatever
    `allow_bf16_reduced_precision_reduction` says), rounded once at the end.
    The incoming float32 gradient is rounded to bf16 first, so both
    products run on the bf16 tensor cores. That rounding is deliberate: the
    reference's transposed products are float32 x bf16 einsums at the
    default precision, which the TPU runs as one bf16 pass, rounding the
    float32 operand the same way. Widening the other factor instead would
    put the unembedding's backward on float32 products, several times
    slower."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad_x = grad_w = None
        if ctx.needs_input_grad[0]:
            grad_x = torch.mm(grad.to(w.dtype), w.T,
                              out_dtype=torch.float32).to(x.dtype)
        if ctx.needs_input_grad[1]:
            grad_w = torch.mm(x.T, grad.to(x.dtype),
                              out_dtype=torch.float32).to(w.dtype)
        return grad_x, grad_w


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) with float32 products and a float32 result
    (the reference's `preferred_element_type=jnp.float32`). bf16 on the
    card: one cuBLAS product with a float32 output (`_F32Product`, which
    has a backward); elsewhere both factors are widened first (bf16
    products are exact in float32). DTensors run on their local shards
    (`_sharded_f32_product`) on any device."""
    if is_dtensor(x):
        return _sharded_f32_product(x, w)
    return _local_f32_product(x, w)


def _local_f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`f32_product` of plain tensors."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return _card_f32_product(x, w)
    return x.float() @ w.float()


def _card_f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`f32_product` of bf16 factors on the card: `_F32Product` over the
    rows of x."""
    lead = x.shape[:-1]
    out = _F32Product.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[1])


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def no_graph(module: nn.Module):
    """The context the serving entry points run `module` under:
    `torch.inference_mode()`, or `torch.no_grad()` where its parameters
    are DTensors (a view of a DTensor parameter sets a version counter,
    which inference mode refuses). Neither records a graph."""
    p = next(module.parameters(), None)
    if p is not None and is_dtensor(p):
        return torch.no_grad()
    return torch.inference_mode()


def plain(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor as a plain tensor (a collective its mesh
    joins); any other tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def seq_gathered(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation (B, S, ...) with its sequence shards gathered
    (sequence parallelism's all-gather before the column-parallel
    products): DTensor on torch 2.11 cannot flatten (B, S) for a product
    while S is sharded. Any other tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p == Shard(1) else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(placements=pl)


def settle(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with every pending (`Partial`) sum reduced, so that it is
    `Replicate` on those mesh dimensions; any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(placements=[
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def _sharded_f32_product(x, w):
    """`f32_product` of DTensors. DTensor has no sharding rule for the
    float32-output product (`aten.mm.dtype`), and on the widened factors
    its propagation may replicate the whole (tokens x vocab) product, so
    it runs on the local shards: `w` is gathered along its contracting
    dimension (the FSDP shard), its output columns stay sharded
    (vocab-parallel logits), and `x` keeps its batch shards and is
    replicated where `w`'s columns are sharded. Each local gradient is
    declared for what it is: a partial sum where the other factor's shards
    split the contraction of the backward product."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    lead = x.ndim - 1
    w_pl = [p if p == Shard(1) else Replicate() for p in w.placements]
    x_pl = [Replicate() if wp == Shard(1) or not (
        isinstance(xp, Shard) and xp.dim < lead) else xp
        for xp, wp in zip(x.placements, w_pl)]
    x_loc = x.redistribute(placements=x_pl).to_local(grad_placements=[
        Partial() if wp == Shard(1) else xp for xp, wp in zip(x_pl, w_pl)])
    w_loc = w.redistribute(placements=w_pl).to_local(grad_placements=[
        Partial() if isinstance(xp, Shard) else wp
        for xp, wp in zip(x_pl, w_pl)])
    out = _local_f32_product(x_loc, w_loc)
    shape = torch.Size((*x.shape[:-1], w.shape[1]))
    return DTensor.from_local(
        out, mesh, [Shard(lead) if wp == Shard(1) else xp
                    for xp, wp in zip(x_pl, w_pl)],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm or LayerNorm in float32 (`norm_init` / `norm_apply`)."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.scale = _const((cfg.d_model,), 1.0, torch.float32, g)
        if cfg.norm_kind == "layernorm":
            self.bias = _const((cfg.d_model,), 0.0, torch.float32, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        xf = x.float()
        if cfg.norm_kind == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = ((xf - mu) ** 2).mean(-1, keepdim=True)
            out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * self.scale \
                + self.bias
        else:
            ms = (xf * xf).mean(-1, keepdim=True)
            out = xf * torch.rsqrt(ms + cfg.norm_eps) * self.scale
        return out.to(x.dtype)


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------

class Embedding(nn.Module):
    """Token table (`embedding_init` / `embedding_apply`).

    The lookup is `F.embedding`, not `table[tokens]`: the forward is the
    same gather, but on the card the backward of advanced indexing adds a
    token's repeats into a bf16 table one rounding at a time, while
    `F.embedding`'s sums each row's repeats in float32 and rounds once. A
    frequent token repeats hundreds of times in a batch."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.table = _normal(g, (cfg.vocab_size, cfg.d_model), _dtype(cfg))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if is_dtensor(self.table):
            return _sharded_lookup(tokens, self.table)
        return F.embedding(tokens, self.table)


def _vocab_shard(mesh, placements, vocab: int):
    """(mesh dim, first id, rows) of the vocab shard that `placements`
    give this rank on dim 0 (None, 0, vocab where no dim of more than one
    rank shards it)."""
    from torch.distributed.tensor import Shard
    for i, p in enumerate(placements):
        if p == Shard(0) and mesh.size(i) > 1:
            rows = vocab // mesh.size(i)
            return i, mesh.get_local_rank(i) * rows, rows
    return None, 0, vocab


def _sharded_lookup(tokens, table):
    """`F.embedding` of a DTensor table, Megatron's vocab-parallel lookup
    on local shards: the table's d_model (FSDP) shards are gathered, its
    vocab shard kept; each rank looks up the ids in its shard (the others
    give zero rows), and a sum over the vocab's mesh dim completes every
    row. DTensor's own rule for a vocab-sharded table leaves a masked
    partial sum whose backward torch 2.11 cannot redistribute. The local
    lookup keeps `F.embedding`'s backward, which sums a token's repeats in
    float32. Returns the rows with the tokens' batch shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..sharding.comms import all_sum
    mesh = table.device_mesh
    t_pl = [p if p == Shard(0) else Replicate() for p in table.placements]
    tok_pl = [Shard(0) if p == Shard(0) and tp != Shard(0) else Replicate()
              for p, tp in zip(tokens.placements, t_pl)]
    ids = tokens.redistribute(placements=tok_pl).to_local()
    # a rank's table gradient covers its own batch rows only
    local = table.redistribute(placements=t_pl).to_local(grad_placements=[
        Partial() if p == Shard(0) else tp for p, tp in zip(tok_pl, t_pl)])
    dim, first, rows = _vocab_shard(mesh, t_pl, table.shape[0])
    if dim is None:
        out = F.embedding(ids, local)
    else:
        mine = (ids >= first) & (ids < first + rows)
        out = F.embedding(torch.where(mine, ids - first, 0), local) \
            * mine[..., None].to(local.dtype)
        out = all_sum(out, mesh.get_group(dim))
    return DTensor.from_local(out, mesh, tok_pl, run_check=False)


class LMHead(nn.Module):
    """Untied unembedding (`lm_head_init`); tied configs have none."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.w = _normal(g, (cfg.d_model, cfg.vocab_size), _dtype(cfg))


class LearnedPositions(nn.Module):
    """Learned absolute positions (`learned_pos_init`), max_len rows."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator, max_len: int):
        super().__init__()
        self.pos = _normal(g, (max_len, cfg.d_model), _dtype(cfg))


def unembed_apply(emb: Embedding, head: Optional[LMHead], x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d) -> (B, S, V) float32 logits."""
    w = emb.table.T if cfg.tie_embeddings or head is None else head.w
    return f32_product(x, w)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    """Inverse frequencies over the rotated fraction of head_dim."""
    rot = int(cfg.head_dim * cfg.rope_fraction)
    rot -= rot % 2
    ar = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (cfg.rope_theta ** (ar / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) or (S,). Rotates the first
    `rope_fraction` of Dh (chatglm-style 2d RoPE uses fraction=0.5), in
    interleaved pairs as the reference does."""
    freqs = rope_freqs(cfg, x.device)
    rot = 2 * freqs.shape[0]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].float()
    xp = x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1)


# ----------------------------------------------------------------------
# attention (GQA, cross, sliding-window; optional KV cache)
# ----------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections (`attention_init`); `attention_apply` runs them."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, _dtype(cfg)
        self.wq = _normal(g, (d, cfg.n_heads * hd), dt)
        self.wk = _normal(g, (d, cfg.n_kv_heads * hd), dt)
        self.wv = _normal(g, (d, cfg.n_kv_heads * hd), dt)
        self.wo = _normal(g, (cfg.n_heads * hd, d), dt)
        if cfg.qkv_bias:
            self.bq = _const((cfg.n_heads, hd), 0.0, dt, g)
            self.bk = _const((cfg.n_kv_heads, hd), 0.0, dt, g)
            self.bv = _const((cfg.n_kv_heads, hd), 0.0, dt, g)


def _qkv(p: Attention, x: torch.Tensor, kv_x: torch.Tensor,
         cfg: ModelConfig):
    hd = cfg.head_dim
    q = (x @ p.wq).unflatten(-1, (cfg.n_heads, hd))
    k = (kv_x @ p.wk).unflatten(-1, (cfg.n_kv_heads, hd))
    v = (kv_x @ p.wv).unflatten(-1, (cfg.n_kv_heads, hd))
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,Sq,H,Dh); k,v: (B,Sk,Hkv,Dh); GQA via head grouping; mask
    (1, Sq, Sk) bool or None. Scores, softmax and values in float32."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, Dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(Dh)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, kind: str, chunk: int) -> torch.Tensor:
    """Query-chunked attention: never materializes the (Sq, Sk) score
    matrix — peak temporary memory goes from O(Sq*Sk) to O(chunk*Sk) per
    head. One chunk of queries at a time against every key."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    kf, vf = k.float(), v.float()
    kj = torch.arange(k.shape[1], device=q.device)[None, :]
    outs = []
    for idx in range(Sq // chunk):
        qc = q[:, idx * chunk:(idx + 1) * chunk].reshape(B, chunk, Hkv, g, Dh)
        qi = idx * chunk + torch.arange(chunk, device=q.device)[:, None]
        m = kj <= qi
        if kind == "local" and cfg.local_window:
            m = m & (kj > qi - cfg.local_window)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kf)
        s = s / math.sqrt(Dh)
        s = s.masked_fill(~m[None, None, None, :, :], -1e30)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", w, vf)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dh)


def causal_mask(Sq: int, Sk: int, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1, Sq, Sk) mask: query i attends keys j <= i + offset."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Sk, device=device)[None, :]
    return (kj <= qi)[None]


def local_mask(Sq: int, Sk: int, window: int, offset: int = 0,
               device=None) -> torch.Tensor:
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Sk, device=device)[None, :]
    return ((kj <= qi) & (kj > qi - window))[None]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cfg: ModelConfig, kind: str,
            positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Attention without a cache: RoPE (not for cross attention), then the
    query-chunked or the masked softmax. (B, Sq, H, Dh) out."""
    Sq, Sk, dev = q.shape[1], k.shape[1], q.device
    pos_q = torch.arange(Sq, device=dev) if positions is None else positions
    if cfg.pos_embedding == "rope" and kind != "cross":
        q = apply_rope(q, pos_q, cfg)
        k = apply_rope(k, pos_q, cfg)
    if cfg.attn_q_chunk and kind in ("causal", "local") \
            and Sq > cfg.attn_q_chunk and Sq % cfg.attn_q_chunk == 0:
        return _sdpa_chunked(q, k, v, cfg, kind, cfg.attn_q_chunk)
    if kind == "causal":
        mask = causal_mask(Sq, Sk, device=dev)
    elif kind == "local":
        mask = local_mask(Sq, Sk, cfg.local_window, device=dev)
    else:   # full / cross
        mask = None
    return _sdpa(q, k, v, mask)


class _Grid:
    """Where the local form of a DTensor activation x (B, S, ...) runs:
    its batch rows over the data-parallel axes ("pod", "data") where B
    divides them (a batch of one stays whole: DTensor cannot flatten a
    sharded dimension of size 1), and its `width` heads or channels over
    "model" where `width` divides it (the reference's divisibility rule),
    else whole. `first` and `n_loc` are this rank's heads or channels."""

    def __init__(self, x, width: int):
        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
        rows = x.shape[0] > 1 and \
            x.shape[0] % math.prod(mesh.size(i) for i in dp) == 0
        self.mesh = mesh
        self.rows = [i in dp and rows for i in range(len(names))]
        self.split = [n == "model" and width % mesh.size(i) == 0
                      for i, n in enumerate(names)]
        self.first, self.n_loc = 0, width
        for i, on in enumerate(self.split):
            if on:
                self.n_loc = width // mesh.size(i)
                self.first = mesh.get_local_rank(i) * self.n_loc

    def placements(self, dim: int):
        """Rows over the data axes, dimension `dim` over "model"."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(0) if r else Shard(dim) if c else Replicate()
                for r, c in zip(self.rows, self.split)]

    def local(self, t, dim: int) -> torch.Tensor:
        """DTensor t (B, S, ...) placed for the local form, as a plain
        tensor: each shard's gradient is its own."""
        return t.redistribute(placements=self.placements(dim)).to_local()

    def whole(self, t) -> torch.Tensor:
        """DTensor t (B, S, ...) with this rank's rows and all of its
        channels, as a plain tensor. Where the ranks of "model" each keep
        their own heads or channels of what is computed from it, each
        one's gradient for it is a partial sum."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        pl = [Shard(0) if r else Replicate() for r in self.rows]
        grad = [Partial() if c else p for p, c in zip(pl, self.split)]
        return t.redistribute(placements=pl).to_local(grad_placements=grad)

    def param(self, w, dim: int) -> torch.Tensor:
        """Parameter w as the local form reads it: its dimension `dim`
        split over "model" as the heads or channels are, whole elsewhere.
        Where the rows are split, each rank's gradient is a partial sum."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        pl = [Shard(dim) if c else Replicate() for c in self.split]
        grad = [Partial() if r else p for p, r in zip(pl, self.rows)]
        return w.redistribute(placements=pl).to_local(grad_placements=grad)

    def dtensor(self, t: torch.Tensor, shape, dim: int):
        """Local result t back as a DTensor of global `shape`, its rows
        and dimension `dim` placed as the local form ran them."""
        from torch.distributed.tensor import DTensor
        shape = torch.Size(shape)
        return DTensor.from_local(
            t, self.mesh, self.placements(dim), run_check=False,
            shape=shape, stride=torch.empty(shape, device="meta").stride())


def _sharded_attention(p: Attention, x, kv_x, cfg: ModelConfig, kind: str,
                       positions: Optional[torch.Tensor]):
    """`attention_apply` of DTensor activations, Megatron-style: each rank
    attends with its own heads of its own batch rows, on local tensors.

    The projections run as DTensors (the weights' FSDP and TP shards are
    DTensor's to resolve); q, k and v are then placed with the batch over
    the data-parallel axes and the heads over "model" where the head count
    divides it (`_Grid`, the reference's divisibility rule), and taken
    local. No
    DTensor op runs inside: DTensor has no sharding rule for einsum's
    flattening of a batch dim and a head dim that are both sharded, and
    RoPE and the masks are plain tensors. Where the KV heads stay whole
    but the query heads are split, a rank keeps the KV heads its query
    heads read, and its share of their gradient is a partial sum. The
    output comes back as a DTensor with the query's placements for the
    row-parallel `wo`."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    x, kv_x = seq_gathered(x), seq_gathered(kv_x)
    hd, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q_grid = _Grid(x, H)
    q_pl, kv_pl = q_grid.placements(2), _Grid(x, Hkv).placements(2)
    kv_grad = [Partial() if qp == Shard(2) and kp != Shard(2) else kp
               for qp, kp in zip(q_pl, kv_pl)]

    def project(inp, w, b, pl, grad_pl=None):
        t = inp @ w
        if cfg.qkv_bias:
            t = t + b.flatten()
        t = t.redistribute(placements=pl).to_local(grad_placements=grad_pl)
        return t.unflatten(-1, (t.shape[-1] // hd, hd))

    q = project(x, p.wq, getattr(p, "bq", None), q_pl)
    k = project(kv_x, p.wk, getattr(p, "bk", None), kv_pl, kv_grad)
    v = project(kv_x, p.wv, getattr(p, "bv", None), kv_pl, kv_grad)
    hq = q.shape[2]
    if k.shape[2] == Hkv and hq != H:
        # whole KV heads, this rank's query heads [r*hq, (r+1)*hq)
        g = H // Hkv
        first = q_grid.first
        if hq % g == 0 or g % hq == 0:
            # a contiguous run of KV heads, found on the host
            k, v = (t[:, :, first // g:(first + hq - 1) // g + 1]
                    for t in (k, v))
        else:
            kv = (first + torch.arange(hq, device=q.device)) // g
            k, v = k[:, :, kv], v[:, :, kv]
    out = _attend(q, k, v, cfg, kind, positions).flatten(-2)
    out = DTensor.from_local(out, q_grid.mesh, q_pl, run_check=False)
    return out @ p.wo


def _sharded_cached_attention(p: Attention, x, cfg: ModelConfig, kind: str,
                              positions: Optional[torch.Tensor],
                              cache: Cache) -> torch.Tensor:
    """`attention_apply` of a DTensor decode step against a cache of
    DTensors (`sharding.distribute_cache`), on local shards. The cache
    holds its batch rows over the data-parallel axes and, on "model",
    its KV heads where they divide it, else its positions (flash-decode),
    else all of it. q, k and v are placed as the cache is (the query heads
    with the KV heads) and taken local; the new keys and values go into
    the local buffers at the host-side position, on the rank that holds
    that position (a ring cache's positions table is replicated, and every
    rank writes it). Where the positions are sharded, each rank attends
    over its own and the partial softmaxes are merged across the shards
    (`_sdpa_merged`). The output comes back as a DTensor for the
    row-parallel `wo`."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    hd = cfg.head_dim
    c_pl = cache["k"].placements
    pl = [c if c in (Shard(0), Shard(2)) else Replicate() for c in c_pl]

    def project(w, b):
        t = x @ w
        if cfg.qkv_bias:
            t = t + b.flatten()
        t = t.redistribute(placements=pl).to_local()
        return t.unflatten(-1, (t.shape[-1] // hd, hd))

    q = project(p.wq, getattr(p, "bq", None))
    k = project(p.wk, getattr(p, "bk", None))
    v = project(p.wv, getattr(p, "bv", None))
    Sq, dev = q.shape[1], q.device
    pos_q = torch.arange(Sq, device=dev) if positions is None else positions
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, pos_q, cfg)
        k = apply_rope(k, pos_q, cfg)
    seq = [i for i, c in enumerate(c_pl) if c == Shard(1)]
    kc, vc = cache["k"].to_local(), cache["v"].to_local()
    n_loc = kc.shape[1]
    first = mesh.get_local_rank(seq[0]) * n_loc if seq else 0
    idx = cache["idx"]
    qi = idx + torch.arange(Sq, device=dev)[:, None]
    if "pos" in cache:
        if Sq != 1:
            raise ValueError("ring cache supports single-token decode")
        slot = idx % cache["k"].shape[1]
        kpos = cache["pos"].to_local()
        kpos[slot] = idx
        if first <= slot < first + n_loc:
            kc[:, slot - first:slot - first + 1] = k
            vc[:, slot - first:slot - first + 1] = v
        kp = kpos[first:first + n_loc][None, :]
        m = (kp >= 0) & (kp <= qi) & (kp > qi - cfg.local_window)
    else:
        start = min(max(idx, 0), cache["k"].shape[1] - Sq)
        lo, hi = max(start, first), min(start + Sq, first + n_loc)
        if lo < hi:
            kc[:, lo - first:hi - first] = k[:, lo - start:hi - start]
            vc[:, lo - first:hi - first] = v[:, lo - start:hi - start]
        kj = first + torch.arange(n_loc, device=dev)[None, :]
        m = kj <= qi
        if kind == "local" and cfg.local_window:
            m = m & (kj > qi - cfg.local_window)
    cache["idx"] = idx + Sq
    out = _sdpa_merged(q, kc, vc, m[None], mesh.get_group(seq[0])) if seq \
        else _sdpa(q, kc, vc, m[None])
    out = DTensor.from_local(out.flatten(-2), mesh, pl, run_check=False)
    return out @ p.wo


def _sdpa_merged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor, group) -> torch.Tensor:
    """`_sdpa` over keys split across the ranks of `group` (each holds
    its own keys and values and their mask columns): the scores' max is
    taken over the group, then each rank's exponentials' sum and their
    product with its values are summed over it in one all-reduce."""
    import torch.distributed as dist
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    s = (s / math.sqrt(Dh)).masked_fill(~mask[:, None, None, :, :], -1e30)
    top = s.amax(-1, keepdim=True)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(s - top)
    tot = torch.cat([torch.einsum("bhgqk,bkhd->bhgqd", e, v.float()),
                     e.sum(-1, keepdim=True)], dim=-1)
    dist.all_reduce(tot, group=group)
    out = tot[..., :-1] / tot[..., -1:]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)


def attention_apply(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
                    kv_source: Optional[torch.Tensor] = None,
                    kind: str = "causal",
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[Cache] = None,
                    ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """kind: causal | local | full | cross. With `cache`, x is the new
    suffix (decode: Sq=1): keys/values are written at cache['idx'] (the
    start clamped into the buffer, as `dynamic_update_slice` clamps it) or,
    for a ring cache (local attention, a 'pos' entry), at idx % window.
    Returns (out, cache) with the same cache dict, updated in place. DTensor
    activations run `_sharded_attention` (no cache) or, against a cache of
    DTensors, `_sharded_cached_attention`."""
    B, Sq, _ = x.shape
    dev = x.device
    kv_x = kv_source if kv_source is not None else x
    if cache is None and is_dtensor(x):
        return _sharded_attention(p, x, kv_x, cfg, kind, positions), cache
    if cache is not None and kind != "cross" and is_dtensor(cache["k"]):
        return _sharded_cached_attention(p, x, cfg, kind, positions,
                                         cache), cache
    q, k, v = _qkv(p, x, kv_x, cfg)
    if cache is None or kind == "cross":
        return _attend(q, k, v, cfg, kind, positions).flatten(-2) @ p.wo, \
            cache

    pos_q = torch.arange(Sq, device=dev) if positions is None else positions
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, pos_q, cfg)
        k = apply_rope(k, pos_q, cfg)
    idx = cache["idx"]
    qi = idx + torch.arange(Sq, device=dev)[:, None]
    if "pos" in cache:
        # ring-buffer cache for local attention: O(window) memory, the
        # key to sub-quadratic long-context decode (long_500k)
        W = cache["k"].shape[1]
        if Sq != 1:
            raise ValueError("ring cache supports single-token decode")
        slot = idx % W
        cache["k"][:, slot:slot + 1] = k
        cache["v"][:, slot:slot + 1] = v
        cache["pos"][slot] = idx
        kp = cache["pos"][None, :]                 # global key positions
        m = (kp >= 0) & (kp <= qi) & (kp > qi - cfg.local_window)
    else:
        Sk = cache["k"].shape[1]
        start = min(max(idx, 0), Sk - Sq)
        cache["k"][:, start:start + Sq] = k
        cache["v"][:, start:start + Sq] = v
        kj = torch.arange(Sk, device=dev)[None, :]
        m = kj <= qi
        if kind == "local" and cfg.local_window:
            m = m & (kj > qi - cfg.local_window)
    cache["idx"] = idx + Sq
    out = _sdpa(q, cache["k"], cache["v"], m[None])
    return out.flatten(-2) @ p.wo, cache


# ----------------------------------------------------------------------
# FFN
# ----------------------------------------------------------------------

class FFN(nn.Module):
    """SwiGLU (`wg`, `wu`, `wd`) or GELU (`wu`, `bu`, `wd`, `bd`) FFN
    (`ffn_init` / `ffn_apply`)."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator,
                 d_ff: Optional[int] = None):
        super().__init__()
        d_ff = d_ff or cfg.d_ff
        d, dt = cfg.d_model, _dtype(cfg)
        self.swiglu = cfg.ffn_kind == "swiglu"
        if self.swiglu:
            self.wg = _normal(g, (d, d_ff), dt)
            self.wu = _normal(g, (d, d_ff), dt)
            self.wd = _normal(g, (d_ff, d), dt)
        else:
            self.wu = _normal(g, (d, d_ff), dt)
            self.bu = _const((d_ff,), 0.0, dt, g)
            self.wd = _normal(g, (d_ff, d), dt)
            self.bd = _const((d,), 0.0, dt, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = seq_gathered(x)
        if self.swiglu:
            return (F.silu(x @ self.wg) * (x @ self.wu)) @ self.wd
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ self.wu + self.bu, approximate="tanh")
        return h @ self.wd + self.bd
