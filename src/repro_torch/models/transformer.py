"""Model assembly (counterpart of `repro.models.transformer`): layer
blocks by kind, KV/recurrent caches, encoder-decoder support. Covers all
10 assigned architectures via ModelConfig.block_pattern.

The reference scans over depth (prefix unrolled, full pattern periods
under `lax.scan`, suffix unrolled). The port keeps one module per layer in
depth order; `DepthPlan` still names the split, and the converter
unstacks the reference's scanned periods into layers.

A cache is {"layers": [one per decoder layer]}: attention layers hold
"k", "v" (and "pos" for a ring buffer) and the write position "idx" (a
Python int, so the host knows every position without reading the device);
recurrent layers hold their state tensors. `decode_step` updates the cache
in place and returns it; `clone_cache` gives an independent copy.

`forward` is the training and prefill pass: with autograd recording it
checkpoints each repeated period of the depth plan (the reference's
`jax.checkpoint` around its scanned body). On a model whose parameters are
DTensors (`sharding.distribute_model`) and a DTensor batch it runs
sharded: DTensor's sharding propagation stands in for the reference's
GSPMD, `use_ep` routes the MoE layers through `moe.moe_apply_ep` over
`mesh`, and `act_sharding` (DTensor placements) redistributes the
inter-layer activation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve
from . import recurrent as rec
from .config import ModelConfig
from .layers import (Attention, Embedding, FFN, LearnedPositions, LMHead,
                     Norm, _dtype, attention_apply, is_dtensor, no_graph,
                     unembed_apply)
from .moe import MoE, moe_apply_ep

Cache = Dict[str, object]


# ----------------------------------------------------------------------
# depth plan
# ----------------------------------------------------------------------

class DepthPlan:
    """Split layer kinds into prefix / repeated periods / suffix."""

    def __init__(self, cfg: ModelConfig):
        kinds = list(cfg.layer_kinds)
        self.prefix: List[str] = kinds[:cfg.first_dense_layers]
        rest = kinds[cfg.first_dense_layers:]
        period = len(cfg.block_pattern)
        n_rep = len(rest) // period
        self.n_rep = n_rep
        self.period_kinds: Tuple[str, ...] = tuple(cfg.block_pattern)
        self.suffix: List[str] = rest[n_rep * period:]

    def __repr__(self):
        return (f"DepthPlan(prefix={self.prefix}, "
                f"{self.n_rep}x{self.period_kinds}, suffix={self.suffix})")


# ----------------------------------------------------------------------
# one block (layer) by kind
# ----------------------------------------------------------------------

class Block(nn.Module):
    """Pre-norm residual block of one kind (`block_init` /
    `block_apply`); submodule names are the reference's keys."""

    def __init__(self, kind: str, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.kind, self.cfg = kind, cfg
        self.ln1 = Norm(cfg, g)
        if kind in ("attn", "local", "attn_dense", "cross", "moe"):
            self.attn = Attention(cfg, g)
            if kind == "cross":
                self.lnx = Norm(cfg, g)
                self.xattn = Attention(cfg, g)
            self.ln2 = Norm(cfg, g)
            if kind == "moe":
                self.moe = MoE(cfg, g)
            else:
                self.ffn = FFN(cfg, g)
        elif kind == "mlstm":
            self.cell = rec.MLSTM(cfg, g)
        elif kind == "slstm":
            self.cell = rec.SLSTM(cfg, g)
        elif kind == "rglru":
            self.rec = rec.RGLRU(cfg, g)
            self.ln2 = Norm(cfg, g)
            self.ffn = FFN(cfg, g)
        else:
            raise ValueError(kind)

    def forward(self, x: torch.Tensor, *,
                cross_source: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None, mesh=None,
                dp_axes: Tuple[str, ...] = ("data",), use_ep: bool = False,
                ep_fsdp: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Returns (x, cache) — the same cache dict, updated. With
        `use_ep` and a `mesh`, a MoE layer runs expert-parallel."""
        kind, cfg = self.kind, self.cfg
        if kind in ("attn", "local", "attn_dense", "moe", "cross"):
            akind = "local" if kind == "local" else "causal"
            h, cache = attention_apply(self.attn, self.ln1(x), cfg,
                                       kind=akind, positions=positions,
                                       cache=cache)
            x = _residual(x, h)
            if kind == "cross" and cross_source is not None:
                h, _ = attention_apply(self.xattn, self.lnx(x), cfg,
                                       kv_source=cross_source, kind="cross")
                x = _residual(x, h)
            if kind == "moe" and use_ep and mesh is not None:
                h = moe_apply_ep(self.moe, self.ln2(x), cfg, mesh,
                                 dp_axes=dp_axes,
                                 fsdp_axis="data" if ep_fsdp else None)
            elif kind == "moe":
                h = self.moe(self.ln2(x))
            else:
                h = self.ffn(self.ln2(x))
            return _residual(x, h), cache

        if kind in ("mlstm", "slstm"):
            xn = self.ln1(x)
            if cache is None:
                return _residual(x, self.cell(xn)), None
            h, cache = self.cell.step(xn, cache)
            return x + h, cache

        # rglru
        xn = self.ln1(x)
        if cache is None:
            x = _residual(x, self.rec(xn))
        else:
            h, cache = self.rec.step(xn, cache)
            x = x + h
        return _residual(x, self.ffn(self.ln2(x))), cache


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x + h. Where the residual stream `x` is a DTensor with its
    sequence sharded (sequence-parallel activations), `h` is first placed
    as `x` explicitly, so that its gradient comes back in `h`'s own
    placements: DTensor on torch 2.11 cannot flatten a sequence-sharded
    gradient into the product that made `h`."""
    from torch.distributed.tensor import Shard
    if is_dtensor(h) and is_dtensor(x) and Shard(1) in x.placements \
            and h.placements != x.placements:
        h = h.redistribute(placements=x.placements)
    return x + h


def block_cache_init(kind: str, cfg: ModelConfig, B: int, max_len: int,
                     device=None) -> Cache:
    dh = cfg.head_dim
    if kind in ("attn", "local", "attn_dense", "moe", "cross"):
        kv = dict(dtype=_dtype(cfg), device=device)
        if kind == "local" and cfg.local_window and \
                max_len > cfg.local_window:
            # ring buffer: O(window) memory — sub-quadratic decode state
            W = cfg.local_window
            return {"k": torch.zeros((B, W, cfg.n_kv_heads, dh), **kv),
                    "v": torch.zeros((B, W, cfg.n_kv_heads, dh), **kv),
                    "pos": torch.full((W,), -1, dtype=torch.int32,
                                      device=device),
                    "idx": 0}
        return {"k": torch.zeros((B, max_len, cfg.n_kv_heads, dh), **kv),
                "v": torch.zeros((B, max_len, cfg.n_kv_heads, dh), **kv),
                "idx": 0}
    if kind == "mlstm":
        return rec.mlstm_init_cache(cfg, B, device)
    if kind == "slstm":
        return rec.slstm_init_cache(cfg, B, device)
    if kind == "rglru":
        return rec.rglru_init_cache(cfg, B, device)
    raise ValueError(kind)


# ----------------------------------------------------------------------
# whole model
# ----------------------------------------------------------------------

class Encoder(nn.Module):
    """Whisper's encoder over stubbed frontend embeddings."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(Block("attn", cfg, g)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = Norm(cfg, g)


class Transformer(nn.Module):
    """The whole model: embedding (+ untied head, + learned positions),
    the decoder layers in depth order, the final norm and, for enc-dec
    configs, the encoder. Build it with `init_params`; run it with
    `forward`, `encode` and `decode_step`. Without a generator (`g=None`)
    the parameters are built on the meta device (`model.abstract_params`).
    """

    def __init__(self, cfg: ModelConfig, g: Optional[torch.Generator],
                 max_len: int = 0):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg, g)
        self.lm_head = None if cfg.tie_embeddings else LMHead(cfg, g)
        self.pos = None
        if cfg.pos_embedding == "learned":
            if max_len <= 0:
                raise ValueError("learned positions need max_len > 0")
            self.pos = LearnedPositions(cfg, g, max_len)
        self.final_norm = Norm(cfg, g)
        self.layers = nn.ModuleList(Block(kind, cfg, g)
                                    for kind in cfg.layer_kinds)
        self.encoder = Encoder(cfg, g) if cfg.is_enc_dec else None

    def forward(self, tokens: torch.Tensor, *,
                cross_source: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return forward(self, tokens, cross_source=cross_source)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                max_len: int = 0, device: DeviceLike = None) -> Transformer:
    """A model with random weights drawn from `generator` (on the
    generator's device), moved to `device` (default: the card)."""
    dev = resolve(device)
    return Transformer(cfg, generator, max_len).to(dev)


def encode(model: Transformer, frames: torch.Tensor) -> torch.Tensor:
    """Encoder over stubbed frontend embeddings (B, S_enc, d)."""
    cfg = model.cfg
    x = frames
    for lp in model.encoder.layers:
        h, _ = attention_apply(lp.attn, lp.ln1(x), cfg, kind="full")
        x = x + h
        x = x + lp.ffn(lp.ln2(x))
    return model.encoder.final_norm(x)


def _saves_products(ctx, op, *args, **kwargs):
    """The "dots" remat policy: keep the outputs of 2-D matrix products
    (the weight products), recompute the rest — the counterpart of
    `jax.checkpoint_policies.dots_with_no_batch_dims_saveable` (batched
    products such as attention's and the experts' are recomputed)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(run, remat_policy: str):
    """`run(x) -> x` under activation checkpointing: "full" keeps only
    its input, "dots" also the weight products' outputs."""
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat_policy == "dots":
        return lambda x: checkpoint(
            run, x, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(
                _saves_products))
    if remat_policy != "full":
        raise ValueError(f"unknown remat_policy {remat_policy!r}; expected "
                         f"'full' or 'dots'")
    return lambda x: checkpoint(run, x, use_reentrant=False)


def forward(model: Transformer, tokens: torch.Tensor, *,
            cross_source: Optional[torch.Tensor] = None, mesh=None,
            dp_axes: Tuple[str, ...] = ("data",), use_ep: bool = False,
            remat_scan: bool = True, act_sharding=None,
            remat_policy: str = "full", ep_fsdp: bool = False
            ) -> torch.Tensor:
    """Full-sequence forward (training / prefill). tokens (B, S) -> (B, S,
    V) float32 logits. Enc-dec configs take the stub frames as
    `cross_source` and encode them here; VLM configs take the patch
    embeddings.

    With `remat_scan` and autograd recording, each repeated period of the
    depth plan (the reference's scanned body) runs under activation
    checkpointing by `remat_policy` ("full" or "dots"); the prefix and
    suffix layers do not, as in the reference.

    `mesh` (a `DeviceMesh`) is read only by the MoE layers under `use_ep`
    (`moe_apply_ep` over `dp_axes` and "model", the experts' d_model
    gathered over "data" with `ep_fsdp`), as in the reference.
    `act_sharding`, DTensor placements, redistributes the inter-layer
    activation after the embedding and after each repeated period (the
    reference's sharding constraint on its scan carry)."""
    cfg = model.cfg
    B, S = tokens.shape
    wsc = (lambda t: t.redistribute(placements=act_sharding)) \
        if act_sharding is not None else (lambda t: t)
    x = model.embed(tokens)
    if model.pos is not None:
        x = x + model.pos.pos[None, :S]
    x = wsc(x)
    positions = torch.arange(S, device=tokens.device)
    if cfg.is_enc_dec:
        cross_source = encode(model, cross_source)

    def run(blocks):
        def body(x):
            for blk in blocks:
                x, _ = blk(x, cross_source=cross_source, positions=positions,
                           mesh=mesh, dp_axes=dp_axes, use_ep=use_ep,
                           ep_fsdp=ep_fsdp)
            return x
        return body

    plan = DepthPlan(cfg)
    n_pre, period = len(plan.prefix), len(plan.period_kinds)
    n_scan = plan.n_rep * period
    layers = list(model.layers)
    x = run(layers[:n_pre])(x)
    remat = remat_scan and torch.is_grad_enabled() and any(
        p.requires_grad for p in model.parameters())
    for r in range(plan.n_rep):
        body = run(layers[n_pre + r * period:n_pre + (r + 1) * period])
        x = wsc(_checkpointed(body, remat_policy)(x) if remat else body(x))
    x = run(layers[n_pre + n_scan:])(x)
    x = model.final_norm(x)
    return unembed_apply(model.embed, model.lm_head, x, cfg)


def cache_position(cache: Cache) -> int:
    """Current decode position = any attention cache's idx (they advance
    in lockstep); 0 for pure-recurrent models (which ignore positions)."""
    for c in cache["layers"]:
        if "idx" in c:
            return c["idx"]
    return 0


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               device: DeviceLike = None) -> Cache:
    dev = resolve(device)
    return {"layers": [block_cache_init(k, cfg, B, max_len, dev)
                       for k in cfg.layer_kinds]}


def clone_cache(cache: Cache) -> Cache:
    """An independent copy (tensors cloned, positions copied)."""
    return {"layers": [{k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in c.items()} for c in cache["layers"]]}


def decode_step(model: Transformer, token: torch.Tensor, cache: Cache, *,
                cross_source: Optional[torch.Tensor] = None,
                pos: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. token: (B,1) integer. Returns ((B,1,V) float32
    logits, cache), the cache updated in place. Runs under
    `layers.no_graph` (`torch.inference_mode()`, or `torch.no_grad()` for
    a distributed model): decoding records no graph, though the
    parameters are trainable.

    For enc-dec models `cross_source` is the ALREADY-ENCODED memory (encode
    once at serve start, not per decode step)."""
    with no_graph(model):
        return _decode_step(model, token, cache, cross_source, pos)


def _decode_step(model, token, cache, cross_source, pos):
    cfg = model.cfg
    x = model.embed(token)
    if pos is None:
        pos = cache_position(cache)
    positions = pos + torch.arange(1, device=token.device)
    if model.pos is not None:
        table = model.pos.pos
        p = min(max(pos, 0), table.shape[0] - 1)   # dynamic_slice clamps
        x = x + table[None, p:p + 1]
    for blk, c in zip(model.layers, cache["layers"]):
        x, _ = blk(x, cross_source=cross_source, positions=positions,
                   cache=c)
    x = model.final_norm(x)
    return unembed_apply(model.embed, model.lm_head, x, cfg), cache
