"""Step factories and the assigned input shapes (counterpart of
`repro.models.model`): the shape cells, the loss, the train / eval /
prefill / serve steps over a `transformer.Transformer`, and meta-device
stand-ins for the inputs, the parameters and the optimizer state.

Each factory takes the config the step is for and returns a step over a
model of that config; a model of another config is refused. The eval,
prefill and serve steps run under `layers.no_graph` (inference mode, or
no_grad on a distributed model: no graph is recorded, though the
parameters are trainable); the train step updates
the model's parameters in place. On a model with DTensor parameters
(`sharding.distribute_model`) and a DTensor batch the steps run sharded;
`mesh`, `dp_axes`, `use_ep`, `act_sharding` and `ep_fsdp` are
`transformer.forward`'s. The loss and the metrics come back as plain
tensors, the gradients with their parameters' placements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from . import transformer as tfm
from .config import ModelConfig
from .layers import is_dtensor, no_graph, plain


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic decode state; decode shapes need a
    decoder (all assigned archs have one)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k-context decode "
                       "skipped per brief (no sub-quadratic attention)")
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, ""


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            z_loss: float = 1e-4) -> torch.Tensor:
    """Token-mean cross entropy with z-loss, computed in float32. DTensor
    logits take `_sharded_loss`."""
    if is_dtensor(logits):
        return _sharded_loss(logits, labels, z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    true = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = lse - true
    return ce.mean() + z_loss * (lse ** 2).mean()


def _sharded_loss(logits, labels, z_loss: float) -> torch.Tensor:
    """`loss_fn` of DTensor logits (B, S, V) on local shards, the vocab
    parallel as Megatron computes it: where the vocab is sharded, the
    logsumexp takes a max, a sum of exponentials and the picked label's
    logit, each summed (the max reduced) over the vocab's mesh dim; the
    per-token terms are then summed over the token shards and divided by
    the global token count (equal shards: the mean of means). DTensor's
    own pick of a label from sharded logits leaves a masked partial sum
    whose backward torch 2.11 cannot redistribute. Returns a plain scalar,
    the same on every rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from ..sharding.comms import all_sum
    from .layers import _vocab_shard
    mesh = logits.device_mesh
    lead = logits.ndim - 1
    pl = [p if p == Shard(lead) or (isinstance(p, Shard) and p.dim < lead)
          else Replicate() for p in logits.placements]
    lg = logits.redistribute(placements=pl).to_local().float()
    lab = labels.redistribute(placements=[
        p if isinstance(p, Shard) and p.dim < lead else Replicate()
        for p in pl]).to_local().long()
    dim, first, rows = _vocab_shard(mesh, [
        Shard(0) if p == Shard(lead) else Replicate() for p in pl],
        logits.shape[-1])
    if dim is None:
        lse = torch.logsumexp(lg, dim=-1)
        true = torch.gather(lg, -1, lab[..., None])[..., 0]
    else:
        group = mesh.get_group(dim)
        m = lg.detach().amax(-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        lse = torch.log(all_sum(torch.exp(lg - m).sum(-1), group)) + m[..., 0]
        mine = (lab >= first) & (lab < first + rows)
        picked = torch.gather(lg, -1, torch.where(mine, lab - first,
                                                  0)[..., None])[..., 0]
        true = all_sum(picked * mine, group)
    ce = lse - true
    shards = [i for i, p in enumerate(pl) if isinstance(p, Shard)
              and p.dim < lead and mesh.size(i) > 1]     # token shards
    if not shards:
        return ce.mean() + z_loss * (lse ** 2).mean()
    sums = torch.stack([ce.sum(), (lse ** 2).sum()])
    for i in shards:
        sums = all_sum(sums, mesh.get_group(i))
    n = math.prod(logits.shape[:-1])
    return sums[0] / n + z_loss * (sums[1] / n)


def _check(model: tfm.Transformer, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"step built for {cfg.name!r} got a model of "
                         f"{model.cfg.name!r} (or another variant)")


def _microbatches(v: torch.Tensor, m: int):
    """`v` split into `m` microbatches along its first axis: contiguous
    row blocks, as on one device. A DTensor batch is gathered (token ids:
    a few KiB) and each block is sharded again as `v` is."""
    if not is_dtensor(v):
        return list(v.reshape(m, v.shape[0] // m, *v.shape[1:]))
    from ..sharding.rules import place
    full = v.full_tensor()
    b = full.shape[0] // m
    return [place(full[i * b:(i + 1) * b], v.device_mesh, v.placements)
            for i in range(m)]


def loss_and_grads(model: tfm.Transformer, batch: Dict[str, torch.Tensor],
                   *, microbatch: int = 1,
                   accum_dtype: torch.dtype = torch.float32,
                   remat_policy: str = "full", mesh=None,
                   dp_axes: Tuple[str, ...] = ("data",),
                   use_ep: bool = False, act_sharding=None,
                   ep_fsdp: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {parameter name: gradient}) of `loss_fn(forward(...))` on
    `batch`. With `microbatch` > 1 the batch splits along its first axis,
    each part's gradients are added in `accum_dtype`, and the summed loss
    and gradients are divided by `microbatch` (the reference's scan over
    microbatches). A parameter the loss does not reach gets zeros.

    On DTensor parameters each gradient is reduced onto its parameter's
    placements (an all-reduce over the data-parallel axes, a
    reduce-scatter where the parameter is sharded), once per microbatch;
    the loss is the global token mean, read whole."""
    names, params = zip(*model.named_parameters())
    fwd = dict(remat_policy=remat_policy, mesh=mesh, dp_axes=dp_axes,
               use_ep=use_ep, act_sharding=act_sharding, ep_fsdp=ep_fsdp)

    def one(b):
        logits = tfm.forward(model, b["tokens"],
                             cross_source=b.get("cross_source"), **fwd)
        loss = loss_fn(logits, b["labels"])
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        grads = [g.redistribute(placements=p.placements) if is_dtensor(g)
                 else g for g, p in zip(grads, params)]
        return plain(loss.detach()), grads

    if microbatch <= 1:
        loss, grads = one(batch)
        return loss, dict(zip(names, grads))
    parts = {k: _microbatches(v, microbatch) for k, v in batch.items()}
    loss = 0.0
    acc = [torch.zeros_like(p, dtype=accum_dtype) for p in params]
    for i in range(microbatch):
        l, g = one({k: v[i] for k, v in parts.items()})
        loss = loss + l
        for a, gi in zip(acc, g):
            a.add_(gi.to(accum_dtype))
        del g
    return loss / microbatch, {n: a / microbatch for n, a in zip(names, acc)}


def make_train_step(cfg: ModelConfig, opt_cfg=None, *, mesh=None,
                    dp_axes: Tuple[str, ...] = ("data",),
                    use_ep: bool = False, act_sharding=None,
                    optimizer: str = "adamw", remat_policy: str = "full",
                    microbatch: int = 1, ep_fsdp: bool = False,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """Returns step(model, opt_state, batch) -> (opt_state, metrics),
    which updates the model's parameters in place. batch: dict(tokens,
    labels [, cross_source]) on the model's device (DTensors for a
    distributed model).

    microbatch > 1 splits the global batch and accumulates gradients in
    `accum_dtype`: activation memory scales down ~1/microbatch while the
    arithmetic is unchanged."""
    from ..train import optim as optim_lib
    if optimizer == "adamw":
        ocfg = opt_cfg or optim_lib.AdamWConfig()
        upd = optim_lib.adamw_update
    else:
        ocfg = opt_cfg or optim_lib.AdafactorConfig()
        upd = optim_lib.adafactor_update

    def step(model, opt_state, batch):
        _check(model, cfg)
        loss, grads = loss_and_grads(
            model, batch, microbatch=microbatch, accum_dtype=accum_dtype,
            remat_policy=remat_policy, mesh=mesh, dp_axes=dp_axes,
            use_ep=use_ep, act_sharding=act_sharding, ep_fsdp=ep_fsdp)
        opt_state = upd(ocfg, grads, opt_state, model)
        return opt_state, {"loss": loss}
    return step


def make_eval_step(cfg: ModelConfig, *, mesh=None,
                   dp_axes: Tuple[str, ...] = ("data",),
                   use_ep: bool = False) -> Callable:
    """step(model, batch) -> {"loss", "logits_mean"}; batch: dict(tokens,
    labels [, cross_source])."""
    def step(model, batch):
        _check(model, cfg)
        with no_graph(model):
            logits = tfm.forward(model, batch["tokens"],
                                 cross_source=batch.get("cross_source"),
                                 mesh=mesh, dp_axes=dp_axes, use_ep=use_ep)
            return {"loss": plain(loss_fn(logits, batch["labels"])),
                    "logits_mean": plain(logits.mean())}
    return step


def make_prefill_step(cfg: ModelConfig, *, mesh=None,
                      dp_axes: Tuple[str, ...] = ("data",),
                      use_ep: bool = False, act_sharding=None,
                      ep_fsdp: bool = False) -> Callable:
    """Prefill: full forward returning last-position logits (B, V) (a
    DTensor on a distributed model)."""
    def step(model, batch):
        _check(model, cfg)
        with no_graph(model):
            logits = tfm.forward(model, batch["tokens"],
                                 cross_source=batch.get("cross_source"),
                                 mesh=mesh, dp_axes=dp_axes, use_ep=use_ep,
                                 act_sharding=act_sharding, ep_fsdp=ep_fsdp)
            return logits[:, -1]
    return step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """Decode: one new token against a populated cache.
    step(model, cache, token, cross_source=None, pos=None) -> (next token
    (B, 1) int32, logits (B, 1, V) float32, cache); `pos` is
    `transformer.decode_step`'s. A distributed model decodes against a
    cache placed by `sharding.distribute_cache` and a DTensor token."""
    def step(model, cache, token, cross_source=None, pos=None):
        _check(model, cfg)
        with no_graph(model):
            logits, cache = tfm.decode_step(model, token, cache,
                                            cross_source=cross_source,
                                            pos=pos)
            next_tok = _argmax_rows(logits[:, -1]).to(torch.int32)
            return next_tok[:, None], logits, cache
    return step


def _argmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis of (B, V) logits. DTensor logits keep
    their batch shards, gather their vocab shards (each rank its own rows,
    whole) and take the argmax locally: DTensor's own argmax over a
    sharded axis reads shard offsets on the host."""
    if not is_dtensor(logits):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [p if p == Shard(0) else Replicate() for p in logits.placements]
    local = logits.redistribute(placements=pl).to_local()
    return DTensor.from_local(torch.argmax(local, dim=-1),
                              logits.device_mesh, pl, run_check=False)


# ----------------------------------------------------------------------
# abstract inputs (meta-device stand-ins; nothing is allocated)
# ----------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch_override: Optional[int] = None) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell.

    train/prefill: tokens (+labels for train) (B, S) int32; decode: token
    (B, 1) + the KV/recurrent cache of length S (`init_cache` on the meta
    device). Modality frontends are stubs: `cross_source` is the
    precomputed patch/frame embedding sequence."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    tok = torch.int32
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = meta((B, S), tok)
        specs["labels"] = meta((B, S), tok)
    elif shape.kind == "prefill":
        specs["tokens"] = meta((B, S), tok)
    else:   # decode
        specs["token"] = meta((B, 1), tok)
        specs["cache"] = tfm.init_cache(cfg, B, S, device="meta")
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.family == "vlm":
        specs["cross_source"] = meta((B, cfg.cross_source_len or 1600,
                                      cfg.d_model), dt)
    if cfg.is_enc_dec:
        # decode consumes the encoded memory; train/prefill the stub frames
        specs["cross_source"] = meta((B, cfg.cross_source_len or 1500,
                                      cfg.d_model), dt)
    return specs


def abstract_params(cfg: ModelConfig, max_len: int = 0) -> tfm.Transformer:
    """The model on the meta device: every parameter's shape and dtype,
    nothing allocated (a 1T-parameter config included). Learned positions
    get `max_len` rows (65,536 when 0), as the reference sizes them."""
    need_pos = cfg.pos_embedding == "learned"
    ml = max_len if max_len else 65536
    return tfm.Transformer(cfg, None, ml if need_pos else 0)


def abstract_opt_state(cfg_or_params, optimizer: str = "adamw"):
    """The optimizer's state on the meta device, for a config or a model
    (the model's own tensors are not touched). Its tensors have the
    reference's leaf shapes (`train.optim`)."""
    from ..train import optim as optim_lib
    if isinstance(cfg_or_params, ModelConfig):
        params = abstract_params(cfg_or_params)
    else:
        pos = cfg_or_params.pos
        params = tfm.Transformer(cfg_or_params.cfg, None,
                                 0 if pos is None else pos.pos.shape[0])
    if optimizer == "adamw":
        return optim_lib.adamw_init(optim_lib.AdamWConfig(), params)
    return optim_lib.adafactor_init(optim_lib.AdafactorConfig(), params)
