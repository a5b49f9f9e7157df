"""Optimizers (AdamW, Adafactor) + int8 gradient compression with error
feedback (counterpart of `repro.train.optim`), written from scratch so
every state tensor is addressable by name for the checkpointer.

Parameters are a model (`models.transformer.Transformer`) or a dict of
name -> tensor; gradients a dict of the same names. The updates change the
parameters in place under `torch.no_grad()` and return the new state.

State is kept per leaf of the reference's parameter tree, in the
reference's layout (`models.leaves`): for a model, the repeated layers'
moments are stacked along a leading axis and heads are an axis of their
own, so the reductions the reference runs over one whole leaf — the int8
scale, Adafactor's factored moments and its update-RMS clip — run over the
same numbers here, and a state converts across as it is
(`convert.opt_state_from_reference`). Each port parameter reads and writes
its slice of its leaf through a view. A plain dict is one leaf per entry.

Gradient compression: per-leaf symmetric int8 quantization with
error-feedback accumulation of the quantization residual, applied to the
gradients before the update (`train.loop`, `grad_compression="int8"`).

On a distributed model (`sharding.distribute_model`: DTensor parameters,
the gradients on their parameters' placements) the state tensors are
DTensors too, placed by the model's per-leaf specs: AdamW's moments and
the int8 residual as their parameter, Adafactor's factored moments as
`sharding.adafactor_state_specs` gives them. Every reduction runs over the
whole leaf, across shards: the clipping norm sums each gradient's pending
(`Partial`) sum and reduces once per placement, the int8 scale is the
max over every shard, and Adafactor runs on DTensors, so its row / column
means and its RMS clip reduce across ranks. Elementwise work (AdamW,
quantization) runs on each rank's local shard, where a parameter, its
gradient and its state line up element for element.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..models.layers import is_dtensor
from ..models.leaves import Leaf, identity_groups, leaf_groups

Params = Union[nn.Module, Mapping[str, torch.Tensor]]
Tree = Dict[str, torch.Tensor]


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def groups_of(params: Params) -> Dict[str, Leaf]:
    """The reference's leaves over `params`: the model's leaf geometry for
    a model with a `cfg` (built once and kept on the model), else one leaf
    per entry."""
    cached = getattr(params, "_leaf_groups", None)
    if cached is not None:
        return cached
    named = named_params(params)
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    cfg = getattr(params, "cfg", None)
    if cfg is None:
        return identity_groups(shapes)
    groups = leaf_groups(cfg, shapes)
    params._leaf_groups = groups
    return groups


def _member(state: torch.Tensor, idx: Optional[int], shape) -> torch.Tensor:
    """A member's slice of its leaf's state, viewed in `shape`."""
    return (state if idx is None else state[idx]).view(shape)


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage); any other tensor
    as it is."""
    return x.to_local() if is_dtensor(x) else x


def _zeros_like_leaves(groups: Dict[str, Leaf], named, shape_fn,
                       dtype, specs: Optional[Mapping] = None) -> Tree:
    """Zeros of `shape_fn(leaf shape)` per leaf: DTensors placed by
    `specs` (leaf key -> PartitionSpec) when given, else on the device of
    the leaf's first member."""
    if specs is not None:
        from torch.distributed import tensor as dt

        from ..sharding.rules import to_placements
        mesh = next(iter(named.values())).device_mesh
        return {key: dt.zeros(shape_fn(leaf.shape), dtype=dtype,
                              device_mesh=mesh,
                              placements=to_placements(specs[key], mesh))
                for key, leaf in groups.items()}
    return {key: torch.zeros(shape_fn(leaf.shape), dtype=dtype,
                             device=_local(named[leaf.members[0][0]]).device)
            for key, leaf in groups.items()}


def leaf_specs(params: Params) -> Optional[Mapping]:
    """The per-leaf specs of a distributed model, else None."""
    return getattr(params, "leaf_specs", None)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    moment_dtype: str = "float32"   # bf16 halves optimizer memory


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


def _schedule(cfg: AdamWConfig, step: int) -> float:
    warm = min(1.0, (step + 1) / max(cfg.warmup_steps, 1))
    return cfg.lr * warm


def _global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32 (a device
    scalar: no host sync). Over DTensors each tensor's sum is a pending
    (`Partial`) sum where the tensor is sharded and a whole one where it
    is replicated: the sums of one placement are added as they are, and
    each such total is reduced once, so every shard counts once."""
    sums = [torch.sum(torch.square(x.float())) for x in tree.values()]
    if not any(is_dtensor(x) for x in sums):
        return torch.sqrt(sum(sums))
    totals: Dict[object, torch.Tensor] = {}
    for x in sums:
        key = tuple(x.placements)
        totals[key] = x if key not in totals else totals[key] + x
    return torch.sqrt(sum(t.full_tensor() for t in totals.values()))


def adamw_init(cfg: AdamWConfig, params: Params) -> AdamWState:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    named, groups = named_params(params), groups_of(params)
    z = lambda: _zeros_like_leaves(groups, named, lambda s: s, dt,
                                   leaf_specs(params))
    return AdamWState(step=0, mu=z(), nu=z())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, params: Params) -> AdamWState:
    """One AdamW step with global-norm clipping and linear warmup; the
    parameters change in place."""
    named, groups = named_params(params), groups_of(params)
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    b1c = 1 - cfg.b1 ** float(step)
    b2c = 1 - cfg.b2 ** float(step)
    for key, leaf in groups.items():
        for name, idx in leaf.members:
            p = _local(named[name])
            m = _member(_local(state.mu[key]), idx, p.shape)
            v = _member(_local(state.nu[key]), idx, p.shape)
            g = _local(grads[name]).float() * scale
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
            delta = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
    return AdamWState(step=step, mu=state.mu, nu=state.nu)


# ----------------------------------------------------------------------
# Adafactor (factored second moment)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


class AdafactorState(NamedTuple):
    step: int
    vr: Tree    # row second moments (or the full moment for <2-D leaves)
    vc: Tree    # column second moments (or a (1,) placeholder)


def _rows(shape):
    return shape[:-1] if len(shape) >= 2 else shape


def _cols(shape):
    return shape[:-2] + shape[-1:] if len(shape) >= 2 else (1,)


def adafactor_init(cfg: AdafactorConfig, params: Params) -> AdafactorState:
    named, groups = named_params(params), groups_of(params)
    specs = leaf_specs(params)
    vr_specs = vc_specs = None
    if specs is not None:
        from ..sharding.rules import adafactor_state_specs
        st = adafactor_state_specs(
            AdafactorState(None, None, None), specs,
            {k: leaf.shape for k, leaf in groups.items()},
            next(iter(named.values())).device_mesh)
        vr_specs, vc_specs = st.vr, st.vc
    return AdafactorState(
        step=0,
        vr=_zeros_like_leaves(groups, named, _rows, torch.float32,
                              vr_specs),
        vc=_zeros_like_leaves(groups, named, _cols, torch.float32,
                              vc_specs))


def _spans_stack(leaf: Leaf) -> bool:
    """True where the reference's moments reach across the stacked axis
    (a stacked leaf of vectors or scalars): the leaf is then updated as
    one stacked tensor, else slice by slice."""
    return leaf.stacked and len(leaf.slice_shape) < 2


def _adafactor_moments(cfg, beta, g, vr, vc):
    """Update vr / vc in place from gradient g (the reference's layout);
    returns the unclipped update u."""
    g2 = g * g + cfg.eps
    if g.ndim >= 2:
        vr2 = beta * vr + (1 - beta) * g2.mean(-1)
        vc2 = beta * vc + (1 - beta) * g2.mean(-2)
        denom = (vr2[..., None] * vc2[..., None, :]
                 / torch.clamp(vr2.mean(-1, keepdim=True)[..., None],
                               min=cfg.eps))
        u = g * torch.rsqrt(torch.clamp(denom, min=cfg.eps))
        vc.copy_(vc2)
    else:
        vr2 = beta * vr + (1 - beta) * g2
        u = g * torch.rsqrt(torch.clamp(vr2, min=cfg.eps))
    vr.copy_(vr2)
    return u


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads: Mapping[str, torch.Tensor],
                     state: AdafactorState, params: Params
                     ) -> AdafactorState:
    """One Adafactor step; the parameters change in place. Moments, the
    factoring and the update-RMS clip follow the reference's leaves."""
    named, groups = named_params(params), groups_of(params)
    step = state.step + 1
    beta = 1.0 - float(step) ** (-cfg.decay)
    for key, leaf in groups.items():
        vr, vc = state.vr[key], state.vc[key]
        if _spans_stack(leaf):
            g = torch.stack([grads[n].float().reshape(leaf.slice_shape)
                             for n, _ in leaf.members])
            u = _adafactor_moments(cfg, beta, g, vr, vc)
            us = [u[i] for i in range(len(leaf.members))]
        else:
            us = []
            for name, idx in leaf.members:
                g = grads[name].float().reshape(leaf.slice_shape)
                pick = lambda t: t if idx is None else t[idx]
                us.append(_adafactor_moments(cfg, beta, g, pick(vr),
                                             pick(vc)))
        total = sum(torch.sum(u * u) for u in us)
        rms = torch.sqrt(total / math.prod(leaf.shape) + 1e-12)
        div = torch.clamp(rms / cfg.clip_threshold, min=1.0)
        for (name, _), u in zip(leaf.members, us):
            p = named[name]
            p32 = p.float()
            u = (u / div).reshape(p.shape)
            p.copy_(p32 - cfg.lr * u - cfg.lr * cfg.weight_decay * p32)
    return AdafactorState(step=step, vr=state.vr, vc=state.vc)


# ----------------------------------------------------------------------
# int8 gradient compression with error feedback
# ----------------------------------------------------------------------

class CompressionState(NamedTuple):
    residual: Tree    # error-feedback accumulator, per leaf


def compression_init(params: Params) -> CompressionState:
    named, groups = named_params(params), groups_of(params)
    return CompressionState(residual=_zeros_like_leaves(
        groups, named, lambda s: s, torch.float32, leaf_specs(params)))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    return _quantize(x, scale), scale


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_grads(grads: Mapping[str, torch.Tensor], comp: CompressionState,
                   params: Optional[Params] = None
                   ) -> Tuple[Dict[str, torch.Tensor], CompressionState]:
    """Quantize (grad + residual) to int8 with one scale per leaf of
    `params`'s geometry (one leaf per gradient without `params`); carry
    the quantization error into the residual. Returns the dequantized
    gradients (float32)."""
    groups = groups_of(params if params is not None else grads)
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in groups.items():
        res = _local(comp.residual[key])
        g32: List[torch.Tensor] = []
        for name, idx in leaf.members:
            g = _local(grads[name])
            g32.append(g.float() + _member(res, idx, g.shape))
        peak = torch.stack([x.abs().max() for x in g32]).max()
        g0 = grads[leaf.members[0][0]]
        if is_dtensor(g0):
            # the max over every shard of the leaf, one mesh dimension
            # after the other (a replica's max is its peers')
            import torch.distributed as dist
            mesh = g0.device_mesh
            for i in range(mesh.ndim):
                dist.all_reduce(peak, op=dist.ReduceOp.MAX,
                                group=mesh.get_group(i))
        scale = peak / 127.0 + 1e-12
        for (name, idx), x in zip(leaf.members, g32):
            dq = dequantize_int8(_quantize(x, scale), scale)
            _member(res, idx, x.shape).copy_(x - dq)
            out[name] = _like(dq, grads[name])
    return out, comp


def _like(local: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`local` as a shard of a DTensor placed as `ref`; as it is when
    `ref` is a plain tensor."""
    if not is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())
