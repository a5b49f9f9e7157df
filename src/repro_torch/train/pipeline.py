"""GPipe-style pipeline parallelism over a mesh axis (counterpart of
`repro.train.pipeline`), one process per stage.

The layer stack splits into S stages along the `pipe` axis of a
`DeviceMesh`: stage s holds layers [s*L/S, (s+1)*L/S). M microbatches
stream through in the classic GPipe schedule of M + S - 1 ticks (bubble
fraction (S-1)/(M+S-1)). At every tick each stage runs its layers on what
it holds, then every stage passes its output to the next at once (the
reference's `ppermute`; here a send and a receive posted together). Stage
0 takes microbatch t instead of what it received; only the last stage's
outputs are real, and a sum over the axis hands them to every rank.

Differentiable end to end: the backward of a tick's exchange is the same
exchange the other way, and every rank's graph has the same chain of
exchanges, so the ranks run their backward exchanges in the same order.
What a stage does not use (stage 0 what it received, the other stages the
microbatches and, but for the last, their outputs) stays in its graph at
weight 0, and the last tick's outputs are not exchanged at all, so no
rank waits on a peer that skipped one.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..sharding.comms import all_sum

Tree = object


class _Shift(torch.autograd.Function):
    """Each rank of `group` sends x to the next rank (cyclically) and
    returns what the previous one sent; the backward shifts the gradient
    the other way."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.step), None, None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    peer = lambda r: dist.get_global_rank(group, r % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer(me + step), group),
        dist.P2POp(dist.irecv, out, peer(me - step), group)])
    for r in reqs:
        r.wait()
    return out


class _Replicated(torch.autograd.Function):
    """A tensor every rank of `group` holds alike: the identity forward,
    and its gradient summed over the ranks, each of which used a part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _stage_slice(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This stage's layers of stacked leaf `t` (leading axis = layers). A
    DTensor is resharded to Shard(0) over `axis` and its local part taken
    (its gradient comes back sharded so); a plain tensor, the same on
    every rank, is sliced, its gradient summed over the stages."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = list(mesh.mesh_dim_names)
    i = names.index(axis)
    S, s = mesh.size(i), mesh.get_local_rank(i)
    if t.shape[0] % S:
        raise ValueError(f"{t.shape[0]} layers do not split into {S} "
                         f"stages")
    if isinstance(t, DTensor):
        pl = [Shard(0) if j == i else Replicate() for j in range(mesh.ndim)]
        return t.redistribute(placements=pl).to_local()
    n = t.shape[0] // S
    t = _Replicated.apply(t, mesh.get_group(i)) if t.requires_grad else t
    return t[s * n:(s + 1) * n]


def pipeline_apply(stage_fn: Callable, stacked_params: Tree,
                   x: torch.Tensor, mesh, n_microbatches: int,
                   axis: str = "pipe") -> torch.Tensor:
    """Run x (B, ...) through the pipelined layer stack on DeviceMesh
    `mesh`; every rank calls it alike and gets the whole output.

    stage_fn(stage_params, h) applies one stage's layers (its leaves have
    a leading per-stage layer axis). stacked_params leaves have a leading
    TOTAL layer axis divisible by the axis size: DTensors (resharded so
    each stage holds only its layers) or plain tensors held alike by every
    rank (each stage slices its layers). x is held alike by every rank;
    its gradient, and a plain leaf's, is summed over the stages."""
    names = list(mesh.mesh_dim_names)
    i = names.index(axis)
    S, sid = mesh.size(i), mesh.get_local_rank(i)
    group = mesh.get_group(i)
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError(f"batch {B} does not split into {n_microbatches} "
                         f"microbatches")
    M = n_microbatches
    params = _map(lambda t: _stage_slice(t, mesh, axis), stacked_params)
    if x.requires_grad:
        x = _Replicated.apply(x, group)
    mbs = x.reshape(M, B // M, *x.shape[1:])

    recv = torch.zeros_like(mbs[0])
    outs = []
    for t in range(M + S - 1):
        # stage 0 injects microbatch t (clipped; masked out below); what a
        # stage does not use stays in its graph at weight 0, so that every
        # rank runs the same backward collectives
        mb = mbs[min(t, M - 1)]
        x_in = mb + 0 * recv if sid == 0 else recv + 0 * mb
        h = stage_fn(params, x_in)
        if S - 1 <= t:            # the last stage finishes microbatch t-S+1
            outs.append(h if sid == S - 1 else 0 * h)
        if t < M + S - 2:
            recv = _Shift.apply(h, group, 1) if S > 1 else h
    out = torch.stack(outs)
    if S > 1:
        out = all_sum(out, group)
    return out.reshape(B, *x.shape[1:])


def sequential_reference(stage_fn: Callable, stacked_params: Tree,
                         x: torch.Tensor, n_stages: int) -> torch.Tensor:
    """The math the pipeline must reproduce: apply all stages in order."""
    h = x
    for s in range(n_stages):
        p_s = _map(lambda a: a[s * (a.shape[0] // n_stages):
                               (s + 1) * (a.shape[0] // n_stages)],
                   stacked_params)
        h = stage_fn(p_s, h)
    return h
