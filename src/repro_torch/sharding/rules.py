"""Parameter / activation / cache partition rules (counterpart of
`repro.sharding.rules`), and their placements on a `DeviceMesh`.

Conventions (Megatron-style TP on the `model` axis, DP over `pod`+`data`,
optional FSDP over `data`, EP = experts on `model`):

  embed.table        (V, D)      -> ("model", fsdp)      vocab-parallel
  lm_head.w          (D, V)      -> (fsdp, "model")      column-parallel
  attn.wq/wk/wv      (D, H, dh)  -> (fsdp, "model", -)   heads sharded
  attn.wo            (H, dh, D)  -> ("model", -, fsdp)   row-parallel
  ffn.wg/wu          (D, F)      -> (fsdp, "model")
  ffn.wd             (F, D)      -> ("model", fsdp)
  moe.w*             (E, D, F)   -> ("model", fsdp, -)   expert-parallel
  rnn in/out         (D, R)/(R, D) -> channel dim on "model"
  norms/scalars                  -> replicated

Every rule is guarded by divisibility: an axis that does not divide its
dimension is dropped to None (2 KV heads on a 4-way model axis ->
replicated KV).

The specs are the reference's: `param_specs` is keyed by the reference's
leaf path ("scan.0.attn.wq", `models.leaves`) and decided on the
reference's leaf shape, where heads are an axis of their own and each
repeated period of the depth plan is stacked along a leading axis (which
gets None). `port_layout` then maps each spec onto the port's parameters:
the stacked axis falls away, and the reference's (d, H, hd) becomes the
port's (d, H*hd), sharded where the reference shards H. Where a
reference spec shards an axis that the port's layout merges behind an
unsharded one (sLSTM's `wx`, (d, 4, H, dh) in the reference, (d, 4*H*dh)
in the port), the port cannot hold that shard and replicates the leaf on
that mesh axis; its optimizer state does the same.

A mesh is anything with axis names and sizes: a `launch.mesh.DeviceGrid`,
a `torch.distributed.device_mesh.DeviceMesh`, or a stand-in with
`axis_names` and a `shape` mapping. `to_placements` gives the `Shard` /
`Replicate` list of a spec on a `DeviceMesh`, one entry per mesh
dimension.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Sequence, Tuple

from ..models.config import ModelConfig
from ..models.leaves import leaf_groups


class PartitionSpec(tuple):
    """One entry per tensor dimension: None, a mesh axis name, or a tuple
    of names (the counterpart of `jax.sharding.PartitionSpec`, which reads
    a tuple of one name as that name, and an empty one as None)."""

    def __new__(cls, *axes):
        canon = lambda a: (a[0] if len(a) == 1 else a or None) \
            if isinstance(a, (tuple, list)) else a
        return super().__new__(cls, tuple(canon(a) for a in axes))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec
Specs = Dict[str, PartitionSpec]


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return {n: int(shape[n]) for n in names}
    return dict(zip(names, (int(s) for s in shape)))


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _axis_size(axes: Mapping[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(axes[a] for a in axis)
    return axes[axis]


def with_divisibility(spec, shape: Sequence[int], mesh) -> PartitionSpec:
    """Drop spec axes that don't divide their dimension."""
    axes = mesh_axes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return P(*(a if a is not None and dim % _axis_size(axes, a) == 0
               else None for dim, a in zip(shape, spec)))


# (path regex, base spec builder). `f` = fsdp axis or None; specs are for
# the UNSTACKED leaf; stacking prepends a None.
def _rules(f):
    return [
        (r"embed/table$",        lambda: P("model", f)),
        (r"lm_head/w$",          lambda: P(f, "model")),
        (r"pos/pos$",            lambda: P(None, None)),
        (r"(attn|xattn)/w[qkv]$", lambda: P(f, "model", None)),
        (r"(attn|xattn)/wo$",    lambda: P("model", None, f)),
        (r"(attn|xattn)/b[qkv]$", lambda: P("model", None)),
        (r"ffn/w[gu]$",          lambda: P(f, "model")),
        (r"ffn/wd$",             lambda: P("model", f)),
        (r"ffn/b[u]$",           lambda: P("model")),
        (r"ffn/bd$",             lambda: P(None)),
        (r"moe/router$",         lambda: P(None, None)),
        (r"moe/w[gu]$",          lambda: P("model", f, None)),
        (r"moe/wd$",             lambda: P("model", None, f)),
        (r"moe/shared/w[gu]$",   lambda: P(f, "model")),
        (r"moe/shared/wd$",      lambda: P("model", f)),
        # mLSTM
        (r"cell/w[qkv]$",        lambda: P(f, "model", None)),
        (r"cell/wif$",           lambda: P(None, "model", None)),
        (r"cell/wog$",           lambda: P(f, "model")),
        (r"cell/wo$",            lambda: P("model", f)),
        (r"cell/ln_scale$",      lambda: P("model", None)),
        # sLSTM
        (r"cell/wx$",            lambda: P(f, None, "model", None)),
        (r"cell/rh$",            lambda: P(None, "model", None, None)),
        # RG-LRU
        (r"rec/w_in$",           lambda: P(f, "model")),
        (r"rec/w_gate$",         lambda: P(f, "model")),
        (r"rec/conv$",           lambda: P(None, "model")),
        (r"rec/conv_b$",         lambda: P("model")),
        (r"rec/w[a-z]*g?$",      lambda: P(None, "model")),   # wa, wxg
        (r"rec/lam$",            lambda: P("model")),
        (r"rec/w_out$",          lambda: P("model", f)),
        # norms & anything residual: replicated
        (r"(ln\d?|lnx|final_norm)/(scale|bias)$", lambda: P()),
    ]


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    """{port parameter name: shape} of a model or a name -> tensor map."""
    named = params.named_parameters() if hasattr(params, "named_parameters") \
        else params.items()
    return {n: tuple(t.shape) for n, t in named}


def param_specs(params, cfg: ModelConfig, mesh, fsdp: bool = False
                ) -> Specs:
    """{reference leaf path: PartitionSpec} over the port's model `params`
    (any device, the meta device included): the reference's table, leaf
    for leaf, decided on the reference's leaf shapes."""
    f = "data" if (fsdp and "data" in mesh_axes(mesh)) else None
    rules = [(re.compile(rx), mk) for rx, mk in _rules(f)]
    out = {}
    for key, leaf in leaf_groups(cfg, _shapes(params)).items():
        ps = key.replace(".", "/")
        base = next((mk() for rx, mk in rules if rx.search(ps)), P())
        if "/scan/" in "/" + ps + "/":
            base = P(None, *base)
        out[key] = with_divisibility(base, leaf.shape, mesh)
    return out


def _merge_groups(ref_shape: Sequence[int], port_shape: Sequence[int]):
    """The reference dimensions each port dimension merges (row-major)."""
    groups, i = [], 0
    for n in port_shape:
        group, size = [], 1
        while i < len(ref_shape) and (not group or size < n):
            size *= ref_shape[i]
            group.append(i)
            i += 1
        if size != n:
            raise ValueError(f"port shape {tuple(port_shape)} is no merge "
                             f"of the reference's {tuple(ref_shape)}")
        groups.append(group)
    if groups:
        groups[-1].extend(range(i, len(ref_shape)))   # trailing size-1 dims
    return groups


def _drop(spec, axes) -> PartitionSpec:
    def keep(a):
        if isinstance(a, tuple):
            a = tuple(x for x in a if x not in axes)
            return a or None
        return None if a in axes else a
    return P(*(keep(a) for a in spec))


def port_layout(params, cfg: ModelConfig, mesh, fsdp: bool = False
                ) -> Tuple[Specs, Specs]:
    """(specs of the port's parameters by name, over the port's shapes;
    specs of the reference leaves as the port holds them). The second
    equals `param_specs` except where a port parameter cannot hold the
    reference's shard (module docstring); the optimizer's per-leaf state
    takes it."""
    shapes = _shapes(params)
    groups = leaf_groups(cfg, shapes)
    ref = param_specs(params, cfg, mesh, fsdp)
    by_name, by_leaf = {}, {}
    for key, leaf in groups.items():
        spec = tuple(ref[key]) + (None,) * (len(leaf.shape) - len(ref[key]))
        lead = spec[:1] if leaf.stacked else ()
        body = spec[1:] if leaf.stacked else spec
        mapped, dropped = {}, set()
        for name, _ in leaf.members:
            out = []
            for g in _merge_groups(leaf.slice_shape, shapes[name]):
                out.append(body[g[0]])
                for j in g[1:]:
                    a = body[j]
                    if a is not None:
                        dropped.update(a if isinstance(a, tuple) else (a,))
            mapped[name] = out
        for name, out in mapped.items():
            by_name[name] = _drop(P(*out), dropped)
        by_leaf[key] = _drop(P(*(lead + body)), dropped)
    return by_name, by_leaf


def batch_specs(batch: Mapping[str, object], mesh) -> Specs:
    """Inputs: shard the batch dim over (pod, data); replicate the rest."""
    dp = dp_axes_of(mesh)
    out = {}
    for k, leaf in batch.items():
        shape = tuple(leaf.shape)
        out[k] = P() if not shape else with_divisibility(
            P(dp, *([None] * (len(shape) - 1))), shape, mesh)
    return out


def reference_cache_shapes(cache, cfg: ModelConfig
                           ) -> Dict[str, Tuple[int, ...]]:
    """{reference cache path: shape} of a port cache ({"layers": [...]}):
    the repeated periods' entries stacked along a leading axis, as the
    reference's scanned cache is. An int write position is a scalar."""
    from ..models.leaves import reference_leaf
    out: Dict[str, Tuple[int, ...]] = {}
    for i, c in enumerate(cache["layers"]):
        for k, v in c.items():
            key, idx = reference_leaf(f"layers.{i}.{k}", cfg)
            shape = tuple(getattr(v, "shape", ()))
            if idx is None:
                out[key] = shape
            else:
                out[key] = (max(idx + 1, out.get(key, (0,))[0]),) + shape
    return out


def cache_specs(cache, cfg: ModelConfig, mesh) -> Specs:
    """{reference cache path: spec} of a port cache. Decode caches: batch
    over DP; KV heads over model when divisible, else KV *sequence* over
    model (flash-decode style), else replicated. Recurrent states:
    channel/head dim over model."""
    dp = dp_axes_of(mesh)
    msize = mesh_axes(mesh)["model"]
    out = {}
    for key, shape in reference_cache_shapes(cache, cfg).items():
        ps = key.replace(".", "/")
        nd = len(shape)
        stacked = ps.startswith("scan/")
        if nd == 0 or ps.endswith("idx"):
            spec = P()
        elif ps.endswith("/pos"):
            spec = P(None)
        elif re.search(r"/(k|v)$", ps) and nd in (4, 5):
            lead = (None,) if nd == 5 else ()
            _, S, Hkv, _ = shape[-4:]
            if Hkv % msize == 0:
                spec = P(*lead, dp, None, "model", None)
            elif S % msize == 0:
                spec = P(*lead, dp, "model", None, None)
            else:
                spec = P(*lead, dp, None, None, None)
            spec = with_divisibility(spec, shape, mesh)
        elif re.search(r"/(C|n|m|h|c)$", ps):
            s = [None] * nd
            bpos = 1 if stacked else 0
            if bpos < nd:
                s[bpos] = dp
            if bpos + 1 < nd:
                s[bpos + 1] = "model"
            spec = with_divisibility(P(*s), shape, mesh)
        elif ps.endswith("/conv"):
            s = [None] * nd
            s[1 if stacked else 0] = dp
            s[nd - 1] = "model"
            spec = with_divisibility(P(*s), shape, mesh)
        else:
            spec = P(*([None] * nd))
        out[key] = spec
    return out


def adafactor_state_specs(aopt, pspecs: Specs,
                          shapes: Mapping[str, Sequence[int]], mesh):
    """Specs for AdafactorState(step, vr, vc) by reference leaf: the
    factored moments keep their parameter's spec minus the factored-out
    axis (vr drops the last dim, vc the second-to-last). `shapes` are the
    reference leaf shapes (`models.leaves.Leaf.shape`)."""
    def vr_spec(spec, shape):
        t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        if len(shape) >= 2:
            return with_divisibility(P(*t[:-1]), shape[:-1], mesh)
        return with_divisibility(P(*t), shape, mesh)

    def vc_spec(spec, shape):
        if len(shape) >= 2:
            t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
            return with_divisibility(P(*(t[:-2] + (t[-1],))),
                                     tuple(shape[:-2]) + tuple(shape[-1:]),
                                     mesh)
        return with_divisibility(P(None), (1,), mesh)

    return type(aopt)(
        step=P(),
        vr={k: vr_spec(s, tuple(shapes[k])) for k, s in pspecs.items()},
        vc={k: vc_spec(s, tuple(shapes[k])) for k, s in pspecs.items()})


def to_placements(spec, mesh) -> Tuple[object, ...]:
    """The DTensor placements of `spec` on `mesh`: per mesh dimension,
    `Shard(i)` where tensor dim i is sharded over it, else `Replicate()`.
    A tuple entry shards its dimension over several mesh axes in mesh
    order, as the reference's does."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for i, a in enumerate(tuple(spec)):
        for name in (a if isinstance(a, tuple) else (a,)):
            if name is not None:
                out[names.index(name)] = Shard(i)
    return tuple(out)


def place(t, mesh, placements):
    """Whole tensor `t`, the same on every rank, as a DTensor on `mesh`
    with `placements`: each rank keeps its slice, no communication."""
    from torch.distributed.tensor import DTensor, Replicate
    whole = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(placements=tuple(placements))


def distribute_model(model, mesh, fsdp: bool = False):
    """Make each parameter of `model` a DTensor on DeviceMesh `mesh`,
    placed by `port_layout` (the reference's `param_specs`, with `fsdp`).
    Every rank holds the same whole model on its device (drawn from the
    same seed, or restored), so placing is a local slice: no
    communication. The mesh and the per-leaf specs stay on the model
    (`device_mesh`, `leaf_specs`) for the optimizer state and the
    checkpoints. Returns the model."""
    from torch import nn
    by_name, by_leaf = port_layout(model, model.cfg, mesh, fsdp)
    for mname, mod in model.named_modules():
        for pn, p in list(mod.named_parameters(recurse=False)):
            name = f"{mname}.{pn}" if mname else pn
            d = place(p.detach(), mesh, to_placements(by_name[name], mesh))
            setattr(mod, pn, nn.Parameter(d, requires_grad=p.requires_grad))
    model.device_mesh = mesh
    model.leaf_specs = by_leaf
    return model


def distribute_batch(batch: Mapping[str, object], mesh) -> Dict[str, object]:
    """Each input of `batch` (the same whole tensors on every rank) as a
    DTensor on `mesh`, placed by `batch_specs`: a local slice. A dimension
    of size 1 (a batch of one) stays whole, as `models.layers._Grid` keeps
    it: there is nothing to split, and DTensor cannot flatten a sharded
    dimension of size 1 into a product."""
    from torch.distributed.tensor import Replicate, Shard
    specs = batch_specs(batch, mesh)
    out = {}
    for k, v in batch.items():
        pl = [Replicate() if isinstance(p, Shard) and v.shape[p.dim] == 1
              else p for p in to_placements(specs[k], mesh)]
        out[k] = place(v, mesh, pl)
    return out


def distribute_cache(cache, cfg: ModelConfig, mesh):
    """A port decode cache ({"layers": [...]}, the same whole tensors on
    every rank) with each tensor a DTensor on DeviceMesh `mesh`, placed by
    `cache_specs` (a repeated period's entry takes its stacked leaf's spec
    less the stacked axis): a local slice, no communication. The write
    positions ("idx") stay host ints. Returns a new cache; the layers run
    their decode step on the local shards (`layers.attention_apply`)."""
    import torch

    from ..models.leaves import reference_leaf
    specs = cache_specs(cache, cfg, mesh)
    layers = []
    for i, c in enumerate(cache["layers"]):
        placed = {}
        for k, v in c.items():
            if not isinstance(v, torch.Tensor):
                placed[k] = v
                continue
            key, idx = reference_leaf(f"layers.{i}.{k}", cfg)
            spec = tuple(specs[key])[(0 if idx is None else 1):]
            placed[k] = place(v, mesh, to_placements(P(*spec), mesh))
        layers.append(placed)
    return {"layers": layers}
