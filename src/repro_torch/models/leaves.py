"""Where each parameter of the port sits in the reference's parameter
tree.

The port keeps one module per layer in depth order and stores attention
and mLSTM/sLSTM projections as 2-D matrices. The reference stacks each
repeated period of its depth plan along a leading axis (its "scan" leaves)
and keeps heads as their own axis. Reductions that the reference runs over
one whole leaf (the int8 compression scale, Adafactor's factored moments
and its update-RMS clip) must run over that geometry, and converting
weights or optimizer state across needs the same map.

`reference_leaf(name, cfg)` gives the reference leaf of a port parameter
and its index along the stacked axis; `reference_slice_shape` the shape of
that slice in the reference's layout (the same numbers in row-major
order); `leaf_groups` gathers the port's parameters into the reference's
leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's parameter tree.

    `key` is its dotted path ("scan.0.attn.wq"), `shape` its shape in the
    reference's layout (the stacked axis first when `stacked`), and
    `members` the port parameters it holds, as (port name, index along the
    stacked axis or None), in index order."""
    key: str
    shape: Tuple[int, ...]
    stacked: bool
    members: Tuple[Tuple[str, Optional[int]], ...]

    @property
    def slice_shape(self) -> Tuple[int, ...]:
        return self.shape[1:] if self.stacked else self.shape


def _depth(cfg: ModelConfig) -> Tuple[int, int, int]:
    from .transformer import DepthPlan
    plan = DepthPlan(cfg)
    return len(plan.prefix), plan.n_rep, len(plan.period_kinds)


def reference_leaf(name: str, cfg: ModelConfig) -> Tuple[str, Optional[int]]:
    """(dotted path of the reference leaf, index along its stacked axis or
    None) of port parameter `name`. Decoder layer i is the reference's
    prefix layer i, then repeat r of period slot j of "scan", then the
    suffix layers; every other parameter keeps its path."""
    head, _, rest = name.partition(".")
    if head != "layers":
        return name, None
    i, _, rest = rest.partition(".")
    i = int(i)
    n_pre, n_rep, period = _depth(cfg)
    if i < n_pre:
        return f"prefix.{i}.{rest}", None
    i -= n_pre
    if i < n_rep * period:
        r, j = divmod(i, period)
        return f"scan.{j}.{rest}", r
    return f"suffix.{i - n_rep * period}.{rest}", None


def reference_slice_shape(name: str, shape: Sequence[int],
                          cfg: ModelConfig) -> Tuple[int, ...]:
    """The reference's shape of port parameter `name` (port shape
    `shape`): attention's wq / wk / wv (d, heads, hd) and wo (heads, hd,
    d), mLSTM's wq / wk / wv (d, H, dh), sLSTM's wx (d, 4, H, dh); every
    other parameter has the port's shape."""
    owner, _, leaf = name.rpartition(".")
    parent = owner.rpartition(".")[2]
    d = cfg.d_model
    if parent in ("attn", "xattn"):
        hd = cfg.head_dim
        heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads,
                 "wv": cfg.n_kv_heads}
        if leaf in heads:
            return (d, heads[leaf], hd)
        if leaf == "wo":
            return (cfg.n_heads, hd, d)
    elif parent == "cell":
        H = cfg.n_heads
        if leaf in ("wq", "wk", "wv"):
            return (d, H, d // H)
        if leaf == "wx":
            return (d, 4, H, d // H)
    return tuple(shape)


def leaf_groups(cfg: ModelConfig, shapes: Mapping[str, Sequence[int]]
                ) -> Dict[str, Leaf]:
    """The reference's leaves over the port parameters `shapes` (name ->
    port shape), in the order of their first member."""
    found: Dict[str, List[Tuple[str, Optional[int]]]] = {}
    slices: Dict[str, Tuple[int, ...]] = {}
    for name, shape in shapes.items():
        key, idx = reference_leaf(name, cfg)
        found.setdefault(key, []).append((name, idx))
        slices[key] = reference_slice_shape(name, shape, cfg)
    out = {}
    for key, members in found.items():
        stacked = members[0][1] is not None
        members.sort(key=lambda m: -1 if m[1] is None else m[1])
        if stacked and [m[1] for m in members] != list(range(len(members))):
            raise ValueError(f"{key}: stacked members {members} do not "
                             f"cover 0..{len(members) - 1}")
        shape = ((len(members),) if stacked else ()) + slices[key]
        out[key] = Leaf(key, shape, stacked, tuple(members))
    return out


def identity_groups(shapes: Mapping[str, Sequence[int]]) -> Dict[str, Leaf]:
    """Each parameter its own leaf (a plain parameter dict, no model)."""
    return {name: Leaf(name, tuple(shape), False, ((name, None),))
            for name, shape in shapes.items()}
