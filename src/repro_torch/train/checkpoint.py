"""Topology-agnostic checkpointing (counterpart of
`repro.train.checkpoint`, the same on-disk protocol).

Layout: <dir>/step_<N>/
    manifest.json      — step, flat key -> (shape, dtype, file), extra
    <key-hash>.npz     — one `savez_compressed` file per leaf, named by
                         the sha1 of its flattened key
    _COMMITTED         — atomic commit marker (written last)

A tree is nested dicts, lists/tuples and NamedTuples of tensors (numpy
arrays and Python ints too); keys join the path with "/", a NamedTuple's
fields as ".<field>" as the reference's keys do. Leaves are saved whole
and on the host, so a restart may use another device. bfloat16 is stored
as its uint16 bits with "bfloat16" as the manifest's dtype (numpy has no
bfloat16). Writes go to a temp dir that is renamed when complete; `keep`
rotates old checkpoints; `latest_step` scans the markers only, so the
reference's `latest_step` / `committed_steps` read a directory written
here.

Elastic: a DTensor leaf is saved as its logical, whole tensor
(`full_tensor()`, which every rank of its mesh joins), written once, by
rank 0 of the world, so a checkpoint holds the same bytes whatever grid
wrote it. `restore(..., shardings=)` places each leaf onto a (possibly
other) grid: a tree of `(DeviceMesh, placements)` entries beside
`tree_like`. A checkpoint of the single-device loop restores onto a grid,
and one written on a grid restores onto one device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..models.layers import plain
from ..sharding.rules import place

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_sharding(x) -> bool:
    """A `(DeviceMesh, placements)` entry of a `shardings` tree."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[0], DeviceMesh)


def _flatten(tree: Tree, prefix: str = "",
             is_leaf=lambda x: False) -> Dict[str, Any]:
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    flat: Dict[str, Any] = {}
    if is_leaf(tree):
        flat[prefix] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, join(k), is_leaf))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            flat.update(_flatten(getattr(tree, k), join(f".{k}"), is_leaf))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, join(i), is_leaf))
    else:
        flat[prefix] = tree
    return flat


def _unflatten(tree_like: Tree, loaded: Dict[str, Any], prefix: str = ""):
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, loaded, join(k))
                for k, v in tree_like.items()}
    if _is_namedtuple(tree_like):
        return type(tree_like)(**{
            k: _unflatten(getattr(tree_like, k), loaded, join(f".{k}"))
            for k in tree_like._fields})
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, loaded, join(i))
                               for i, v in enumerate(tree_like))
    return loaded[prefix]


def _key_file(key: str) -> str:
    return hashlib.sha1(key.encode()).hexdigest()[:16] + ".npz"


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str | Path, step: int, tree: Tree,
         extra: Optional[dict] = None, keep: int = 3) -> Path:
    """Write `tree` as step `step`. In a started process group every rank
    calls it (each DTensor leaf is gathered whole) and rank 0 writes; the
    others wait until the checkpoint is committed."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    writer = not _distributed() or torch.distributed.get_rank() == 0
    if not writer:
        for leaf in _flatten(tree).values():
            plain(leaf)
        torch.distributed.barrier()
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(plain(leaf))
        fname = _key_file(key)
        np.savez_compressed(tmp / fname, arr=arr)
        manifest["leaves"][key] = {"shape": list(arr.shape),
                                   "dtype": dtype, "file": fname}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    (tmp / "_COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    # rotate
    steps = sorted(committed_steps(ckpt_dir))
    for old in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{old:08d}", ignore_errors=True)
    if _distributed():
        torch.distributed.barrier()
    return final


def committed_steps(ckpt_dir: str | Path):
    ckpt_dir = Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / "_COMMITTED").exists():
            out.append(int(d.name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return max(steps) if steps else None


def _from_numpy(arr: np.ndarray, dtype: str, like, dev: torch.device):
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if isinstance(like, torch.Tensor):
        t = t.to(like.dtype)
    return t.to(dev)


def shardings_of(tree: Tree) -> Tree:
    """The `shardings` tree of `tree`: `(mesh, placements)` beside each
    DTensor leaf, None beside any other."""
    from torch.distributed.tensor import DTensor
    return _unflatten(tree, {
        k: (v.device_mesh, tuple(v.placements))
        if isinstance(v, DTensor) else None
        for k, v in _flatten(tree).items()})


def restore(ckpt_dir: str | Path, tree_like: Tree,
            step: Optional[int] = None, device: DeviceLike = None,
            shardings: Optional[Tree] = None) -> Tuple[Tree, dict]:
    """Restore into the structure of `tree_like` (its tensors may be on
    the meta device or DTensors): each tensor leaf is cast to the dtype of
    its `tree_like` leaf and placed on `device` (default: the card); an
    int leaf comes back as an int. `shardings`, a tree beside `tree_like`
    whose entries are `(DeviceMesh, placements)` (or None), places those
    leaves as DTensors instead: every rank reads the whole leaf and keeps
    its shard. Returns (tree, extra)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat_like = _flatten(tree_like)
    placed = _flatten(shardings, is_leaf=_is_sharding) \
        if shardings is not None else {}
    dev = None
    loaded = {}
    for key, like in flat_like.items():
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(d / ent["file"])["arr"]
        sharding = placed.get(key)
        if sharding is not None and isinstance(like, torch.Tensor):
            mesh, placements = sharding
            t = _from_numpy(arr, ent["dtype"], like,
                            torch.device(mesh.device_type))
            loaded[key] = place(t, mesh, placements)
        else:
            if dev is None and not isinstance(like, int):
                dev = resolve(device)
            loaded[key] = _from_numpy(arr, ent["dtype"], like, dev)
    return _unflatten(tree_like, loaded), manifest["extra"]
