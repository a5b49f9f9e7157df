"""Device grids: a small named-axis array of devices (counterpart of
`repro.launch.mesh`, and of `jax.make_mesh` as this package uses it).

A `DeviceGrid` is what `core.distributed` and the services take as their
`mesh`: `axis_names`, a `shape` mapping each name to its extent, and a
`devices` array of `torch.device`. The axes named "pod" or "data" are the
data-parallel ones; "model" only repeats a shard. One process drives every
device of the grid. A grid may name one device more than once (repeated
`cpu` entries in tests; two shards on one card), and each entry is its own
shard, run from its own thread.

Multi-device training runs one process per grid entry instead
(`torchrun`): `init_distributed` starts the process group, and
`device_mesh` turns a grid's shape and axis names into a
`torch.distributed.device_mesh.DeviceMesh` over the world's ranks, rank r
on the grid's r-th entry in row-major order. `make_production_mesh`
builds the reference's 16x16-per-pod grid over meta devices, for
accounting that needs the shape and no device.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class DeviceGrid:
    """A named-axis grid of devices."""

    def __init__(self, devices: Sequence[DeviceLike],
                 axis_shapes: Sequence[int], axis_names: Sequence[str]):
        axis_shapes = tuple(int(n) for n in axis_shapes)
        axis_names = tuple(axis_names)
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f"{len(axis_shapes)} axis extents for "
                             f"{len(axis_names)} axis names")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        flat = [torch.device(d) for d in devices]
        if len(flat) != int(np.prod(axis_shapes)) or not flat:
            raise ValueError(f"a grid of shape {axis_shapes} needs "
                             f"{int(np.prod(axis_shapes))} devices, got "
                             f"{len(flat)}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(axis_shapes)
        self.axis_names: Tuple[str, ...] = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, axis_shapes))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"DeviceGrid({self.shape}, [{devs}])"


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              devices: Sequence[DeviceLike]) -> DeviceGrid:
    """A grid of `axis_shapes` over `devices`, row-major (the counterpart
    of `jax.make_mesh`, with the devices named: a list may repeat one)."""
    return DeviceGrid(devices, axis_shapes, axis_names)


def make_smoke_mesh(n_devices: int = 0, model: int = 2,
                    device_type: str = "cuda") -> DeviceGrid:
    """A ("data", "model") grid of `n_devices` entries (default: every
    visible card), `model` of them along "model". Raises without a card
    unless `device_type="cpu"`, which repeats the CPU `n_devices` times."""
    if device_type == "cpu":
        devices = [torch.device("cpu")] * n_devices
    elif device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a grid on the CPU")
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devices)} visible")
        devices = devices[:n_devices or len(devices)]
    n = len(devices)
    if n % model or n < model:
        raise ValueError(f"{n} devices do not split into rows of "
                         f"model={model}")
    return make_mesh((n // model, model), ("data", "model"), devices)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceGrid:
    """16x16 = 256 chips per pod; 2 pods = 512 chips for the multi-pod
    case. Axes: (pod,) data, model. Over meta devices: it is built, not
    run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, [torch.device("meta")] * int(np.prod(shape)))


def init_distributed(backend: str = "nccl",
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Tuple[int, int]:
    """Start this process's default process group (once) and return
    (rank, world size). Without arguments it reads what `torchrun` sets
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); a `file://` or
    `tcp://host:port` init method with an explicit rank and world size
    needs no environment. Under "nccl" the process takes the card
    LOCAL_RANK names (default: its rank); nothing falls back to another
    backend."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        if world_size is None:
            world_size = int(os.environ.get("WORLD_SIZE", 1))
        if init_method is None and "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                "no init_method and no MASTER_ADDR: start the process "
                "with torchrun, or pass init_method='tcp://127.0.0.1:<port>'"
                " (or 'file://<path>') with rank and world_size")
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("the nccl backend needs a CUDA device")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    return dist.get_rank(), dist.get_world_size()


def device_mesh(grid: DeviceGrid):
    """The `DeviceMesh` of `grid` over the started world: the grid's axis
    names and extents, rank r on the r-th entry (row-major). The world
    size must equal the grid's size, and this process must sit on its
    own entry's device."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    if dist.get_world_size() != grid.size:
        raise ValueError(f"a grid of {grid.size} entries needs a world of "
                         f"{grid.size} ranks, not {dist.get_world_size()}")
    kinds = {d.type for d in grid.devices.flat}
    if len(kinds) != 1:
        raise ValueError(f"a grid mixes device types {sorted(kinds)}")
    shape = tuple(grid.shape[a] for a in grid.axis_names)
    return DeviceMesh(kinds.pop(), torch.arange(grid.size).reshape(shape),
                      mesh_dim_names=grid.axis_names)
