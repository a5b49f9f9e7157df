"""Device grids: a small named-axis array of devices (counterpart of
`repro.launch.mesh`, and of `jax.make_mesh` as this package uses it).

A `DeviceGrid` is what `core.distributed` and the services take as their
`mesh`: `axis_names`, a `shape` mapping each name to its extent, and a
`devices` array of `torch.device`. The axes named "pod" or "data" are the
data-parallel ones; "model" only repeats a shard. One process drives every
device of the grid. A grid may name one device more than once (repeated
`cpu` entries in tests; two shards on one card), and each entry is its own
shard, run from its own thread.

The 16x16 production pods of the reference (`make_production_mesh`) are
not built here: the dry-run that needs them is not ported.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

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
