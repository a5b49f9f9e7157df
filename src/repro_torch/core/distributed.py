"""Data-parallel CMAX: estimate many event windows across devices
(counterpart of `repro.core.distributed`).

Fleet-scale workloads (dataset-wide motion ground-truthing, sweeps over
tau/step schedules, multi-camera rigs, and the batched estimation service
in launch/serve.py) batch many independent windows — a pure data-parallel
problem. Windows shard over the (pod, data) axes of a `DeviceGrid`
(launch/mesh.py): each data-parallel index gets one contiguous shard of the
leading axis and runs it on the grid's device at model index 0 (devices
along "model" only repeat a shard in the reference, so they run nothing
here).

One process drives every device, as the reference's shard_map does, so
the service's `CmaxWorkload(mesh=...)` can sit behind one executable. Each
shard runs from its own worker thread under its own CUDA stream: the
residence loop reads a stop flag back from the device once per iteration,
so shards run one after another on one thread would serialize the cards.
A shard's stream first waits for the caller's stream (an event recorded at
the call), and every tensor it reads is marked as used by that stream
(`record_stream`). Results are gathered onto the grid's first device in
slot order, after the caller's stream has waited on each shard's end
event. There are no collectives and no float reductions across shards, so
each window's result is that of the local path. Each shard's residence
loop runs on the CUDA graphs of its own class (`core.graphs`, keyed by
device), counted into the caller's graph tally; shards of one class on
one card take its graphs in turn.

  * `estimate_batch_sharded(windows, omega0s, cfg, mesh)` — a (B, N)
    window batch, B divisible by the data-parallel extent (the serving
    layer pads batches to class sizes that satisfy this).
  * `estimate_streams_sharded(windows, omega_inits, cfg, mesh)` — the same
    for (S, K, N) stream batches with warm-start chaining in each stream.
  * `estimate_batch_distributed(windows, omega0s, cfg, mesh)` — the batch
    path for any B: shards as even as `tensor_split` makes them.

Results come back with the leading-axis layout they went in with, so
callers index them like those of `core.pipeline.estimate_batch` /
`estimate_streams`.
"""
from __future__ import annotations

import concurrent.futures
from typing import Dict, List, Optional, Tuple

import torch

from .graphs import current_tally, graph_tally
from .pipeline import (WindowResult, estimate_streams,
                       estimate_windows_parallel)
from .types import CmaxConfig, EventWindow


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _dp_extent(mesh) -> int:
    n = 1
    for a in _dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def _shard_devices(mesh) -> List[torch.device]:
    """The device of each data-parallel index, in slot order: the grid's
    entry at index 0 of every other axis."""
    dp = _dp_axes(mesh)
    order = [mesh.axis_names.index(a) for a in dp]
    rest = [i for i in range(len(mesh.axis_names)) if i not in order]
    devs = mesh.devices.transpose(order + rest)
    return list(devs.reshape(_dp_extent(mesh), -1)[:, 0])


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, EventWindow):
        obj = (obj.x, obj.y, obj.t, obj.p, obj.valid)
    return [t for o in obj for t in _tensors(o)]


def _cat(parts: List, dev: torch.device):
    """Concatenate structurally equal (nested tuple) results leaf by leaf
    along the leading axis, on `dev`."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    leaves = [_cat([p[i] for p in parts], dev) for i in range(len(first))]
    return type(first)(*leaves) if hasattr(first, "_fields") \
        else type(first)(leaves)


def shard_windows(windows: EventWindow, omega0s: torch.Tensor, mesh
                  ) -> Tuple[List[EventWindow], List[torch.Tensor]]:
    """Split a (B, ...) window batch and its (B, 3) warm starts into one
    contiguous shard per data-parallel index (as even as `tensor_split`
    makes them), each on its shard's device.

    Unlike the reference's, which returns one `(EventWindow, Array)` pair
    laid out over the mesh, this returns a list of windows and a list of
    warm starts, one entry per shard: torch has no tensor spread over
    several devices."""
    devs = _shard_devices(mesh)
    n = len(devs)
    cols = [a.tensor_split(n) for a in (windows.x, windows.y, windows.t,
                                        windows.p, windows.valid)]
    oms = omega0s.tensor_split(n)
    return ([EventWindow(*(c[i].to(d) for c in cols))
             for i, d in enumerate(devs)],
            [o.to(d) for o, d in zip(oms, devs)])


def _run_sharded(local, windows: EventWindow, omegas: torch.Tensor, mesh):
    """Run `local(windows_shard, omegas_shard)` for every non-empty shard,
    each from its own thread (under its own stream on a card), and gather
    the results onto the grid's first device in slot order."""
    devs = _shard_devices(mesh)
    out_dev = devs[0]
    ws, oms = shard_windows(windows, omegas, mesh)
    jobs = [i for i in range(len(devs)) if oms[i].shape[0] > 0]
    streams: Dict[int, Optional[torch.cuda.Stream]] = {}
    ready: Dict[int, Optional[torch.cuda.Event]] = {}
    done: Dict[int, Optional[torch.cuda.Event]] = {}
    for i in jobs:
        d = devs[i]
        if d.type != "cuda":
            streams[i] = ready[i] = done[i] = None
            continue
        # each call takes the next streams of the device's pool, so the
        # shards on one card run on streams of their own
        s = streams[i] = torch.cuda.Stream(device=d)
        # the shard's inputs were made (or copied) on the caller's stream
        ready[i] = torch.cuda.Event()
        ready[i].record(torch.cuda.current_stream(d))
        for t in _tensors((ws[i], oms[i])):
            t.record_stream(s)
        done[i] = torch.cuda.Event()

    counts = current_tally()

    def run(i: int):
        s = streams[i]
        if s is None:
            return local(ws[i], oms[i])
        with torch.cuda.device(devs[i]), torch.cuda.stream(s), \
                graph_tally(counts):
            s.wait_event(ready[i])
            out = local(ws[i], oms[i])
            done[i].record(s)
        return out

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=len(jobs),
            thread_name_prefix="repro_torch-shard") as pool:
        futures = [pool.submit(run, i) for i in jobs]
        concurrent.futures.wait(futures)
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:
        raise errors[0]

    parts = [f.result() for f in futures]
    for i, out in zip(jobs, parts):
        if done[i] is not None:
            # the caller's streams read the shard's output only after the
            # shard's stream has written it, and the allocator keeps its
            # memory until those reads are done
            for d in {devs[i], out_dev}:
                if d.type == "cuda":
                    torch.cuda.current_stream(d).wait_event(done[i])
            for t in _tensors(out):
                t.record_stream(torch.cuda.current_stream(devs[i]))
    return _cat(parts, out_dev)


def _check_divisible(n: int, mesh, what: str) -> None:
    ndev = _dp_extent(mesh)
    if n % ndev:
        raise ValueError(
            f"{what} {n} not divisible by DP extent {ndev}; pad the batch "
            f"(launch/serve.py pads to class sizes automatically)")


def estimate_batch_sharded(windows: EventWindow, omega0s: torch.Tensor,
                           cfg: CmaxConfig, mesh) -> WindowResult:
    """Sharded `estimate_batch`: (B, N) windows + (B, 3) warm starts, B
    divisible by the data-parallel extent. Each shard runs the full
    adaptive pipeline on its device; nothing crosses shards."""
    _check_divisible(windows.x.shape[0], mesh, "batch")
    return _run_sharded(lambda w, o: estimate_windows_parallel(w, o, cfg),
                        windows, omega0s, mesh)


def estimate_streams_sharded(windows: EventWindow, omega_inits: torch.Tensor,
                             cfg: CmaxConfig, mesh
                             ) -> Tuple[torch.Tensor, WindowResult]:
    """Sharded `estimate_streams`: (S, K, N) stream batches with warm-start
    chaining per stream; S divisible by the data-parallel extent."""
    _check_divisible(windows.x.shape[0], mesh, "streams")
    return _run_sharded(lambda w, o: estimate_streams(w, o, cfg),
                        windows, omega_inits, mesh)


def estimate_batch_distributed(windows: EventWindow, omega0s: torch.Tensor,
                               cfg: CmaxConfig, mesh) -> WindowResult:
    """`estimate_batch` over the grid for any batch size: shards as even as
    `tensor_split` makes them (a shard may be empty and runs nothing)."""
    return _run_sharded(lambda w, o: estimate_windows_parallel(w, o, cfg),
                        windows, omega0s, mesh)
