"""Multi-process helpers of the port's distributed CPU tests: start a
`gloo` world with `torch.multiprocessing` (a `file://` rendezvous under
the test's tmp_path, so parallel test workers never share a port), join
it under a deadline, and the per-rank set-up. This module imports
neither JAX nor the reference: the ranks import it."""
import time

import torch
import torch.multiprocessing as mp


def spawn(fn, world: int, tmp_path, *args, timeout: float = 80.0) -> None:
    """Run fn(rank, world, init_method, *args) in `world` processes and
    wait for all of them; a rank's exception fails the test, and so does
    a world still running after `timeout` seconds (its processes are
    killed)."""
    init = f"file://{tmp_path}/rendezvous_{fn.__name__}"
    ctx = mp.start_processes(fn, args=(world, init) + args, nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{fn.__name__}: the world of {world} ran "
                               f"past {timeout} s")


def start_rank(rank: int, world: int, init: str):
    """This rank's gloo process group, one thread (bitwise-stable CPU
    reductions)."""
    from repro_torch.launch.mesh import init_distributed
    torch.set_num_threads(1)
    init_distributed("gloo", init, rank, world)


def grid(shape, names=("data", "model")):
    """A DeviceGrid of repeated `cpu` entries and its DeviceMesh over the
    started world."""
    import math

    from repro_torch.launch.mesh import device_mesh, make_mesh
    g = make_mesh(shape, names, ["cpu"] * math.prod(shape))
    return g, device_mesh(g)


def stop_rank() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
