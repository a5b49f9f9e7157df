"""Collectives per train step of the port's multi-device training, counted
on the CPU in a gloo world of 4 ranks (one process each).

    PYTHONPATH=src python tools/dist_collectives.py

For each case (a SMOKE config on a ("data", "model") grid, with or without
FSDP and EP), one train step (remat "full", 2 microbatches, AdamW) runs
under `sharding.comms.StepCommMode` after a warm-up step. Rank 0 prints
one JSON line per case: the count of each collective, and each count put
down to the DTensor op that asked for it. The counts depend on the grid
and the config, not on the device, so a world of 4 on the card would
issue the same ones.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

CASES = [
    ("llama3.2-1b", (4, 1), dict(fsdp=True)),
    ("llama3.2-1b", (2, 2), dict()),
    ("llama3.2-1b", (2, 2), dict(fsdp=True)),
    ("deepseek-moe-16b", (2, 2), dict(fsdp=True, use_ep=True)),
]


def rank_main(rank, world, init):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.sharding.comms import StepCommMode
    from repro_torch.train import loop

    torch.set_num_threads(1)
    init_distributed("gloo", init, rank, world)
    try:
        for arch, shape, kw in CASES:
            cfg = get_smoke_config(arch)
            grid = make_mesh(shape, ("data", "model"), ["cpu"] * world)
            tc = loop.TrainConfig(microbatch=2, **kw)
            state = loop.init_state(cfg, tc, grid, 16)
            step = loop.make_step(cfg, tc, grid)
            data = batches(LMDataConfig(cfg.vocab_size, 16, 8))
            mesh = next(state.params.parameters()).device_mesh
            from repro_torch.sharding import distribute_batch
            counts = None
            for i in range(2):
                toks, labels = next(data)
                b = distribute_batch({"tokens": torch.as_tensor(toks),
                                      "labels": torch.as_tensor(labels)},
                                     mesh)
                with StepCommMode() as comm:
                    state.opt_state, state.comp_state, met = step(
                        state.params, state.opt_state, state.comp_state, b)
                    float(met["loss"])
                counts = comm
            if rank == 0:
                print(json.dumps({
                    "arch": arch, "grid": shape, **kw,
                    "per_step": counts.counts(),
                    "total": counts.get_total_counts(),
                    "by_op": counts.counts_by_op()}), flush=True)
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def main():
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(rank_main, args=(4, f"file://{tmp}/rendezvous"), nprocs=4,
                 join=True)


if __name__ == "__main__":
    main()
