"""Multi-device training and decoding across ranks: the port's DP, FSDP,
TP and EP train steps on a (2, 2) ("data", "model") grid, one process per
rank, against the single-device loop on each rank's own device; and
decoding on a distributed model and cache against one device.

    python3 tools/dist_check.py                       # 4 cards, NCCL
    PYTHONPATH=src python tools/dist_check.py --device cpu   # 4 gloo ranks

Each case trains a SMOKE config for 3 steps through `train.loop.train`
(seq 16, global batch 4, lr 3e-3, the seeded token pipeline) on the grid
and on one device, from the same seed; the losses and the updated
parameters must agree at rtol 5e-4 / atol 5e-5
(`tests/test_pipeline_parallel.py:54-55`), as in
`tests/test_torch_dist_train.py`. The MoE config runs at capacity_factor
E/k, where no token-expert pair is dropped on one device or on any EP
shard. The recurrent configs (xlstm-1.3b, recurrentgemma-9b) run their
sequence forms on local shards, heads and RG-LRU channels split over
"model". Rank 0 prints one line per case: the largest differences, the
collectives of one more step (`sharding.comms.StepCommMode`) and the
median ms per step of steps 2-3 on the grid and on one device.

The decode cases run llama3.2-1b's SMOKE config (seed 0) through
`make_serve_step` for 8 tokens from an empty cache of 16 positions, the
model placed by `sharding.distribute_model` and the cache by
`distribute_cache`: on (2, 2) the KV heads split over "model"; on (1, 4)
they do not divide it, so the cache's positions split four ways and each
step merges the partial softmaxes across the ranks
(`layers._sdpa_merged`). The logits must agree with the single-device
chain at the same bar and the greedy tokens must be equal. The two
recurrent configs then run on (2, 2) with sequence-parallel activations:
the prefill's last-position logits within 2e-5 of one device, and one
step's loss and gradients at rtol 5e-4 / atol 5e-5. Exits non-zero if a
case disagrees.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

RTOL, ATOL = 5e-4, 5e-5
SEQ, BATCH, STEPS = 16, 4, 3
CASES = [("llama3.2-1b", {}), ("llama3.2-1b", dict(fsdp=True)),
         ("deepseek-moe-16b", dict(use_ep=True, fsdp=True)),
         ("xlstm-1.3b", {}), ("xlstm-1.3b", dict(fsdp=True)),
         ("recurrentgemma-9b", {}), ("recurrentgemma-9b", dict(fsdp=True))]
DECODE_GRIDS = [(2, 2), (1, 4)]
DECODE_STEPS, DECODE_LEN = 8, 16


def run(cfg, mesh, ckpt_dir, **kw):
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.train import loop
    tc = loop.TrainConfig(steps=STEPS, ckpt_dir=ckpt_dir, ckpt_every=0,
                          log_every=0, lr=3e-3, **kw)
    it = batches(LMDataConfig(cfg.vocab_size, SEQ, BATCH))
    hist = loop.train(cfg, tc, mesh, it, max_len=SEQ)
    return hist, tc, it


def decode_chain(cfg, model, cache, toks, place_token=None):
    """Logits (steps, B, V) and next tokens (steps, B) of `make_serve_step`
    over toks (B, steps), as whole tensors."""
    from repro_torch.models import make_serve_step
    step = make_serve_step(cfg)
    whole = lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t)
    logits, nxt = [], []
    for t in range(toks.shape[1]):
        tok = toks[:, t:t + 1]
        n, lg, cache = step(model, cache,
                            place_token(tok) if place_token else tok)
        logits.append(whole(lg)[:, 0])
        nxt.append(whole(n)[:, 0])
    return torch.stack(logits), torch.stack(nxt)


def decode_case(shape, dev, devices):
    """One decode case on a grid of `shape` against one device: a dict
    for rank 0's line."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import (distribute_batch, distribute_cache,
                                      distribute_model)
    cfg = get_smoke_config("llama3.2-1b")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, DECODE_STEPS)), device=dev)

    def model():
        return tfm.init_params(cfg, torch.Generator().manual_seed(0),
                               device=dev)

    def cache():
        return tfm.init_cache(cfg, BATCH, DECODE_LEN, device=dev)
    want_lg, want_tok = decode_chain(cfg, model(), cache(), toks)
    mesh = device_mesh(make_mesh(shape, ("data", "model"), devices))
    dcache = distribute_cache(cache(), cfg, mesh)
    t0 = time.perf_counter()
    got_lg, got_tok = decode_chain(
        cfg, distribute_model(model(), mesh), dcache, toks,
        lambda t: distribute_batch({"token": t}, mesh)["token"])
    grid_s = time.perf_counter() - t0
    return {"decode": "llama3.2-1b", "grid": list(shape),
            "cache_k": str(dcache["layers"][0]["k"].placements),
            "ok": bool(torch.allclose(got_lg, want_lg, rtol=RTOL, atol=ATOL)
                       and torch.equal(got_tok, want_tok)),
            "logits_max_abs_err": float((got_lg - want_lg).abs().max()),
            "ms_per_token": grid_s / DECODE_STEPS * 1e3}


def sp_case(arch, dev, devices):
    """`arch`'s SMOKE config (seed 0) on (2, 2) with sequence-parallel
    activations (the dry run's layout): the prefill's last-position logits
    (bar 2e-5, `tests/test_pipeline_parallel.py:44-45`) and one step's
    loss and gradients against one device."""
    from torch.distributed.tensor import Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.data.lm import LMDataConfig, batches
    from repro_torch.launch.mesh import device_mesh, make_mesh
    from repro_torch.models import loss_and_grads, make_prefill_step
    from repro_torch.models import transformer as tt
    from repro_torch.sharding import distribute_batch, distribute_model
    cfg = get_smoke_config(arch)
    model = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           max_len=SEQ, device=dev)
    toks, labels = next(batches(LMDataConfig(cfg.vocab_size, SEQ, BATCH)))
    batch = {"tokens": torch.as_tensor(toks, device=dev),
             "labels": torch.as_tensor(labels, device=dev)}
    want_lg = make_prefill_step(cfg)(model, batch)
    want_loss, want = loss_and_grads(model, batch)
    mesh = device_mesh(make_mesh((2, 2), ("data", "model"), devices))
    distribute_model(model, mesh)
    b = distribute_batch(batch, mesh)
    seq = (Shard(0), Shard(1))
    lg = make_prefill_step(cfg, mesh=mesh, act_sharding=seq)(
        model, b).full_tensor()
    loss, grads = loss_and_grads(model, b, mesh=mesh, act_sharding=seq)
    ok = bool(torch.allclose(lg, want_lg, rtol=2e-5, atol=2e-5)) and \
        abs(float(loss) - float(want_loss)) <= ATOL + RTOL * abs(
            float(want_loss))
    grad_err = 0.0
    for n, g in grads.items():
        a = g.full_tensor()
        grad_err = max(grad_err, float((a - want[n]).abs().max()))
        ok = ok and bool(torch.allclose(a, want[n], rtol=RTOL, atol=ATOL))
    return {"case": "sequence-parallel prefill and gradients", "arch": arch,
            "grid": [2, 2], "ok": ok,
            "logits_max_abs_err": float((lg - want_lg).abs().max()),
            "loss_abs_err": abs(float(loss) - float(want_loss)),
            "grad_max_abs_err": grad_err}


def rank_main(rank, world, init, device_type, tmp):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.sharding import distribute_batch
    from repro_torch.sharding.comms import StepCommMode
    from repro_torch.train import loop

    torch.set_num_threads(1)
    init_distributed("nccl" if device_type == "cuda" else "gloo", init,
                     rank, world)
    dev = torch.device("cuda", rank) if device_type == "cuda" \
        else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    devices = [f"cuda:{i}" for i in range(world)] \
        if device_type == "cuda" else ["cpu"] * world
    grid = make_mesh((2, 2), ("data", "model"), devices)
    bad = []
    try:
        for arch, kw in CASES:
            cfg = get_smoke_config(arch)
            if cfg.n_experts:
                cfg = dataclasses.replace(
                    cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
            one, _, _ = run(cfg, dev, os.path.join(tmp, f"one{rank}"))
            got, tc, it = run(cfg, grid, os.path.join(tmp, "grid"), **kw)
            loss_err = float(np.max(np.abs(np.array(got["loss"])
                                           - np.array(one["loss"]))))
            ok = np.allclose(got["loss"], one["loss"], rtol=RTOL, atol=ATOL)
            param_err = 0.0
            want = dict(one["state"].params.named_parameters())
            for n, p in got["state"].params.named_parameters():
                a, b = p.full_tensor().detach(), want[n].detach()
                param_err = max(param_err, float((a - b).abs().max()))
                ok = ok and bool(torch.allclose(a, b, rtol=RTOL, atol=ATOL))
            state = got["state"]
            mesh = next(state.params.parameters()).device_mesh
            toks, labels = next(it)
            b = distribute_batch({"tokens": torch.as_tensor(toks, device=dev),
                                  "labels": torch.as_tensor(labels,
                                                            device=dev)},
                                 mesh)
            with StepCommMode() as comm:
                loop.make_step(cfg, tc, grid)(state.params, state.opt_state,
                                              state.comp_state, b)
            if rank == 0:
                print(json.dumps({
                    "arch": arch, "grid": [2, 2], **kw, "ok": bool(ok),
                    "loss_max_abs_err": loss_err,
                    "param_max_abs_err": param_err,
                    "collectives_per_step": comm.counts(),
                    "grid_ms": float(np.median(got["step_time"][1:])) * 1e3,
                    "one_device_ms": float(np.median(one["step_time"][1:]))
                    * 1e3}), flush=True)
            if not ok:
                bad.append(arch)
        for shape in DECODE_GRIDS:
            line = decode_case(shape, dev, devices)
            if rank == 0:
                print(json.dumps(line), flush=True)
            if not line["ok"]:
                bad.append(f"decode on {shape}")
        for arch in ("xlstm-1.3b", "recurrentgemma-9b"):
            line = sp_case(arch, dev, devices)
            if rank == 0:
                print(json.dumps(line), flush=True)
            if not line["ok"]:
                bad.append(f"{arch} sequence-parallel")
    finally:
        torch.distributed.destroy_process_group()
    if bad:
        raise SystemExit(f"rank {rank}: {bad} disagree with one device")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    world = 4
    if args.device == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} cards needed, "
                         f"{torch.cuda.device_count()} visible")
    with tempfile.TemporaryDirectory() as tmp:
        if args.device == "cuda":
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                init = f"tcp://127.0.0.1:{sock.getsockname()[1]}"
        else:
            init = f"file://{tmp}/rendezvous"
        t0 = time.perf_counter()
        mp.spawn(rank_main, args=(world, init, args.device, tmp),
                 nprocs=world, join=True)
        print(f"dist_check: {time.perf_counter() - t0:.1f} s on {world} "
              f"{args.device} ranks")


if __name__ == "__main__":
    main()
