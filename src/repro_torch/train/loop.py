"""Fault-tolerant training loop (counterpart of `repro.train.loop`).

Wires together: the train step (`models.model.loss_and_grads` and an
optimizer of `train.optim`), the sharding rules, checkpointing (save /
restore / resume, elastic across grids), straggler detection, failure
retry, optional microbatch gradient accumulation and int8 gradient
compression. This is the loop examples/torch_lm_pretrain.py and the chaos
example drive; launch/train.py is its CLI.

`mesh` is a device (or its name), a `launch.mesh.DeviceGrid`, or a
`torch.distributed.device_mesh.DeviceMesh`. A device, or a grid of one
entry with no process group started, trains on that device. Otherwise the
loop runs one process per grid entry (`torchrun`; `launch.mesh.
init_distributed`), every rank calling `train` alike: the parameters are
DTensors placed by the reference's `param_specs` (DP over "pod" and
"data", Megatron TP on "model", FSDP over "data" with `fsdp`), each batch
is sharded by `batch_specs`, `use_ep` routes the MoE layers through
`moe_apply_ep`, and the optimizer state is sharded as its parameters.
Every rank draws the same whole model from `seed` on its device, as the
single-device loop does, before placing it, so a grid of any shape
starts from the single-device loop's numbers. As in the reference, a
restart rebuilds the state, resumes from the latest committed
checkpoint's `next_step` (restored onto the current grid, whatever grid
wrote it) and does not rewind the batch iterator.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..device import resolve
from ..models import transformer as tfm
from ..models.config import ModelConfig
from ..models.model import loss_and_grads
from ..sharding import distribute_batch, distribute_model, dp_axes_of
from . import checkpoint as ckpt_lib
from . import optim as optim_lib
from .ft import FaultInjector, RetryPolicy, StragglerDetector


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: str = "checkpoints/run0"
    ckpt_every: int = 20
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    optimizer: str = "adamw"
    lr: float = 3e-4
    fsdp: bool = False
    use_ep: bool = False
    grad_compression: Optional[str] = None    # None | "int8"
    microbatch: int = 1                       # grad-accum splits


def _placement(mesh) -> Tuple[torch.device, Any]:
    """(this process's device, the DeviceMesh to shard over or None) of
    the loop's `mesh` argument."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..launch.mesh import device_mesh
    if isinstance(mesh, DeviceMesh):
        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
        return dev, mesh
    if hasattr(mesh, "devices") and hasattr(mesh, "axis_names"):
        if dist.is_available() and dist.is_initialized():
            dm = device_mesh(mesh)
            return resolve(mesh.devices.flat[dist.get_rank()]), dm
        if mesh.size != 1:
            raise RuntimeError(
                f"a grid of {mesh.size} entries trains one process per "
                f"entry: start them with torchrun (or "
                f"launch.mesh.init_distributed) before calling the loop")
        mesh = mesh.devices.flat[0]
    return resolve(mesh), None


def _optimizer(tc: TrainConfig):
    if tc.optimizer == "adamw":
        return optim_lib.AdamWConfig(lr=tc.lr), optim_lib.adamw_init, \
            optim_lib.adamw_update
    return optim_lib.AdafactorConfig(lr=tc.lr), optim_lib.adafactor_init, \
        optim_lib.adafactor_update


def make_step(cfg: ModelConfig, tc: TrainConfig, mesh) -> Callable:
    """step(model, opt_state, comp_state, batch) -> (opt_state,
    comp_state, {"loss": loss}) with optional microbatching + compression;
    the model's parameters change in place. The reference's metrics also
    carry the gradients' global norm, which its compiled step shares with
    AdamW's clipping; run eagerly here it would be a second pass over every
    gradient, and nothing reads it."""
    _, dmesh = _placement(mesh)
    dp = dp_axes_of(dmesh) if dmesh is not None else ("data",)
    ocfg, _, upd = _optimizer(tc)

    def step(model, opt_state, comp_state, batch):
        loss, grads = loss_and_grads(model, batch,
                                     microbatch=tc.microbatch, mesh=dmesh,
                                     dp_axes=dp, use_ep=tc.use_ep)
        if tc.grad_compression == "int8":
            grads, comp_state = optim_lib.compress_grads(grads, comp_state,
                                                         model)
        opt_state = upd(ocfg, grads, opt_state, model)
        return opt_state, comp_state, {"loss": loss}

    return step


@dataclasses.dataclass
class TrainState:
    params: Any          # the model (`models.transformer.Transformer`)
    opt_state: Any
    comp_state: Any
    step: int


def init_state(cfg: ModelConfig, tc: TrainConfig, mesh,
               max_len: int) -> TrainState:
    """A model drawn from a generator seeded `tc.seed` on the loop's
    device (placed on the mesh by `param_specs(fsdp=tc.fsdp)` when there
    is one), its optimizer state and (with compression) the residuals."""
    dev, dmesh = _placement(mesh)
    g = torch.Generator(device=dev).manual_seed(tc.seed)
    model = tfm.init_params(cfg, g, max_len=max_len, device=dev)
    if dmesh is not None:
        distribute_model(model, dmesh, fsdp=tc.fsdp)
    ocfg, init, _ = _optimizer(tc)
    comp = optim_lib.compression_init(model) if tc.grad_compression \
        else None
    return TrainState(params=model, opt_state=init(ocfg, model),
                      comp_state=comp, step=0)


def checkpoint_tree(state: TrainState) -> Dict[str, Any]:
    """What a checkpoint holds: the parameters by name and the optimizer
    state."""
    return {"params": dict(state.params.named_parameters()),
            "opt_state": state.opt_state}


def train(cfg: ModelConfig, tc: TrainConfig, mesh,
          batches: Iterator[Tuple[np.ndarray, np.ndarray]],
          max_len: int, injector: Optional[FaultInjector] = None,
          extra_batch: Optional[Dict[str, np.ndarray]] = None
          ) -> Dict[str, Any]:
    """Run the fault-tolerant loop. Returns summary metrics (the
    reference's history) and, under "state", the final `TrainState`."""
    dev, dmesh = _placement(mesh)
    detector = StragglerDetector()
    retry = RetryPolicy()
    history: Dict[str, Any] = {"loss": [], "step_time": [],
                               "stragglers": [], "restarts": 0,
                               "remesh_requests": 0}

    def body(restart_count: int):
        history["state"] = None      # drop the failed run's state first
        state = init_state(cfg, tc, mesh, max_len)
        start = 0
        if ckpt_lib.latest_step(tc.ckpt_dir) is not None:
            tree = checkpoint_tree(state)
            restored, extra = ckpt_lib.restore(
                tc.ckpt_dir, tree, device=dev,
                shardings=ckpt_lib.shardings_of(tree))
            with torch.no_grad():
                for name, p in state.params.named_parameters():
                    p.copy_(restored["params"][name])
            state.opt_state = restored["opt_state"]
            start = extra["next_step"]
            state.step = start
            print(f"[ckpt] resumed at step {start}")
        history["state"] = state
        step_fn = make_step(cfg, tc, mesh)

        for step_idx in range(start, tc.steps):
            toks, labels = next(batches)
            batch = {"tokens": torch.as_tensor(toks, device=dev),
                     "labels": torch.as_tensor(labels, device=dev)}
            if extra_batch:
                batch.update({k: torch.as_tensor(v, device=dev)
                              for k, v in extra_batch.items()})
            if dmesh is not None:
                batch = distribute_batch(batch, dmesh)

            if injector is not None:
                injector.maybe_fail(step_idx)
                injector.maybe_straggle(step_idx)

            t0 = time.perf_counter()
            state.opt_state, state.comp_state, metrics = step_fn(
                state.params, state.opt_state, state.comp_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            history["loss"].append(loss)
            history["step_time"].append(dt)
            if detector.observe(dt):
                history["stragglers"].append(step_idx)
                if detector.should_remesh:
                    history["remesh_requests"] += 1
                    detector.consecutive = 0
            state.step = step_idx + 1

            if tc.log_every and step_idx % tc.log_every == 0:
                print(f"[train] step {step_idx} loss {loss:.4f} "
                      f"({dt * 1e3:.0f} ms)")
            if tc.ckpt_every and (step_idx + 1) % tc.ckpt_every == 0:
                ckpt_lib.save(tc.ckpt_dir, state.step,
                              checkpoint_tree(state),
                              extra={"next_step": state.step},
                              keep=tc.keep)

    history["restarts"] = retry.run(body)
    return history
