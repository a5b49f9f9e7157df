"""Multi-pod dry run (counterpart of `repro.launch.dryrun`): run every
(architecture x input shape x mesh) cell's step as rank 0 of a fake
process group of 256 (one 16x16 pod) or 512 (2x16x16) ranks, on fake
tensors, and record memory, cost and collective evidence for the roofline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch
Each cell writes <out>/<arch>__<shape>__<mesh>.json with the reference's
keys, so that `roofline.summarize_cell` and `roofline.report` read it, and
`torch_version`, which marks it as the port's: the default directory is
the port's own (`results/dryrun_torch`, beside the reference's
`results/dryrun`), and a record without `torch_version` is never read
back as the port's.

How a cell runs. The group is `torch.distributed`'s "fake" backend
(`FakeStore`): every collective returns at once and moves nothing. The
mesh is `init_device_mesh("cpu", ...)` over it. Parameters, optimizer
state, batch and cache are DTensors placed by the port's rules
(`sharding.distribute_model`, `batch_specs`' rule, `distribute_cache`,
the optimizer's own placement), each rank's shard a `FakeTensor`: shapes,
dtypes and strides, no storage. Nothing is allocated and no card is
needed; the step is the port's own (`models.make_train_step`,
`make_prefill_step`, `make_serve_step`), run eagerly.

The record, per device (rank 0):
  memory.argument_size_in_bytes  the local shards of params, optimizer
                                 state, batch and cache (by part in
                                 `argument_bytes_by_part`);
  memory.temp_size_in_bytes      the peak of the bytes the step allocated
                                 and still held (fake-tensor storages,
                                 freed as they die), over the arguments;
  memory.output_size_in_bytes    what the step returns, new storage only;
  cost.flops                     `torch.utils.flop_counter`'s count of
                                 every op on local shards;
  cost["bytes accessed"]         input plus output bytes of every aten op
                                 on local shards (views excluded), the
                                 counterpart of XLA's operand-plus-output
                                 count;
  collectives                    output bytes per collective kind
                                 (`sharding.comms.StepCommMode`), with
                                 `collective_counts` by op name;
  status                         "ok", "skipped" (with the reason of
                                 `models.shape_applicable`) or "error"
                                 (with the traceback's tail; the sweep
                                 goes on).

One accounting mode (`_Accountant`, a `StepCommMode`) does all of it
rather than `FlopCounterMode` and `MemTracker`: both see a DTensor op
before DTensor splits it (so they would count global shapes), and both
would count the global-shape ops DTensor runs on fake tensors to infer an
op's output metadata. The accountant lets DTensor lower each op first and
sees only the local ops it issues, and it pauses while DTensor's sharding
propagation infers metadata.

The group runs on the "cpu" device type, so DTensor lowers a Shard-to-
Shard move to all-gather and chunk (its CPU route), where NCCL on the
card would run all_to_all: those bytes count as all-gather here.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict

import torch

from ..configs import ALIASES, ARCH_IDS, get_config
from ..models import (SHAPES, abstract_params, make_prefill_step,
                      make_serve_step, make_train_step, shape_applicable)
from ..models import transformer as tfm
from ..sharding import (P, distribute_cache, distribute_model, dp_axes_of,
                        place, to_placements, with_divisibility)
from ..sharding.comms import StepCommMode
from .mesh import make_production_mesh


# ----------------------------------------------------------------------
# the fake group and the mesh
# ----------------------------------------------------------------------

def start_fake_group(world: int) -> None:
    """This process as rank 0 of a fake group of `world` ranks (an
    existing fake group of another size is replaced). Fails if the fake
    backend or `FakeStore` is missing: the dry run has no other group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a non-fake process group is running: the "
                               "dry run needs a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def fake_mesh(shape, names):
    """A DeviceMesh of `shape` / `names` over the fake group (started or
    resized to its size)."""
    from torch.distributed.device_mesh import init_device_mesh
    start_fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def production_mesh(multi_pod: bool = False):
    """`launch.mesh.make_production_mesh`'s grid as a DeviceMesh over a
    fake group: 16x16 ("data", "model"), or 2x16x16 with "pod"."""
    grid = make_production_mesh(multi_pod=multi_pod)
    return fake_mesh([grid.shape[a] for a in grid.axis_names],
                     grid.axis_names)


# ----------------------------------------------------------------------
# accounting
# ----------------------------------------------------------------------

def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# ops that move no bytes: a tensor's device read on the host (`x.device`,
# `x.is_cuda`) and the wait on a collective's output, already counted
_NO_TRAFFIC = (torch.ops.prim.device.default,
               torch.ops._c10d_functional.wait_tensor.default)


class _Accountant(StepCommMode):
    """Counts, over the local ops DTensor issues (module docstring):
    flops (`FlopCounterMode`'s formulas), bytes accessed, the peak of the
    bytes allocated and still alive, and (as `StepCommMode`) the
    collectives."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.flop_counter = FlopCounterMode(display=False)
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self.paused = 0
        self.at_peak = ""
        self.largest = (0, "")
        self._refs: Dict[int, Any] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if self.paused or isinstance(func, torch._ops.HigherOrderOperator) \
                or any(t is DTensor for t in types) or func in _NO_TRAFFIC:
            return super().__torch_dispatch__(func, types, args, kwargs)
        kwargs = kwargs or {}
        # a composite op that reaches the mode undecomposed (under inference
        # mode, `matmul`): count its parts, as FlopCounterMode does
        with self:
            r = func.decompose(*args, **kwargs)
        if r is not NotImplemented:
            return r
        out = super().__torch_dispatch__(func, types, args, kwargs)
        outs = _tensors(out)
        if any(t.device.type == "meta" for t in outs):
            return out          # DTensor's strategy search, not the step
        self.flop_counter._count_flops(func._overloadpacket, out, args,
                                       kwargs)
        if not func.is_view:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._hold(t, func)
        return out

    def _hold(self, t: torch.Tensor, func) -> None:
        """Count `t`'s storage while it lives, once."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(st, lambda _, k=key, n=n:
                                      self._free(k, n))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live
            self.at_peak = str(func)
        if n > self.largest[0]:
            self.largest = (n, f"{func} {tuple(t.shape)} {t.dtype}")

    def _free(self, key: int, n: int) -> None:
        self._refs.pop(key, None)
        self.live -= n

    def seen(self, tree) -> None:
        """Count nothing for the storages of `tree` (the arguments): they
        were allocated before the step."""
        from ..models.layers import is_dtensor
        for t in _tensors(tree):
            st = (t.to_local() if is_dtensor(t) else t).untyped_storage()
            key = id(st)
            if key not in self._refs:
                self._refs[key] = weakref.ref(
                    st, lambda _, k=key: self._refs.pop(k, None))

    @property
    def flops(self) -> int:
        return self.flop_counter.get_total_flops()


@contextlib.contextmanager
def _dtensor_on_fake_tensors(acc: _Accountant):
    """Four shims DTensor needs on fake tensors, and the card's route of
    the float32-output product, all undone on exit. DTensor's sharding
    propagation infers an op's output metadata by running it at its
    global shape on fake tensors, and `acc` pauses over it (where it runs
    a decomposition to pick a strategy, it does so on meta tensors, which
    `acc` skips); `_StridedShard`'s shard-size rule reads a small index
    tensor on the host (`tolist`), which a fake tensor refuses, so it runs
    outside the fake mode; and under a fake mode DTensor takes itself to
    be tracing and propagates every op's sharding and plans every
    redistribution anew (on a 3-D mesh with strided shards, minutes a
    step), so its dispatch and propagation are told that nothing traces
    and the plans are cached, as they are outside a fake mode (the shapes
    here are concrete). The step runs on fake CPU tensors but is accounted
    as the card runs it, so `layers.f32_product` of bf16 factors takes
    `_F32Product` (one product with a float32 output), not the CPU's
    widened copies."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import (_dispatch, _redistribute,
                                          _sharding_prop, placement_types)

    from ..models import layers
    prop = _sharding_prop.ShardingPropagator
    names = [n for n in ("_propagate_tensor_meta_non_cached",
                         "_propagate_tensor_meta") if hasattr(prop, n)][:1]
    if not names:
        raise RuntimeError("this torch's DTensor has no sharding "
                           "propagation to pause the accounting over")
    saved = {n: getattr(prop, n) for n in names}
    strided = getattr(placement_types, "_StridedShard", None)
    size_fn = getattr(strided, "local_shard_size_and_offset", None)
    plan_fn = getattr(_redistribute, "_gen_transform_infos_non_cached", None)
    tracing = [m for m in (_dispatch, _sharding_prop)
               if hasattr(m, "_are_we_tracing")]

    def paused(fn):
        def run(self, *a, **k):
            acc.paused += 1
            try:
                return fn(self, *a, **k)
            finally:
                acc.paused -= 1
        return run

    def real_size(self, *a, **k):
        with unset_fake_temporarily():
            return size_fn(self, *a, **k)

    local_product = layers._local_f32_product

    def card_product(x, w):
        if x.dtype == torch.float32 and w.dtype == torch.float32:
            return local_product(x, w)
        return layers._card_f32_product(x, w)

    for n, fn in saved.items():
        setattr(prop, n, paused(fn))
    if size_fn is not None:
        strided.local_shard_size_and_offset = real_size
    if plan_fn is not None:
        _redistribute._gen_transform_infos_non_cached = \
            functools.lru_cache(maxsize=None)(plan_fn)
    saved_tracing = [m._are_we_tracing for m in tracing]
    for m in tracing:
        m._are_we_tracing = lambda: False
    layers._local_f32_product = card_product
    try:
        yield
    finally:
        layers._local_f32_product = local_product
        for n, fn in saved.items():
            setattr(prop, n, fn)
        if size_fn is not None:
            strided.local_shard_size_and_offset = size_fn
        if plan_fn is not None:
            _redistribute._gen_transform_infos_non_cached = plan_fn
        for m, fn in zip(tracing, saved_tracing):
            m._are_we_tracing = fn


def local_bytes(tree) -> int:
    """Bytes of each tensor's local shard (a DTensor's on this rank)."""
    from ..models.layers import is_dtensor
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in _tensors(tree))


# ----------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------

def _fake_model(cfg, max_len: int):
    """The model with every parameter a fake CPU tensor (under the active
    FakeTensorMode): no storage."""
    from torch import nn
    model = abstract_params(cfg, max_len=max_len)
    for mod in model.modules():
        for pn, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, pn, nn.Parameter(torch.empty(
                p.shape, dtype=p.dtype, device="cpu")))
    return model


def _replicate_model(model, mesh):
    """The reference's dp_only policy: every parameter (and so every
    optimizer state leaf) replicated on `mesh`."""
    from torch import nn
    from torch.distributed.tensor import Replicate

    from ..models.leaves import leaf_groups
    rep = [Replicate()] * mesh.ndim
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for mod in model.modules():
        for pn, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, pn, nn.Parameter(place(p.detach(), mesh, rep)))
    model.device_mesh = mesh
    model.leaf_specs = {k: P() for k in leaf_groups(model.cfg, shapes)}
    return model


def _place_inputs(batch: Dict[str, torch.Tensor], mesh, batch_axes):
    """Inputs with the batch dim over `batch_axes` where it divides:
    `sharding.batch_specs`' rule, over the data-parallel axes and, under
    dp_only, "model" too (the reference's shadow of `batch_specs`)."""
    out = {}
    for k, v in batch.items():
        spec = P() if v.ndim == 0 else with_divisibility(
            P(batch_axes, *([None] * (v.ndim - 1))), v.shape, mesh)
        out[k] = place(v, mesh, to_placements(spec, mesh))
    return out


def build_cell(arch: str, shape_name: str, mesh, overrides=None,
               shape=None):
    """Returns (run, args, meta): `run(*args)` runs the cell's step once.
    Call it under a `FakeTensorMode` (and `_dtensor_on_fake_tensors`):
    args are DTensors with fake shards. `shape` replaces
    `SHAPES[shape_name]` (a cell outside the table).

    overrides (the reference's hill-climb knobs):
      attn_q_chunk: int       chunked attention (no Sq x Sk scores)
      policy: "tp"|"dp_only"  dp_only replicates params and folds the
                              model axis into data parallelism
      remat_policy: "full"|"dots"
      capacity_factor: float  MoE EP capacity
      microbatch: int, accum_bf16: bool, no_ep: bool, no_sp: bool
    """
    from torch.distributed.tensor import Replicate, Shard

    from ..train import optim as optim_lib
    overrides = overrides or {}
    cfg = get_config(arch)
    shape = shape or SHAPES[shape_name]
    # chunked attention by default at 32k+ prefill, as the reference
    if shape.kind == "prefill" and shape.seq_len >= 32768 \
            and not cfg.attn_q_chunk:
        cfg = dataclasses.replace(cfg, attn_q_chunk=2048)
    if overrides.get("attn_q_chunk"):
        cfg = dataclasses.replace(cfg, attn_q_chunk=overrides["attn_q_chunk"])
    if overrides.get("capacity_factor"):
        cfg = dataclasses.replace(
            cfg, capacity_factor=overrides["capacity_factor"])
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, None, {"skipped": why}

    names = mesh.mesh_dim_names
    dp = dp_axes_of(mesh)
    dp_only = overrides.get("policy") == "dp_only"
    use_ep = (cfg.n_experts > 0 and shape.kind in ("train", "prefill")
              and not dp_only and not overrides.get("no_ep"))
    fsdp = cfg.param_count() > 8e9 and not dp_only
    remat_policy = overrides.get("remat_policy", "full")
    # sequence-parallel activations, except for EP cells (the reference's
    # choice: the SP layout fights the EP token layout)
    act_sharding = None
    if shape.kind in ("train", "prefill") and not dp_only \
            and not use_ep and not overrides.get("no_sp") \
            and shape.seq_len % mesh.size(names.index("model")) == 0:
        act_sharding = [Shard(0) if n in dp else Shard(1) if n == "model"
                        else Replicate() for n in names]
    optimizer = "adafactor" if cfg.param_count() > 3e11 else "adamw"

    model = _fake_model(cfg, shape.seq_len)
    if dp_only:
        _replicate_model(model, mesh)
    else:
        distribute_model(model, mesh, fsdp=fsdp)
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    tok = lambda shp: torch.zeros(shp, dtype=torch.int32)
    inputs: Dict[str, torch.Tensor] = {}
    if shape.kind == "decode":
        inputs["token"] = tok((B, 1))
    else:
        inputs["tokens"] = tok((B, S))
        if shape.kind == "train":
            inputs["labels"] = tok((B, S))
    if cfg.family == "vlm" or cfg.is_enc_dec:
        src = cfg.cross_source_len or (1600 if cfg.family == "vlm"
                                       else 1500)
        inputs["cross_source"] = torch.zeros((B, src, cfg.d_model),
                                             dtype=dt)
    inputs = _place_inputs(inputs, mesh,
                           dp + ("model",) if dp_only else dp)
    meta = {"arch": arch, "shape": shape_name, "use_ep": use_ep,
            "fsdp": fsdp, "optimizer": optimizer,
            "sequence_parallel": act_sharding is not None,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "overrides": dict(overrides)}

    if shape.kind == "train":
        step = make_train_step(
            cfg, mesh=mesh, dp_axes=dp, use_ep=use_ep,
            act_sharding=act_sharding, optimizer=optimizer,
            remat_policy=remat_policy,
            microbatch=overrides.get("microbatch", 1),
            ep_fsdp=(use_ep and fsdp),
            accum_dtype=(torch.bfloat16 if overrides.get("accum_bf16")
                         else torch.float32))
        init = optim_lib.adamw_init if optimizer == "adamw" \
            else optim_lib.adafactor_init
        ocfg = optim_lib.AdamWConfig() if optimizer == "adamw" \
            else optim_lib.AdafactorConfig()
        opt = init(ocfg, model)
        return step, (model, opt, inputs), meta

    if shape.kind == "prefill":
        step = make_prefill_step(cfg, mesh=mesh, dp_axes=dp, use_ep=use_ep,
                                 act_sharding=act_sharding,
                                 ep_fsdp=(use_ep and fsdp))
        return step, (model, inputs), meta

    # decode: a cache holding S - 1 tokens; the step writes the last
    cache = tfm.init_cache(cfg, B, S, device="cpu")
    for c in cache["layers"]:
        if "idx" in c:
            c["idx"] = S - 1
    cache = distribute_cache(cache, cfg, mesh)
    serve = make_serve_step(cfg)

    def step(model, cache, token, cross_source=None):
        return serve(model, cache, token, cross_source, pos=S - 1)
    args = [model, cache, inputs["token"]]
    if "cross_source" in inputs:
        args.append(inputs["cross_source"])
    return step, tuple(args), meta


def _arg_parts(args, kind: str) -> Dict[str, Any]:
    if kind == "train":
        model, opt, batch = args
        return {"params": list(model.parameters()), "opt_state": opt,
                "batch": batch}
    if kind == "prefill":
        model, batch = args
        return {"params": list(model.parameters()), "batch": batch}
    model, cache, *rest = args
    return {"params": list(model.parameters()), "cache": cache,
            "batch": rest}


def account_cell(arch: str, shape_name: str, mesh, overrides=None,
                 shape=None) -> dict:
    """Build and run one cell under a fresh FakeTensorMode and return its
    record fields (the meta, and for a run cell memory, cost and
    collectives); {"skipped": why, ...} where the shape does not apply."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape = shape or SHAPES[shape_name]
    acc = _Accountant()
    with FakeTensorMode(), _dtensor_on_fake_tensors(acc):
        t0 = time.perf_counter()
        fn, args, meta = build_cell(arch, shape_name, mesh, overrides,
                                    shape)
        rec = dict(meta)
        if fn is None:
            return rec
        rec["build_s"] = time.perf_counter() - t0
        parts = {k: local_bytes(v)
                 for k, v in _arg_parts(args, shape.kind).items()}
        acc.seen(_arg_parts(args, shape.kind))
        t1 = time.perf_counter()
        with acc:
            out = fn(*args)
        rec["step_s"] = time.perf_counter() - t1
        if shape.kind == "train":
            out = out[1]        # the metrics: the new state is the args'
        elif shape.kind == "decode":
            out = out[:2]       # next token and logits: the cache is args'
        rec["memory"] = {
            "argument_size_in_bytes": sum(parts.values()),
            "output_size_in_bytes": local_bytes(out),
            "temp_size_in_bytes": acc.peak,
            "argument_bytes_by_part": parts,
            "temp_peak_at": acc.at_peak,
            "largest_temp": {"bytes": acc.largest[0],
                             "op": acc.largest[1]}}
        rec["cost"] = {"flops": float(acc.flops),
                       "bytes accessed": float(acc.bytes_accessed)}
        rec["collectives"] = acc.bytes_by_kind()
        rec["collective_counts"] = acc.counts()
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             force: bool = False, overrides=None, tag_suffix: str = "",
             mesh=None, shape=None) -> dict:
    """One cell on the production mesh of `mesh_kind` ("single" or
    "multi"; or on `mesh`, tagged `mesh_kind`), recorded in
    <out_dir>/<arch>__<shape>__<mesh_kind><tag_suffix>.json. A cell whose
    record exists is read back unless `force`, or unless the record has no
    `torch_version` (the reference's dry run writes the same names): then
    the cell runs and its record replaces that one. A failure is recorded
    ("error") and returned, not raised."""
    tag = f"{arch}__{shape_name}__{mesh_kind}{tag_suffix}"
    out_file = out_dir / f"{tag}.json"
    if out_file.exists() and not force:
        rec = json.loads(out_file.read_text())
        if "torch_version" in rec:
            print(f"[cached] {tag}: {rec.get('status')}")
            return rec
        print(f"[rerun] {tag}: the record in {out_dir} has no "
              f"torch_version (not the port's)")
    if mesh is None:
        mesh = production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = {"cell": tag, "mesh": list(mesh.shape),
           "mesh_axes": list(mesh.mesh_dim_names), "n_devices": mesh.size(),
           "torch_version": torch.__version__}
    if shape is not None:
        rec["shape_spec"] = dataclasses.asdict(shape)
    t0 = time.perf_counter()
    try:
        rec.update(account_cell(arch, shape_name, mesh, overrides, shape))
        if "skipped" in rec:
            rec["status"] = "skipped"
            print(f"[skip] {tag}: {rec['skipped']}")
        else:
            rec["status"] = "ok"
            print(f"[ok]   {tag}: flops={rec['cost']['flops']:.3e} "
                  f"bytes={rec['cost']['bytes accessed']:.3e} "
                  f"coll={rec['collectives'].get('total', 0):.3e}B "
                  f"args={rec['memory']['argument_size_in_bytes'] / 2**30:.2f}"
                  f"GiB temp={rec['memory']['temp_size_in_bytes'] / 2**30:.2f}"
                  f"GiB ({rec['step_s']:.1f} s step)")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {tag}: {rec['error'].splitlines()[0][:200]}")
    rec["wall_s"] = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else \
        [ALIASES.get(args.arch, args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    for mesh_kind in meshes:
        mesh = production_mesh(multi_pod=(mesh_kind == "multi"))
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh_kind, out_dir,
                               force=args.force, mesh=mesh)
                n_fail += rec.get("status") == "error"
    print(f"\ndone; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
