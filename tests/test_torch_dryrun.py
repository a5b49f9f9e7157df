"""The port's dry run (`repro_torch.launch.dryrun`) on a fake process
group, each world in a spawned process of its own (the test's process
never starts a group), and the collectives' byte tally:

- `StepCommMode`'s bytes per kind equal what the reference's
  `collective_bytes` reads from HLO of the same five collectives, shapes
  and dtypes (`tests/test_roofline.py:106-122`), on a gloo world of 2;
- `run_cell` gives "ok" with flops > 0 for llama3.2-1b train, prefill and
  decode and deepseek-moe-16b train with EP, on fake (2, 4) ("data",
  "model") and (2, 2, 2) ("pod", "data", "model", without
  sequence-parallel activations) meshes at SMOKE size (the port's
  counterpart of the reference's
  `test_train_step_lowers_on_mesh`); each train cell's argument bytes for
  params and optimizer state equal, exactly, the per-device bytes of the
  reference's `param_specs` on the reference's leaf shapes;
- the skip reasons equal the reference's; `main` exits 1 on an injected
  error and records it;
- the accountant alone, on fake tensors and no group: a product's flops
  and its operands' and output's bytes, nothing for a device read; under
  `_dtensor_on_fake_tensors` a bf16 `f32_product` is accounted as the
  card's one float32-output product, and the CPU's route is back on exit.

The ranks import this module, so it imports neither JAX nor the
reference at the top.
"""
import json
import math
import os

import pytest
import torch

from torch_dist_helpers import spawn, start_rank, stop_rank

TINY = {"train": (64, 8), "prefill": (64, 8), "decode": (64, 8)}
CELLS = [("llama3.2-1b", "train"), ("llama3.2-1b", "prefill"),
         ("llama3.2-1b", "decode"), ("deepseek-moe-16b", "train")]
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


# -- collectives --------------------------------------------------------------

# (kind, shape of the collective's output, dtype): tests/test_roofline.py
COLLECTIVES = [("all-gather", (4, 1024), torch.bfloat16),
               ("all-reduce", (256,), torch.float32),
               ("reduce-scatter", (2, 128), torch.float32),
               ("collective-permute", (8,), torch.bfloat16),
               ("all-to-all", (16, 16), torch.float32)]


def _comm_rank(rank, world, init, out):
    import torch.distributed as dist

    from repro_torch.sharding.comms import StepCommMode
    start_rank(rank, world, init)
    try:
        shapes = {k: (s, dt) for k, s, dt in COLLECTIVES}
        mode = StepCommMode()
        with mode:
            s, dt = shapes["all-gather"]
            g = torch.empty(s, dtype=dt)
            dist.all_gather_into_tensor(g, torch.ones(s[0] // world, s[1],
                                                      dtype=dt))
            s, dt = shapes["all-reduce"]
            dist.all_reduce(torch.ones(s, dtype=dt))
            s, dt = shapes["reduce-scatter"]
            r = torch.empty(s, dtype=dt)
            dist.reduce_scatter_tensor(r, torch.ones(s[0] * world, s[1],
                                                     dtype=dt))
            s, dt = shapes["collective-permute"]
            peer = (rank + 1) % world
            got = torch.empty(s, dtype=dt)
            work = dist.isend(torch.full(s, rank, dtype=dt), peer)
            dist.recv(got, (rank - 1) % world)
            work.wait()
            s, dt = shapes["all-to-all"]
            a = torch.empty(s, dtype=dt)
            dist.all_to_all_single(a, torch.ones(s, dtype=dt))
        with open(f"{out}.{rank}", "w") as f:
            json.dump({"bytes": mode.bytes_by_kind(),
                       "counts": mode.counts()}, f)
    finally:
        stop_rank()


def test_collective_bytes_equal_the_reference(tmp_path, monkeypatch):
    out = str(tmp_path / "comm")
    spawn(_comm_rank, 2, tmp_path, out, timeout=60)
    # the reference's parser sets XLA_FLAGS on import: keep it to the test
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.dryrun import collective_bytes
    names = {torch.bfloat16: "bf16", torch.float32: "f32"}
    hlo = "\n".join(
        f"%x{i} = {names[dt]}[{','.join(map(str, s))}]{{0}} {k}(%y{i})"
        for i, (k, s, dt) in enumerate(COLLECTIVES))
    want = collective_bytes(hlo)
    for rank in range(2):
        got = json.loads(open(f"{out}.{rank}").read())
        assert got["bytes"] == want, (rank, got)
        assert got["counts"]["send"] == got["counts"]["recv"] == 1


# -- cells on a fake group ----------------------------------------------------

def _cells_rank(rank, world, init, mesh_name, out_dir):
    from pathlib import Path

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import ShapeSpec
    torch.set_num_threads(1)
    dryrun.get_config = get_smoke_config       # SMOKE widths and depths
    shape, names = MESHES[mesh_name]
    mesh = dryrun.fake_mesh(shape, names)
    # sequence-parallel activations on a 3-D mesh cost DTensor's
    # redistribution planner minutes even at SMOKE size: the SP path is
    # held on (2, 4), and (2, 2, 2) runs the reference's `no_sp` knob
    overrides = {"no_sp": True} if len(shape) == 3 else None
    for arch, kind in CELLS:
        S, B = TINY[kind]
        spec = ShapeSpec(f"tiny_{kind}", S, B, kind)
        dryrun.run_cell(arch, spec.name, mesh_name, Path(out_dir),
                        force=True, mesh=mesh, shape=spec,
                        overrides=overrides)


def _reference_bytes(arch, mesh_name):
    """(params, AdamW moments) bytes per device from the reference's
    `param_specs` on its SMOKE leaves: numel / the sharded axes' product
    x itemsize, moments float32 twice."""
    import jax
    from jax.sharding import AbstractMesh

    from repro.configs import get_smoke_config
    from repro.models import model as r_model
    from repro.sharding import rules as r_rules
    shape, names = MESHES[mesh_name]
    am = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    cfg = get_smoke_config(arch)
    ap = r_model.abstract_params(cfg, max_len=TINY["train"][0])
    specs = r_rules.param_specs(ap, cfg, am,
                                fsdp=cfg.param_count() > 8e9)
    leaves = jax.tree_util.tree_leaves(ap)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    params = moments = 0
    for leaf, spec in zip(leaves, spec_leaves):
        shards = 1
        for a in spec:
            for n in (a if isinstance(a, tuple) else (a,)):
                if n is not None:
                    shards *= sizes[n]
        n_loc = math.prod(leaf.shape) // shards
        params += n_loc * leaf.dtype.itemsize
        moments += 2 * n_loc * 4
    return params, moments


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cells_run_on_a_fake_group(tmp_path, mesh_name):
    spawn(_cells_rank, 1, tmp_path, mesh_name, str(tmp_path), timeout=150)
    for arch, kind in CELLS:
        cell = f"{arch}__tiny_{kind}__{mesh_name}"
        rec = json.loads((tmp_path / f"{cell}.json").read_text())
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["n_devices"] == math.prod(MESHES[mesh_name][0])
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
        assert rec["memory"]["temp_size_in_bytes"] > 0
        assert rec["collectives"]["total"] > 0
        assert rec["torch_version"] == torch.__version__
        assert rec["use_ep"] == (arch == "deepseek-moe-16b"
                                 and kind == "train")
        assert rec["sequence_parallel"] == (
            mesh_name == "2x4" and kind != "decode" and not rec["use_ep"])
        if kind == "train":
            parts = rec["memory"]["argument_bytes_by_part"]
            assert (parts["params"], parts["opt_state"]) == \
                _reference_bytes(arch, mesh_name), cell
        if rec["use_ep"]:
            assert rec["collectives"].get("all-to-all", 0) > 0 \
                or rec["collective_counts"].get("all_to_all_single", 0) > 0


def test_skip_reasons_equal_the_reference(monkeypatch):
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.dryrun import build_cell
    from repro_torch.models.model import SHAPES
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.configs import get_config as ref_get_config
    from repro.launch.dryrun import build_cell as ref_build_cell
    from repro.models import SHAPES as REF_SHAPES
    from repro.models import shape_applicable as ref_applicable
    from repro_torch.models import shape_applicable
    n_skipped = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if ref_applicable(ref_get_config(arch), REF_SHAPES[shape])[0]:
                assert shape_applicable(get_config(arch), SHAPES[shape])[0]
                continue
            # a skipped cell returns before either build_cell reads the mesh
            want = ref_build_cell(arch, shape, None)
            got = build_cell(arch, shape, None)
            assert want[0] is None and got[0] is None, (arch, shape)
            assert got[2] == want[2], (arch, shape)
            n_skipped += 1
    assert n_skipped >= 7


def _main_rank(rank, world, init, out_dir, rc_file):
    from repro_torch.launch import dryrun

    def boom(*a, **k):
        raise RuntimeError("injected fault")
    dryrun.build_cell = boom
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                      "--mesh", "single", "--out", out_dir, "--force"])
    with open(rc_file, "w") as f:
        f.write(str(rc))


def test_main_exits_1_on_an_error_and_records_it(tmp_path):
    rc_file = tmp_path / "rc"
    spawn(_main_rank, 1, tmp_path, str(tmp_path), str(rc_file), timeout=60)
    assert rc_file.read_text() == "1"
    rec = json.loads((tmp_path / "llama3_2_1b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: injected fault"
    assert "injected fault" in rec["traceback"]
    assert rec["n_devices"] == 256


# -- the accountant -----------------------------------------------------------

def test_accountant_counts_what_the_ops_move():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import _Accountant, _dtensor_on_fake_tensors
    from repro_torch.models import layers
    m, k, n = 256, 512, 128
    cpu_route = layers._local_f32_product
    acc = _Accountant()
    with FakeTensorMode():
        x, w = torch.empty(m, k), torch.empty(k, n)
        acc.seen([x, w])
        with acc:
            y = x @ w
            assert not x.is_cuda and x.device.type == "cpu"
        assert acc.flops == 2 * m * k * n
        assert acc.bytes_accessed == 4 * (m * k + k * n + m * n)
        assert acc.peak == 4 * m * n
        del y

        card = _Accountant()
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        card.seen([xb, wb])
        with _dtensor_on_fake_tensors(card), card:
            out = layers.f32_product(xb, wb)
        assert out.dtype == torch.float32 and out.shape == (m, n)
        assert card.flops == 2 * m * k * n
        assert card.bytes_accessed == 2 * (m * k + k * n) + 4 * m * n
    assert layers._local_f32_product is cpu_route
