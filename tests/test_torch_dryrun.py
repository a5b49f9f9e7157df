"""The port's dry run (`repro_torch.launch.dryrun`) on a fake process
group, each world in a spawned process of its own (the test's process
never starts a group), and the collectives' byte tally:

- `StepCommMode`'s bytes per kind equal what the reference's
  `collective_bytes` reads from HLO of the same five collectives, shapes
  and dtypes (`tests/test_roofline.py:106-122`), on a gloo world of 2;
- `run_cell` gives "ok" with flops > 0 for llama3.2-1b train, prefill and
  decode, deepseek-moe-16b train with EP, and the recurrent sequence
  forms (xlstm-1.3b and recurrentgemma-9b train and prefill), on fake
  (2, 4) ("data", "model") and (2, 2, 2) ("pod", "data", "model", without
  sequence-parallel activations) meshes at SMOKE size (the port's
  counterpart of the reference's
  `test_train_step_lowers_on_mesh`); each train cell's argument bytes for
  params and optimizer state equal, exactly, the per-device bytes of the
  reference's `param_specs` on the reference's leaf shapes (sLSTM's fused
  `wx` whole along "model", as the port places it);
- the skip reasons equal the reference's; `main` exits 1 on an injected
  error and records it;
- a record without `torch_version` (the reference's, same file name) is
  recomputed by `run_cell` and skipped by `load_records`; both CLIs
  default to results/dryrun_torch;
- scripts/torch_perf_hillclimb.py runs a one-cell plan (the reference's
  plan is its own) and writes only its records; scripts/
  torch_gen_experiments.py renders a small record directory with the
  counts taken from the records;
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
         ("llama3.2-1b", "decode"), ("deepseek-moe-16b", "train"),
         ("xlstm-1.3b", "train"), ("xlstm-1.3b", "prefill"),
         ("recurrentgemma-9b", "train"), ("recurrentgemma-9b", "prefill")]
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
    x itemsize, moments float32 twice. sLSTM's fused input projection
    `cell/wx` ((d, 4, H, dh) in the reference, (d, 4*H*dh) in the port)
    is whole along "model" in the port: its head shard is one that the
    merge hides (`sharding.rules.port_layout`)."""
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
    leaves = jax.tree_util.tree_leaves_with_path(ap)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    params = moments = 0
    for (path, leaf), spec in zip(leaves, spec_leaves):
        merged = jax.tree_util.keystr(path).endswith("['cell']['wx']")
        shards = 1
        for a in spec:
            for n in (a if isinstance(a, tuple) else (a,)):
                if n is not None and not (merged and n == "model"):
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


# -- the port's own records ---------------------------------------------------

class _Mesh:
    """What `run_cell` reads of a mesh it is given."""
    shape, mesh_dim_names = (16, 16), ("data", "model")

    def size(self):
        return 256


def test_records_without_torch_version_are_not_the_ports(
        tmp_path, monkeypatch, capsys):
    """The reference's dry run writes the same file names without
    `torch_version`: `run_cell` recomputes such a cell and replaces the
    record, reads a port record back, and `load_records` skips the
    reference's and says so once. Both CLIs default to
    results/dryrun_torch."""
    from pathlib import Path

    from repro_torch.launch import dryrun
    from repro_torch.roofline import report
    calls = []
    monkeypatch.setattr(dryrun, "account_cell",
                        lambda *a, **k: calls.append(a) or {"skipped": "x"})
    tag = "llama3_2_1b__train_4k__single"
    theirs = {"cell": tag, "status": "ok", "n_devices": 256,
              "cost": {"flops": 1.0}}
    (tmp_path / f"{tag}.json").write_text(json.dumps(theirs))
    rec = dryrun.run_cell("llama3_2_1b", "train_4k", "single", tmp_path,
                          mesh=_Mesh())
    assert len(calls) == 1
    assert rec["status"] == "skipped"
    assert rec["torch_version"] == torch.__version__
    assert json.loads((tmp_path / f"{tag}.json").read_text()) == rec
    again = dryrun.run_cell("llama3_2_1b", "train_4k", "single", tmp_path,
                            mesh=_Mesh())
    assert len(calls) == 1 and again == rec            # read back
    other = "xlstm_1_3b__train_4k__single"
    (tmp_path / f"{other}.json").write_text(json.dumps(dict(theirs,
                                                            cell=other)))
    (tmp_path / "other_arch__decode_32k__single.json").write_text(
        json.dumps(dict(theirs, cell="other_arch__decode_32k__single")))
    capsys.readouterr()
    assert [r["cell"] for r in report.load_records(tmp_path, "single")] \
        == [tag]
    err = capsys.readouterr().err
    assert err.count("[report] skipped 2 record(s)") == 1, err

    # the CLIs' defaults, from a scratch working directory
    monkeypatch.chdir(tmp_path)
    dirs = []
    monkeypatch.setattr(dryrun, "production_mesh", lambda **k: _Mesh())
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: dirs.append(a[3]) or {})
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape",
                        "train_4k"]) == 0
    monkeypatch.setattr(report, "load_records",
                        lambda d, m=None: dirs.append(d) or [])
    report.main([])
    assert dirs == [Path("results/dryrun_torch")] * 2


# -- the hill-climb and the EXPERIMENTS generator ----------------------------

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def _script(name):
    import runpy
    return runpy.run_path(os.path.join(SCRIPTS, name), run_name="imported")


def _hillclimb_rank(rank, world, init, work, rc_file):
    """The hill-climb's `main` on a one-cell plan at SMOKE size on a fake
    (2, 4) mesh, from the scratch working directory `work`."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import ShapeSpec
    torch.set_num_threads(1)
    os.chdir(work)
    dryrun.get_config = get_smoke_config
    spec = ShapeSpec("tiny_train", *TINY["train"], "train")
    plan = {"H0": ("llama3.2-1b", spec, [("", None),
                                         ("__mb2", {"microbatch": 2})])}
    mesh = dryrun.fake_mesh(*MESHES["2x4"])
    rc = _script("torch_perf_hillclimb.py")["main"](
        ["--out", "perf"], plan=plan, mesh=mesh)
    with open(rc_file, "w") as f:
        f.write(str(rc))


def test_hillclimb_runs_a_plan_and_writes_only_its_records(tmp_path,
                                                           capfd):
    work = tmp_path / "work"
    work.mkdir()
    rc_file = tmp_path / "rc"
    spawn(_hillclimb_rank, 1, tmp_path, str(work), str(rc_file),
          timeout=120)
    assert rc_file.read_text() == "0"
    files = sorted(str(p.relative_to(work)) for p in work.rglob("*")
                   if p.is_file())
    assert files == ["perf/llama3.2-1b__tiny_train__single.json",
                     "perf/llama3.2-1b__tiny_train__single__mb2.json"]
    recs = [json.loads((work / f).read_text()) for f in files]
    assert [r["status"] for r in recs] == ["ok", "ok"]
    assert recs[1]["overrides"] == {"microbatch": 2}
    assert all(r["torch_version"] == torch.__version__ for r in recs)
    out = capfd.readouterr().out
    assert "===== H0: llama3.2-1b x tiny_train =====" in out
    rows = {line.split()[0]: line.split()[1:] for line in out.splitlines()
            if line.split()[:1] in (["baseline"], ["__mb2"])}
    for r in recs:
        got = rows["__mb2" if r["overrides"] else "baseline"]
        gib = (r["memory"]["argument_size_in_bytes"]
               + r["memory"]["temp_size_in_bytes"]) / 2**30
        assert float(got[0]) == pytest.approx(r["cost"]["flops"], rel=1e-3)
        assert got[-1] == f"{gib:.2f}"
    # the reference's plan, unchanged
    ref_src = open(os.path.join(SCRIPTS, "perf_hillclimb.py")).read()
    namespace = {}
    exec(ref_src[ref_src.index("PLAN = {"):ref_src.index("\n\n\ndef main")],
         namespace)
    assert _script("torch_perf_hillclimb.py")["PLAN"] == namespace["PLAN"]


def _rec(cell, status, **kw):
    arch, shape, mesh = cell.split("__")
    r = {"cell": cell, "arch": arch, "shape": shape, "status": status,
         "n_devices": 256 if mesh == "single" else 512,
         "torch_version": "2.0.test"}
    if status == "ok":
        r.update(use_ep=False, fsdp=False, sequence_parallel=True,
                 optimizer="adamw",
                 memory={"argument_size_in_bytes": 2 * 2**30,
                         "temp_size_in_bytes": kw.get("temp", 3 * 2**30)},
                 cost={"flops": 1.5e14, "bytes accessed": 2.5e12},
                 collectives={"total": 4e9})
    elif status == "skipped":
        r["skipped"] = "pure full-attention arch"
    else:
        r["error"] = "RuntimeError: boom"
    return r


def test_gen_experiments_renders_the_ports_records(tmp_path):
    """EXPERIMENTS_TORCH.md from a small record directory: every cell's
    row, the counts taken from the records, the card's capacity, each
    record's torch version; a reference-shaped record is not rendered."""
    d = tmp_path / "dryrun_torch"
    d.mkdir()
    recs = [_rec("llama3.2-1b__train_4k__single", "ok"),
            _rec("xlstm-1.3b__train_4k__single", "ok", temp=90 * 2**30),
            _rec("llama3.2-1b__long_500k__single", "skipped"),
            _rec("xlstm-1.3b__prefill_32k__multi", "error"),
            _rec("llama3.2-1b__decode_32k__multi", "ok")]
    for r in recs:
        (d / f"{r['cell']}.json").write_text(json.dumps(r))
    theirs = dict(_rec("whisper-tiny__train_4k__single", "ok"))
    del theirs["torch_version"]
    (d / "whisper-tiny__train_4k__single.json").write_text(
        json.dumps(theirs))
    out = tmp_path / "EXPERIMENTS_TORCH.md"
    main = _script("torch_gen_experiments.py")["main"]
    assert main(["--dir", str(d), "--out", str(out)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "EXPERIMENTS_TORCH.md", "dryrun_torch"]
    text = out.read_text()
    for r in recs:
        assert f"| {r['cell']} | {r['status']} |" in text, r["cell"]
    assert "whisper-tiny" not in text
    flat = " ".join(text.split())
    assert "Cell totals: 3 ok, 1 skipped, 1 errors (5 records)." in flat
    assert "2 of the 3 ok cells fit 79.2 GiB per device" in flat
    assert "Skipped, 1 cells: pure full-attention arch." in flat
    assert "Errors: xlstm-1.3b__prefill_32k__multi." in flat
    assert "2.0.test (5)" in flat and "989 TFLOP/s" in flat
    assert "XLA" not in text and "ONCE" not in text


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
