"""What the harness loads, and that it is driven by data: a new mix and a
new per-layer metric are found by name with no file edited."""
import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

from cmax_bench import spec

BENCH = Path(spec.HERE)
ROOT = Path(spec.ROOT)


def test_the_harness_and_the_reference_load_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
        import cmax_bench
        from cmax_bench import harness, spec
        for m in pkgutil.walk_packages(cmax_bench.__path__, "cmax_bench."):
            if ".tests" not in m.name:
                importlib.import_module(m.name)
        cell = spec.find_cell("davis240-batched.replay-40k")
        for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["per_layer"]:
            spec.layer_reader(w["name"])
        harness.port_config(cell.config)
        import repro_torch.launch.serve, repro_torch.serving.workload
        print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    top = set(out.stdout.split())
    assert "cmax_bench" in top and "repro_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, top


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "repro_torch", "repro", "jax", "benchmarks"), (path, n)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import cmax_bench.reference.cmax; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert "repro_torch" not in out.stdout.split()


def test_a_loaded_jax_module_is_found_by_its_whole_top_level_name():
    from cmax_bench import harness
    saved = dict(sys.modules)
    try:
        for name in list(sys.modules):
            if name.split(".")[0] in harness.FORBIDDEN:
                del sys.modules[name]
        sys.modules["repro_torch_extra"] = object()   # not "repro"
        sys.modules["jaxtyping"] = object()           # not "jax"
        assert harness.loaded_forbidden() == []
        sys.modules["repro.core"] = object()
        sys.modules["flax"] = None                    # blocked, not loaded
        assert harness.loaded_forbidden() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in folder.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_mix_and_a_new_layer_metric_are_found_by_name(tmp_path):
    bench = tmp_path / "cmax_bench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(bench)
    mix = {"name": "replay-sparse", "loop": "closed", "streams": 16,
           "outstanding": 2, "recording_windows": 64,
           "events": {"law": "fixed", "n": 5000}}
    (bench / "traffic" / "replay-sparse.json").write_text(json.dumps(mix))
    (bench / "layer_metrics" / "batches_in_window.py").write_text(
        "def read(data):\n    return float(len(data.window_batches))\n")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "davis240-batched.replay-sparse",
                             "config": "davis240-batched",
                             "traffic": "replay-sparse", "chips": 1,
                             "why": "sparse windows"})
    for m in doc["end_to_end"]:
        if m["name"] == "windows_per_s":
            m["workloads"].append("davis240-batched.replay-sparse")
    doc["per_layer"].append({"name": "batches_in_window.replay",
                             "unit": "batches", "better": "higher",
                             "source": "program_counter",
                             "layer": "service", "moves": "windows_per_s",
                             "workloads": ["davis240-batched.replay-sparse"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = spec.find_cell("davis240-batched.replay-sparse", root=tmp_path,
                          here=bench)
    assert cell.traffic == mix
    assert cell.config["name"] == "davis240-batched"
    assert [m["name"] for m in cell.end_to_end] == ["windows_per_s",
                                                    "setup_s"]
    readers = spec.layer_readers(cell, here=bench)
    assert list(readers) == ["batches_in_window.replay"]

    class Data:
        window_batches = [1, 2, 3]
    assert readers["batches_in_window.replay"](Data()) == 3.0
    after = digest(bench)
    added = {"traffic/replay-sparse.json",
             "layer_metrics/batches_in_window.py"}
    assert set(after) - set(before) == added
    assert {k: v for k, v in after.items() if k not in added} == before
