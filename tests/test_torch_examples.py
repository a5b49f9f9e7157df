"""The port's CMAX examples and its profile gate, on the CPU at a small
size: each example's `main` runs with `--device cpu --windows 2 --events
1024` and prints its table; `scripts/check_torch_profiles.py` exits 0 with
JAX and the reference package blocked."""
import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--windows", "2", "--events", "1024"]

torch.set_num_threads(1)


def _load(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_its_table(capsys):
    rmse = _load("torch_quickstart").main(SMALL)
    out = capsys.readouterr().out
    assert "window |  true |omega|  est |omega|" in out
    assert out.count("|") >= 2 * 4
    assert f"RMSE vs ground truth: {rmse:.4f} rad/s" in out
    assert rmse < 0.5


def test_serve_batch_prints_its_table(capsys):
    rmse = _load("torch_serve_batch").main(SMALL)
    out = capsys.readouterr().out
    assert "stream  seq  status  bucket  batch" in out
    assert out.count(" ok ") == 8                  # 4 streams x 2 windows
    assert "8 windows in" in out and "0 shed" in out
    assert f"RMSE vs ground truth: {rmse:.4f} rad/s" in out
    assert rmse < 0.5


def test_adaptive_vs_fixed_prints_its_table(capsys):
    table = _load("torch_adaptive_vs_fixed").main(SMALL)
    out = capsys.readouterr().out
    for seq in ("poster", "boxes"):
        assert f"=== {seq} ===" in out
        for arm in ("full-resolution", "fixed-schedule", "runtime-adaptive"):
            rmse, cost = table[(seq, arm)]
            assert rmse < 1.0 and cost > 0
    assert out.count("budget-scheduled") == 6
    assert "vs fixed)" in out


@pytest.mark.parametrize("argv", [[], ["--device", "cpu"]])
def test_examples_parse_the_reference_sizes(argv, monkeypatch):
    """Defaults are the reference examples' sizes, on the card."""
    seen = {}

    def stop(spec, device=None):
        seen.update(n=(spec.n_windows, spec.events_per_window),
                    device=device)
        raise KeyboardInterrupt

    for name, want in (("torch_quickstart", (8, 4096)),
                       ("torch_serve_batch", (3, 4096)),
                       ("torch_adaptive_vs_fixed", (16, 4096))):
        mod = _load(name)
        monkeypatch.setattr(mod.ev, "make_sequence", stop)
        # the service would need the card before the first window is made
        monkeypatch.setattr(mod, "AsyncBatchedEstimationService",
                            lambda *a, **k: None, raising=False)
        with pytest.raises(KeyboardInterrupt):
            mod.main(argv)
        assert seen["n"] == want
        assert seen["device"] == (argv[1] if argv else "cuda")


def test_profile_gate_passes_without_the_reference():
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.argv = ["check_torch_profiles.py"]
        runpy.run_path({os.path.join(ROOT, "scripts",
                                     "check_torch_profiles.py")!r},
                       run_name="__main__")
    """)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "profile gate ok: 3 profiles valid" in out.stdout
