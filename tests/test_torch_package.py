"""The port as a package: every module (and the port's examples, its
profile gate, its hill-climb and its EXPERIMENTS generator) imports with
JAX and the reference package blocked, two threads that first use a
kernel at once run one build
(`kernels/_build.py::load`), and launch counts lose no update across
threads."""
import os
import subprocess
import sys
import textwrap
import threading
import types

import repro_torch
from repro_torch.configs import ARCH_IDS
from repro_torch.kernels import _build

SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
ROOT = os.path.dirname(SRC)
EXTRA = [os.path.join(ROOT, "examples", f"torch_{n}.py")
         for n in ("quickstart", "serve_batch", "adaptive_vs_fixed",
                   "lm_pretrain", "fault_tolerant_train")] + [
    os.path.join(ROOT, "scripts", n) for n in (
        "check_torch_profiles.py", "torch_perf_hillclimb.py",
        "torch_gen_experiments.py")]


def test_every_module_imports_without_jax_or_the_reference():
    code = textwrap.dedent("""
        import pkgutil, runpy, sys
        sys.modules["jax"] = None        # any import of them now raises
        sys.modules["repro"] = None
        import repro_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        for name in names:
            __import__(name)
        # the examples, the profile gate and the dry-run scripts import
        # only the port too
        for path in sys.argv[1:]:
            runpy.run_path(path, run_name="imported")
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code, *EXTRA], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("repro_torch.launch.serve", "repro_torch.serving.workload",
                "repro_torch.telemetry.registry", "repro_torch.telemetry.spans",
                "repro_torch.telemetry.decisions",
                "repro_torch.telemetry.export",
                "repro_torch.costmodel.model",
                "repro_torch.costmodel.scheduler",
                "repro_torch.costmodel.profiles", "repro_torch.data.events",
                "repro_torch.core.pipeline", "repro_torch.kernels.ops",
                "repro_torch.core.energy", "repro_torch.core.distributed",
                "repro_torch.launch.mesh", "repro_torch.data.lm",
                "repro_torch.models", "repro_torch.models.config",
                "repro_torch.models.layers", "repro_torch.models.moe",
                "repro_torch.models.recurrent",
                "repro_torch.models.transformer", "repro_torch.models.model",
                "repro_torch.models.leaves", "repro_torch.train",
                "repro_torch.train.optim", "repro_torch.train.checkpoint",
                "repro_torch.train.ft", "repro_torch.train.loop",
                "repro_torch.launch.train", "repro_torch.convert",
                "repro_torch.sharding", "repro_torch.sharding.rules",
                "repro_torch.sharding.comms", "repro_torch.train.pipeline",
                "repro_torch.configs", "repro_torch.configs.cmax_camel",
                "repro_torch.roofline", "repro_torch.roofline.analysis",
                "repro_torch.roofline.report", "repro_torch.launch.dryrun",
                *[f"repro_torch.configs.{a}" for a in ARCH_IDS]):
        assert mod in names, mod


def test_load_builds_once_when_two_threads_first_use_a_kernel(tmp_path,
                                                              monkeypatch):
    """nvcc stubbed by a script that counts its runs and takes a while;
    the loader's library handle stubbed too (the output is no library)."""
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        echo run >> {runs}
        sleep 0.5
        while [ $# -gt 0 ]; do
          if [ "$1" = "-o" ]; then : > "$2"; fi
          shift
        done
    """))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: types.SimpleNamespace(path=path)))

    start = threading.Barrier(2)
    libs = []

    def first_use():
        start.wait(timeout=30)
        libs.append(_build.load("megakernel"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(libs) == 2 and libs[0] is libs[1]
    assert runs.read_text().splitlines() == ["run"]
    assert libs[0].path == str(_build._target("megakernel"))
    assert _build.load("megakernel") is libs[0]           # cached
    assert runs.read_text().splitlines() == ["run"]


def test_launch_counts_lose_no_update_across_threads():
    """Shards of a device grid launch kernels from several threads at once:
    `count_launch` must not lose an increment (more threads than cores, a
    very short switch interval)."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, per_thread = 4 * (os.cpu_count() or 1), 2000
    start = threading.Barrier(n_threads)

    def hammer():
        start.wait(timeout=30)
        for _ in range(per_thread):
            _build.count_launch(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per_thread
