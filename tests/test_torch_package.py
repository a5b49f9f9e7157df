"""The port as a package: every module imports with JAX and the reference
package blocked, and two threads that first use a kernel at once run one
build (`kernels/_build.py::load`)."""
import os
import subprocess
import sys
import textwrap
import threading
import types

import repro_torch
from repro_torch.kernels import _build

SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))


def test_every_module_imports_without_jax_or_the_reference():
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None        # any import of them now raises
        sys.modules["repro"] = None
        import repro_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
        for name in names:
            __import__(name)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro")
                  and sys.modules[m] is not None]
        assert not leaked, leaked
        print(" ".join(names))
    """)
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env,
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
                "repro_torch.core.pipeline", "repro_torch.kernels.ops"):
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
