"""Build and load the port's CUDA kernels: `nvcc` into a shared library with
a plain C interface, loaded through `ctypes`.

Each source under `csrc/` is compiled at first use into
`build/repro_torch_kernels/` at the root of the checkout, under a name that
carries a hash of the source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header is never served from a stale library.
`build_all()` starts one `nvcc` per source, all at once, and waits for them
together. `load` builds and loads under one lock, so threads that first use
a kernel at the same time run one build; builds that do race (two processes,
or `build_all` beside `load`) write separate temporary files and rename the
finished one into place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

#: kernel name -> source file under csrc/
SOURCES = {"megakernel": "megakernel.cu", "blur_stats": "blur_stats.cu",
           "iwe_accum": "iwe_accum.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
#: kernel name -> the compiler's report (`-Xptxas -v`: registers, shared
#: memory, spills) from the build in this process
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    path = Path("/usr/local/cuda/bin/nvcc")
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for `name` into a temporary file; returns (proc, tmp,
    target) or None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build_all(names: List[str] = None) -> None:
    """Compile every kernel source (or `names`) in parallel."""
    started = {n: _start(n) for n in (names or list(SOURCES))}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it at first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches`, under a lock: shards of
    a device grid launch from several threads at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1
