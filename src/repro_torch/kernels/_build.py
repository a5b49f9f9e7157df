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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

from ..telemetry.spans import step

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


class _Aside(threading.local):
    launches = None


#: the calling thread's launches counted aside (`tally_launches`)
_aside = _Aside()
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


def build_all(names: List[str] = None) -> List[str]:
    """Compile every kernel source (or `names`) in parallel; returns the
    names that nvcc built (those not built already)."""
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
    return [n for n, s in started.items() if s is not None]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it at first use (a
    `kernel_load` step span where a service traces the batch)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with step("kernel_load", kernel=name) as span:
                built = build_all([name])
                lib = ctypes.CDLL(str(_target(name)))
            if span is not None:
                span.attrs["nvcc"] = bool(built)
            _LIBS[name] = lib
        return lib


def count_launch(wrapper, n: int = 1) -> None:
    """Add `n` to a kernel wrapper's `launches`, under a lock: shards of
    a device grid launch from several threads at once. Inside the calling
    thread's `tally_launches` the count goes to its dict instead."""
    aside = _aside.launches
    if aside is not None:
        aside[wrapper] = aside.get(wrapper, 0) + n
        return
    with _COUNT_LOCK:
        wrapper.launches += n


@contextlib.contextmanager
def tally_launches():
    """Count the calling thread's launches inside the block aside, in the
    dict it yields (wrapper -> launches), not in the wrappers' `launches`:
    a CUDA graph being captured launches nothing until it is replayed."""
    saved, _aside.launches = _aside.launches, {}
    try:
        yield _aside.launches
    finally:
        _aside.launches = saved
