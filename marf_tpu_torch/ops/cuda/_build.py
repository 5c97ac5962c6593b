"""Build a csrc/*.cu source into a shared library with a plain C interface
and load it with ctypes.

The library is compiled at first use with
`nvcc -gencode arch=compute_90a,code=sm_90a` into `build/marf_tpu_torch/` at
the repository root (listed in .gitignore), under a file name keyed by a hash
of the sources, the shared headers (csrc/*.cuh) and the flags, so an edited
source rebuilds and an unchanged one is loaded as it is. A library's first
load is the tracer's span `build.<name>` (utils/trace.py). Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Callable

from marf_tpu_torch.utils import trace

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CSRC)), "build", "marf_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
# seconds the last nvcc run took, per library (0.0 when it was loaded from the build directory)
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and /usr/local/cuda/bin)")


def _so_path(name: str, sources: list[str]) -> str:
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_libraries(specs: dict[str, list[str]]) -> None:
    """Compile each missing lib<name>-<hash>.so of {name: sources}, one nvcc
    process per library, all started together."""
    running = {}
    for name, sources in specs.items():
        so_path = _so_path(name, sources)
        BUILD_SECONDS.setdefault(name, 0.0)
        if os.path.isfile(so_path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[os.path.join(_CSRC, f) for f in sources]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so_path, time.perf_counter())
    for name, (proc, tmp, so_path, t0) in running.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{out}")
        os.replace(tmp, so_path)  # atomic: a concurrent loader never sees a partial file
        BUILD_SECONDS[name] = time.perf_counter() - t0


def load_library(name: str, sources: list[str], bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Compile csrc/<sources> into lib<name>-<hash>.so (once), load it and
    set its C signatures with `bind` (once)."""
    if name in _loaded:
        return _loaded[name]
    with trace.span(f"build.{name}"):
        build_libraries({name: sources})
        lib = ctypes.CDLL(_so_path(name, sources))
        bind(lib)
    _loaded[name] = lib
    return lib
