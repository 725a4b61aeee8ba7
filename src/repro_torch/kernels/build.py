"""Builds the hand-written Hopper kernels and loads them with ``ctypes``.

Each source under ``src/repro_torch/csrc/`` is compiled by its own ``nvcc``
process into a shared library with a plain C interface, all of them started
together, at first use.  The libraries land in ``build/kernels/`` at the
root of the checkout, named by a hash of their source, so an edited source
is rebuilt and an unchanged one is loaded as it is.  A failed build raises
with the compiler's output.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG.parents[1] / "build" / "kernels"
SOURCES = {
    "fp8_gemm": "fp8_gemm.cu",
    "fp8_grouped_gemm": "fp8_grouped_gemm.cu",
    "paged_decode": "paged_decode.cu",
    "radix_topk": "radix_topk.cu",
    "batch_attention": "batch_attention.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}      # name -> ptxas report of the last build
BUILDS = 0      # nvcc runs started in this process (``analysis.guards``)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all in parallel.  Returns the wall seconds spent."""
    global BUILDS
    t0 = time.perf_counter()
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return 0.0
    BUILDS += len(todo)
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building every missing
    kernel first."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check(code: int, name: str) -> None:
    """Raise on a nonzero code returned by a launch: a ``cudaGetLastError``
    code, or minus the ``CUresult`` of a refused TMA tensor-map encoding."""
    if code < 0:
        raise RuntimeError(f"{name}: TMA tensor-map encoding failed with "
                           f"CUresult {-code}")
    if code != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{code}")
