"""Builds the port's CUDA kernels from ``ops/csrc`` and loads them.

Each ``.cu`` file there has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library that ``ctypes`` loads: no
PyTorch headers, so a build takes seconds.  The library goes into
``build/distlearn_tpu_torch_kernels/`` beside the package (git-ignored),
named by a hash of its source and flags, so an edited source is rebuilt and
an unchanged one is reused.  ``nvcc`` is found under ``$CUDA_HOME``
(default ``/usr/local/cuda``) or on ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "distlearn_tpu_torch_kernels"
SOURCES = ("fused_update.cu", "wire_kernels.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH);"
                           " the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(sources=SOURCES) -> dict[str, str]:
    """Compile every source not yet built, all ``nvcc`` processes at once.
    Returns ``{source: compiler output}`` (ptxas register and spill report)
    for the sources compiled now; raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        logs[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src} (exit {proc.returncode}):\n{logs[src]}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The built library of ``source`` (building it first if needed)."""
    build_all((source,))
    return ctypes.CDLL(str(library_path(source)))


@functools.cache
def function(source: str, name: str, argtypes: tuple):
    """The C function ``name`` of ``source``'s library, typed: ``argtypes``
    (``ctypes.c_void_p`` for every pointer and the stream) and an ``int``
    return, the cudaError_t of the launch."""
    fn = getattr(load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
