"""Build the port's CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch/`` at the repository root, named by a hash of the
source and the flags -- an edited source rebuilds, an unchanged one is
reused. The first use builds every missing library, one ``nvcc`` per
source, all started together. Nothing is built or loaded at import time:
the CPU test suite imports these modules on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ell_pull_multi", "mask_reduce", "ell_pull", "cin_fused",
           "segment_bag", "ell_pull_payload")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
#: compiler output (ptxas register / spill report) of each library built by
#: this process, by source name
BUILD_LOG: dict = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build on the machine with the card")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> list:
    """Compile every source in ``names`` whose library is missing; returns
    the names built. Raises with the compiler's output on failure."""
    with _lock:
        todo = [(n, library_path(n)) for n in names
                if not library_path(n).exists()]
        if not todo:
            return []
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode:
                failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            else:
                os.replace(tmp, out)   # atomic: concurrent loaders never
                                       # see a half-written library
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return [n for n, _ in todo]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is None:
        build()
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
