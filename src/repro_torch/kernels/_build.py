"""Build the port's CUDA kernels, load them with ``ctypes`` and launch them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library under
``build/repro_torch/`` at the repository root, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags -- an edited
source or header rebuilds, an unchanged one is reused. The first use builds every missing library, one ``nvcc`` per
source, all started together. Nothing is built or loaded at import time:
the CPU test suite imports these modules on machines without ``nvcc``.

Every wrapper launches through the same three helpers, so a launch costs
one pass over its tensors and one ``ctypes`` call: :func:`require` checks
dtype, device and contiguity in one pass, :func:`function` hands out each
C entry prototyped once at load (``argtypes`` / ``restype`` are never set
per call), and :func:`launch` passes the card's current stream and
raises on a nonzero ``cudaError``, entering a device guard only when the
tensors lie on another card than the current one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("ell_pull_multi", "mask_reduce", "ell_pull", "cin_fused",
           "segment_bag", "ell_pull_payload", "cin_fused_bwd_w",
           "cin_fused_bwd_x")
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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
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


@functools.lru_cache(maxsize=None)
def function(name: str, entry: str, argtypes: tuple,
             restype=ctypes.c_int):
    """The C function ``entry`` of ``csrc/<name>.cu`` (built and loaded on
    first use), its prototype set once here: pointers and the stream as
    ``c_void_p``, so ctypes never cuts a 64-bit address."""
    fn = getattr(load(name), entry)
    fn.argtypes, fn.restype = list(argtypes), restype
    return fn


def require(what: str, dtype, names: tuple, *tensors) -> int:
    """One pass over ``tensors`` (named by ``names``): each must be a
    contiguous CUDA tensor of ``dtype`` (any dtype where ``dtype`` is None)
    on the first one's card. Returns that card's index; raises ValueError."""
    idx = tensors[0].get_device()
    if idx < 0 or not tensors[0].is_cuda:
        raise ValueError(f"{what}: {names[0]} must be a CUDA tensor, got one "
                         f"on {tensors[0].device}")
    for name, t in zip(names, tensors):
        if t.get_device() != idx:          # -1 off the cards
            raise ValueError(f"{what}: inputs on different devices ({name} "
                             f"on {t.device}, not cuda:{idx})")
        if (dtype is not None and t.dtype != dtype) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{dtype or 'CUDA'} tensor, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")
    return idx


def launch(what: str, fn, idx: int, *args) -> None:
    """``fn(*args, stream)`` with card ``idx``'s current stream; raises if
    it returns a nonzero ``cudaError`` (a refused launch never runs, and a
    later synchronize would not report it). The stream comes from
    ``torch._C._cuda_getCurrentRawStream``, the raw handle behind
    ``torch.cuda.current_stream(idx).cuda_stream`` without the Stream
    object that costs a few microseconds a call."""
    if idx == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
