"""Fused CIN (Compressed Interaction Network) step for xDeepFM.

One CIN step computes, per sample b and output channel h:

    out[b, h, :] = sum_{i, j} W[h, i*Fk + j] * (x0[b, i, :] * xk[b, j, :])

an outer product of field embeddings followed by a 1x1 compression.

* :func:`cin_fused_cuda` launches ``csrc/cin_fused.cu``: the product
  ``Z^T [(b, d), F0*Fk] . W^T [F0*Fk, H]`` on the TF32 tensor cores
  (``wgmma``) in 3xTF32 (Z and W split into TF32 hi and lo parts, ``lo*hi
  + hi*lo + hi*hi`` summed in float32; float32-grade results), with each Z
  element formed in registers from x0 and xk staged in shared memory, so
  the outer product Z never reaches device memory. A first kernel splits
  W into hi and lo in the order the MMAs read it; where the output tiles
  cannot fill the card (B = 512) the k steps are split over blocks whose
  partial sums a last kernel adds in a fixed order: two calls on the same
  inputs give bit-equal outputs. One call counts as one launch;
* :func:`cin_fused_plain` computes the same function in plain PyTorch with
  the reference oracle's two einsums (``repro.kernels.ref.cin_fused_ref``),
  which materialise the ``[B, F0*Fk, D]`` outer product -- the CPU path and
  the version the kernel is held against on the card.

Shapes: x0 ``[B, F0, D]``, xk ``[B, Fk, D]``, W ``[H, F0*Fk]``, all
float32 -> ``[B, H, D]`` float32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) \
    + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
#: shared memory of one block may not exceed this (sm_90); the kernel
#: stages F0 + Fk rows of 128 columns (see csrc/cin_fused.cu)
MAX_SMEM_BYTES = 232448


@functools.lru_cache(maxsize=None)
def smem_bytes(f0: int, fk: int) -> int:
    """Shared memory one block of the kernel needs for these field counts
    (asked of the library once per pair)."""
    fn = _build.function("cin_fused", "cin_fused_smem_bytes",
                         (ctypes.c_int, ctypes.c_int), ctypes.c_longlong)
    return fn(f0, fk)


@functools.lru_cache(maxsize=None)
def splits(device_index: int, ncols: int, f0: int, fk: int, h: int) -> int:
    """Blocks that share one output tile's k steps on this card (1 once the
    tiles fill its multiprocessors); asked of the library once per shape."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    fn = _build.function("cin_fused", "cin_fused_splits",
                         (ctypes.c_longlong,) + (ctypes.c_int,) * 4)
    return fn(ncols, f0, fk, h, sms)


@functools.lru_cache(maxsize=None)
def work_floats(b: int, f0: int, fk: int, h: int, d: int, n_split: int) -> int:
    """Scratch floats of one launch: W split into TF32 hi and lo, and the
    partial sums where the k steps are split (asked once per shape)."""
    fn = _build.function("cin_fused", "cin_fused_work_floats",
                         (ctypes.c_longlong,) + (ctypes.c_int,) * 5,
                         ctypes.c_longlong)
    return fn(b, f0, fk, h, d, n_split)


def _check(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor) -> None:
    if x0.dim() != 3 or xk.dim() != 3 or w.dim() != 2:
        raise ValueError("cin_fused: x0 [B, F0, D], xk [B, Fk, D], "
                         "w [H, F0*Fk] expected")
    b, f0, d = x0.shape
    if xk.shape[0] != b or xk.shape[2] != d or w.shape[1] != f0 * xk.shape[1]:
        raise ValueError(
            f"cin_fused: inconsistent shapes x0 {tuple(x0.shape)}, "
            f"xk {tuple(xk.shape)}, w {tuple(w.shape)}")


def cin_fused_plain(x0: torch.Tensor, xk: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CIN step (materialises the outer product)."""
    _check(x0, xk, w)
    outer = torch.einsum("bid,bjd->bijd", x0, xk)
    b, f0, fk, d = outer.shape
    return torch.einsum("hf,bfd->bhd", w, outer.reshape(b, f0 * fk, d))


def cin_fused_cuda(x0: torch.Tensor, xk: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/cin_fused.cu`` on the current stream -> ``[B, H, D]``.
    Inputs are checked here; raises if the launch fails. There is no
    backward yet, so inputs that require grad are refused."""
    _check(x0, xk, w)
    dev = _build.require("cin_fused", torch.float32, ("x0", "xk", "w"), x0,
                         xk, w)
    if torch.is_grad_enabled() and (x0.requires_grad or xk.requires_grad
                                    or w.requires_grad):
        raise RuntimeError("cin_fused: the CUDA kernel has no backward yet; "
                           "call it under torch.no_grad()")
    b, f0, d = x0.shape
    fk, h = xk.shape[1], w.shape[0]
    if smem_bytes(f0, fk) > MAX_SMEM_BYTES:
        raise ValueError(f"cin_fused: F0 + Fk = {f0 + fk} fields need "
                         f"{smem_bytes(f0, fk)} bytes of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}")
    out = torch.empty((b, h, d), dtype=torch.float32, device=x0.device)
    n_split = splits(dev, b * d, f0, fk, h)
    work = torch.empty(work_floats(b, f0, fk, h, d, n_split),
                       dtype=torch.float32, device=x0.device)
    _build.launch("cin_fused",
                  _build.function("cin_fused", "cin_fused", _ARGTYPES), dev,
                  x0.data_ptr(), xk.data_ptr(), w.data_ptr(), out.data_ptr(),
                  work.data_ptr(), b, f0, fk, h, d, n_split)
    return out
