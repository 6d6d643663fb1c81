"""Fused CIN (Compressed Interaction Network) step for xDeepFM.

One CIN step computes, per sample b and output channel h:

    out[b, h, :] = sum_{i, j} W[h, i*Fk + j] * (x0[b, i, :] * xk[b, j, :])

an outer product of field embeddings followed by a 1x1 compression.

* :func:`cin_fused_cuda` launches ``csrc/cin_fused.cu``: the product
  ``W [H, F0*Fk] . Z [F0*Fk, B*D]`` in float32 with the outer product Z
  never formed, as ``sum_i x0[i] * (W_i . xk)`` -- one register-tiled GEMM
  over j per field i, from x0 and xk staged in shared memory;
* :func:`cin_fused_plain` computes the same function in plain PyTorch with
  the reference oracle's two einsums (``repro.kernels.ref.cin_fused_ref``),
  which materialise the ``[B, F0*Fk, D]`` outer product -- the CPU path and
  the version the kernel is held against on the card.

Shapes: x0 ``[B, F0, D]``, xk ``[B, Fk, D]``, W ``[H, F0*Fk]``, all
float32 -> ``[B, H, D]`` float32.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
#: shared memory of one block may not exceed this (sm_90); the kernel
#: stages F0 + Fk rows of 64 columns (see csrc/cin_fused.cu)
MAX_SMEM_BYTES = 232448


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
    for name, t in (("x0", x0), ("xk", xk), ("w", w)):
        if (t.dtype != torch.float32 or not t.is_cuda
                or not t.is_contiguous()):
            raise ValueError(f"cin_fused: {name} must be a contiguous float32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if t.device != x0.device:
            raise ValueError("cin_fused: inputs on different devices")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x0, xk, w)):
        raise RuntimeError("cin_fused: the CUDA kernel has no backward yet; "
                           "call it under torch.no_grad()")
    b, f0, d = x0.shape
    fk, h = xk.shape[1], w.shape[0]
    lib = _build.load("cin_fused")
    smem = lib.cin_fused_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    if smem(f0, fk) > MAX_SMEM_BYTES:
        raise ValueError(f"cin_fused: F0 + Fk = {f0 + fk} fields need "
                         f"{smem(f0, fk)} bytes of shared memory per block, "
                         f"more than {MAX_SMEM_BYTES}")
    out = torch.empty((b, h, d), dtype=torch.float32, device=x0.device)
    fn = lib.cin_fused
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x0.data_ptr(), xk.data_ptr(), w.data_ptr(), out.data_ptr(),
                 b, f0, fk, h, d, stream)
    if err:
        raise RuntimeError(f"cin_fused launch failed: cudaError {err}")
    return out
