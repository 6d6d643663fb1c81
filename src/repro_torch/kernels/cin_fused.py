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

The backward (:class:`CinFused`, the ``torch.autograd.Function`` that
``ops.cin_fused`` applies under autograd) is two kernels of its own, since
torch cannot differentiate the CUDA forward and autograd of the plain
version materialises the outer product (20.4 GB a layer at B = 65,536):

* :func:`cin_fused_bwd_w_cuda` launches ``csrc/cin_fused_bwd_w.cu``: ``dW^T
  = Z . dOut`` over the ``B*D`` rows on the TF32 tensor cores in 3xTF32,
  as the forward (dOut split into hi and lo by a first kernel, each Z
  element formed and split in registers), rows split over blocks into a
  work buffer summed in a fixed order (deterministic);
* :func:`cin_fused_bwd_x_cuda` launches ``csrc/cin_fused_bwd_x.cu``: ``dx0``
  and ``dxk`` through ``G^T = dOut^T . W`` on the TF32 tensor cores in
  3xTF32, as the forward (W split into hi and lo tiles of five fields by
  40 j by a first kernel, each block's dOut staged in shared memory and
  split in registers), each G tile contracted with x0 and xk straight
  from the accumulators, so G never reaches device memory; one writer per
  output (deterministic);
* :func:`cin_fused_bwd_plain` (and its two halves) computes the same
  gradients with einsums -- the CPU path and the versions the kernels are
  held against on the card.

Shapes: x0 ``[B, F0, D]``, xk ``[B, Fk, D]``, W ``[H, F0*Fk]``, all
float32 -> ``[B, H, D]`` float32; the backward takes dOut ``[B, H, D]``.
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
    Inputs are checked here; raises if the launch fails. Autograd does not
    see through it: :class:`CinFused` carries the gradient."""
    _check(x0, xk, w)
    dev = _build.require("cin_fused", torch.float32, ("x0", "xk", "w"), x0,
                         xk, w)
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


# ------------------------------------------------------------------ backward
_BWD_W_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong,) \
    + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_BWD_X_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong,) \
    + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def _check_bwd(x0, xk, w, g) -> None:
    _check(x0, xk, w)
    b, _, d = x0.shape
    if tuple(g.shape) != (b, w.shape[0], d):
        raise ValueError(f"cin_fused backward: dOut {tuple(g.shape)}, "
                         f"expected {(b, w.shape[0], d)}")


def cin_fused_bwd_w_plain(x0: torch.Tensor, xk: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """``dW [H, F0*Fk] = sum_{b,d} dOut[b,h,d] x0[b,i,d] xk[b,j,d]`` in plain
    PyTorch (materialises the outer product)."""
    b, f0, d = x0.shape
    z = torch.einsum("bid,bjd->bijd", x0, xk).reshape(b, -1, d)
    return torch.einsum("bhd,bkd->hk", g, z)


def cin_fused_bwd_x_plain(x0: torch.Tensor, xk: torch.Tensor,
                          w: torch.Tensor, g: torch.Tensor) -> tuple:
    """``(dx0, dxk)`` in plain PyTorch through ``G[b,i,j,d] = sum_h
    W[h, i*Fk+j] dOut[b,h,d]`` (materialised)."""
    b, f0, d = x0.shape
    gg = torch.einsum("hk,bhd->bkd", w, g).reshape(b, f0, xk.shape[1], d)
    return (torch.einsum("bjd,bijd->bid", xk, gg),
            torch.einsum("bid,bijd->bjd", x0, gg))


def cin_fused_bwd_plain(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
                        g: torch.Tensor) -> tuple:
    """``(dx0, dxk, dW)`` of :func:`cin_fused_plain` for the output
    gradient ``g`` ``[B, H, D]``: what autograd of it gives, in the einsums
    of the two kernels' plain halves."""
    _check_bwd(x0, xk, w, g)
    dx0, dxk = cin_fused_bwd_x_plain(x0, xk, w, g)
    return dx0, dxk, cin_fused_bwd_w_plain(x0, xk, g)


@functools.lru_cache(maxsize=None)
def bwd_w_splits(device_index: int, ncols: int, f0: int, fk: int,
                 h: int) -> int:
    """Blocks that share one dW tile's rows on this card (asked of the
    library once per shape)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    fn = _build.function("cin_fused_bwd_w", "cin_fused_bwd_w_splits",
                         (ctypes.c_longlong,) + (ctypes.c_int,) * 4)
    return fn(ncols, f0, fk, h, sms)


@functools.lru_cache(maxsize=None)
def bwd_w_work_floats(b: int, f0: int, fk: int, h: int, d: int,
                      n_split: int) -> int:
    """Scratch floats of one dW launch: dOut split into TF32 hi and lo,
    and the partial sums where the rows are split (asked once per
    shape)."""
    fn = _build.function("cin_fused_bwd_w", "cin_fused_bwd_w_work_floats",
                         (ctypes.c_longlong,) + (ctypes.c_int,) * 5,
                         ctypes.c_longlong)
    return fn(b, f0, fk, h, d, n_split)


@functools.lru_cache(maxsize=None)
def bwd_x_smem_bytes(f0: int, h: int) -> int:
    """Shared memory one block of the dx kernel needs (asked of the library
    once per shape): the ring of W tile pairs, dOut's 128 rows for one
    chunk of H (the whole H up to 248 channels at F0 = 39) and the [F0 x
    128] dx0 sums. Above :data:`MAX_SMEM_BYTES` (F0 above 295) no tiling
    fits."""
    fn = _build.function("cin_fused_bwd_x", "cin_fused_bwd_x_smem_bytes",
                         (ctypes.c_int, ctypes.c_int), ctypes.c_longlong)
    return fn(f0, h)


@functools.lru_cache(maxsize=None)
def bwd_x_work_floats(f0: int, fk: int, h: int) -> int:
    """Scratch floats of one dx launch: W split into TF32 hi and lo tiles
    in the order the MMAs read them (asked once per shape)."""
    fn = _build.function("cin_fused_bwd_x", "cin_fused_bwd_x_work_floats",
                         (ctypes.c_int,) * 3, ctypes.c_longlong)
    return fn(f0, fk, h)


def cin_fused_bwd_w_cuda(x0: torch.Tensor, xk: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/cin_fused_bwd_w.cu`` on the current stream -> dW
    ``[H, F0*Fk]``. Raises if the launch fails."""
    dev = _build.require("cin_fused_bwd_w", torch.float32, ("x0", "xk", "g"),
                         x0, xk, g)
    b, f0, d = x0.shape
    fk, h = xk.shape[1], g.shape[1]
    if xk.shape[0] != b or xk.shape[2] != d or tuple(g.shape) != (b, h, d):
        raise ValueError(f"cin_fused_bwd_w: x0 {tuple(x0.shape)}, xk "
                         f"{tuple(xk.shape)}, dOut {tuple(g.shape)}")
    dw = torch.empty((h, f0 * fk), dtype=torch.float32, device=x0.device)
    n_split = bwd_w_splits(dev, b * d, f0, fk, h)
    work = torch.empty(bwd_w_work_floats(b, f0, fk, h, d, n_split),
                       dtype=torch.float32, device=x0.device)
    _build.launch("cin_fused_bwd_w",
                  _build.function("cin_fused_bwd_w", "cin_fused_bwd_w",
                                  _BWD_W_ARGTYPES), dev,
                  x0.data_ptr(), xk.data_ptr(), g.data_ptr(), dw.data_ptr(),
                  work.data_ptr(), b, f0, fk, h, d, n_split)
    return dw


def cin_fused_bwd_x_cuda(x0: torch.Tensor, xk: torch.Tensor, w: torch.Tensor,
                         g: torch.Tensor) -> tuple:
    """Launch ``csrc/cin_fused_bwd_x.cu`` on the current stream -> ``(dx0,
    dxk)``. Raises ValueError on a shape no tiling of the kernel fits, and
    if the launch fails."""
    _check_bwd(x0, xk, w, g)
    dev = _build.require("cin_fused_bwd_x", torch.float32,
                         ("x0", "xk", "w", "g"), x0, xk, w, g)
    b, f0, d = x0.shape
    fk, h = xk.shape[1], w.shape[0]
    if bwd_x_smem_bytes(f0, h) > MAX_SMEM_BYTES:
        raise ValueError(f"cin_fused_bwd_x: F0 = {f0} fields need "
                         f"{bwd_x_smem_bytes(f0, h)} bytes of shared "
                         f"memory per block, more than {MAX_SMEM_BYTES}")
    dx0 = torch.empty_like(x0)
    dxk = torch.empty_like(xk)
    work = torch.empty(bwd_x_work_floats(f0, fk, h), dtype=torch.float32,
                       device=x0.device)
    _build.launch("cin_fused_bwd_x",
                  _build.function("cin_fused_bwd_x", "cin_fused_bwd_x",
                                  _BWD_X_ARGTYPES), dev,
                  x0.data_ptr(), xk.data_ptr(), w.data_ptr(), g.data_ptr(),
                  dx0.data_ptr(), dxk.data_ptr(), work.data_ptr(), b, f0, fk,
                  h, d)
    return dx0, dxk


class CinFused(torch.autograd.Function):
    """One CIN step under autograd: the forward and both backward halves
    go through ``ops`` (the kernels on a card, their plain versions on the
    CPU; each launch counted there). Saves only ``x0``, ``xk`` and ``w``:
    the outer product is formed again, tile by tile, in the backward.
    Where ``xk`` is ``x0`` (the first layer) autograd sums the two input
    gradients."""

    @staticmethod
    def forward(ctx, x0, xk, w):
        from . import ops
        ctx.save_for_backward(x0, xk, w)
        return ops.cin_fused_forward(x0, xk, w)

    @staticmethod
    def backward(ctx, g):
        from . import ops
        x0, xk, w = ctx.saved_tensors
        g = g.contiguous()
        dx0 = dxk = dw = None
        if ctx.needs_input_grad[2]:
            dw = ops.cin_fused_bwd_w(x0, xk, g)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            dx0, dxk = ops.cin_fused_bwd_x(x0, xk, w, g)
        return dx0, dxk, dw
