"""Single-source bit pull with early exit (the paper's backward visit).

Each active row scans its parents chunk by chunk against a bit-packed
frontier mask and stops after the first chunk that holds a frontier
parent:

    found[r] = active[r] == 1 and some parent u, in the chunks entered,
               has bit (u & 31) of word (u >> 5) of the mask set
    work[r]  = in-row parent slots of every chunk entered

Two entry points share one CUDA kernel (``csrc/ell_pull.cu``):

* :func:`ell_pull_bits_cuda` -- the main path: a stacked CSR (offsets
  ``[p, R+1]``, cols ``[p, E]``), the column domain's frontier mask
  ``[p, ceil(N/32)]`` (packed by ``core.comm.pack_lanes`` over the vertex
  axis) and active rows ``[p, R]``; returns found ``[p, R]`` and work
  ``[p, R]``. One launch pulls one subgraph for every emulated partition.
* the reference kernel's ELL contract (parents ``[R, W]`` -1 padded, one
  chunk of width W, negative columns skipped), through
  :func:`~repro_torch.kernels.ell_pull_multi.ell_as_csr` in ``ops.ell_pull``.

:func:`ell_pull_bits_plain` computes the main-path function in plain
PyTorch (the CPU path and the reference the kernel is held against on the
card). All tensors are int32; mask words are int32 bit patterns.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ell_pull_multi import ell_pull_chunked_plain

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p)


def _check_stacked(offsets, cols, mask, active, chunk):
    if chunk <= 0:
        raise ValueError(f"ell_pull: chunk must be > 0, got {chunk}")
    if any(t.dim() != 2 for t in (offsets, cols, mask, active)):
        raise ValueError("ell_pull: offsets [p, R+1], cols [p, E], mask "
                         "[p, ceil(N/32)], active [p, R] expected")
    p, r1 = offsets.shape
    if (cols.shape[0] != p or mask.shape[0] != p
            or tuple(active.shape) != (p, r1 - 1)):
        raise ValueError(
            f"ell_pull: inconsistent shapes offsets {tuple(offsets.shape)}, "
            f"cols {tuple(cols.shape)}, mask {tuple(mask.shape)}, "
            f"active {tuple(active.shape)}")


def ell_pull_bits_plain(offsets: torch.Tensor, cols: torch.Tensor,
                        mask: torch.Tensor, active: torch.Tensor,
                        chunk: int):
    """Plain PyTorch bit pull over a stacked CSR -> (found, work).

    The single-bit pull is the lane-word pull with one lane: vertex u's
    frontier word is bit u of the mask, a row's need word is its active
    flag, and "need covered" is "found". So this runs
    :func:`~repro_torch.kernels.ell_pull_multi.ell_pull_chunked_plain` on
    those one-lane words (one host round trip per chunk)."""
    _check_stacked(offsets, cols, mask, active, chunk)
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    bits = (mask[..., None] >> shifts) & 1             # [p, NWm, 32]
    frontier = bits.reshape(mask.shape[0], -1, 1).contiguous()
    need = (active == 1).to(torch.int32)[..., None]
    found, work = ell_pull_chunked_plain(offsets, cols, frontier, need, chunk)
    return found[..., 0], work


def ell_pull_bits_cuda(offsets: torch.Tensor, cols: torch.Tensor,
                       mask: torch.Tensor, active: torch.Tensor, chunk: int):
    """Launch ``csrc/ell_pull.cu`` on the current stream -> (found, work).
    Inputs are checked here (the kernel trusts them, column ids included:
    each must be < 32 * mask.shape[1]); raises if the launch fails."""
    _check_stacked(offsets, cols, mask, active, chunk)
    dev = _build.require("ell_pull", torch.int32,
                         ("offsets", "cols", "mask", "active"), offsets,
                         cols, mask, active)
    p, r1 = offsets.shape
    found = torch.empty_like(active)
    work = torch.empty_like(active)
    _build.launch("ell_pull",
                  _build.function("ell_pull", "ell_pull_bits", _ARGTYPES), dev,
                  offsets.data_ptr(), cols.data_ptr(), mask.data_ptr(),
                  active.data_ptr(), found.data_ptr(), work.data_ptr(),
                  p, r1 - 1, cols.shape[1], mask.shape[1], chunk)
    return found, work
