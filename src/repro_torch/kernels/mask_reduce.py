"""Delegate combine folds, the local phase of the paper's delegate
reduction (Section V-A): the all-gathered partials of every partition are
folded into one.

* :func:`mask_reduce_cuda` -- word-wise OR of K partial masks into
  ``prev``, plus (``with_count``) the per-word popcount of the newly set
  bits (the bit-plane OR combine);
* :func:`payload_min_fold_cuda` -- elementwise int32 min of K partials
  into ``prev``, plus (``with_count``) a 0/1 "improved" flag (the ``min``
  combine of the single-source path's delegate levels).

Both launch ``csrc/mask_reduce.cu``; ``*_plain`` beside them compute the
same functions in plain PyTorch (the CPU path and the reference the
kernels are held against on the card). Words are int32 bit patterns.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p)


def or_fold(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of int32 ``words`` along ``dim`` (an unrolled word-OR
    chain: PyTorch has no OR reduction)."""
    out = words.new_zeros(words.shape[:dim] + words.shape[dim + 1:])
    for j in range(words.shape[dim]):
        out |= words.select(dim, j)
    return out


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of int32 bit patterns -> int32."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).sum(-1, dtype=torch.int32)


def mask_reduce_plain(partials: torch.Tensor, prev: torch.Tensor,
                      with_count: bool = True):
    """Plain PyTorch ``mask_reduce``: ``(prev | OR_k partials[k],
    popcount(combined & ~prev) or None)``."""
    combined = prev | or_fold(partials, 0)
    if not with_count:
        return combined, None
    return combined, popcount(combined & ~prev)


def payload_min_fold_plain(partials: torch.Tensor, prev: torch.Tensor,
                           with_count: bool = True):
    """Plain PyTorch ``payload_min_fold``: ``(min(prev, min_k partials[k]),
    (combined < prev) as int32 or None)``."""
    combined = prev
    for k in range(partials.shape[0]):
        combined = torch.minimum(combined, partials[k])
    if not with_count:
        return combined, None
    return combined, (combined < prev).to(torch.int32)


def _fold_cuda(entry: str, partials: torch.Tensor, prev: torch.Tensor,
               with_count: bool):
    """Launch the ``entry`` fold of ``csrc/mask_reduce.cu`` on the current
    stream. Inputs are checked here (the kernel trusts them); raises if the
    launch fails."""
    shape = partials.shape
    if len(shape) != 2 or prev.shape != shape[1:]:
        raise ValueError(f"{entry}: partials [K, NW] and prev [NW], got "
                         f"{tuple(partials.shape)} and {tuple(prev.shape)}")
    dev = _build.require(entry, torch.int32, ("partials", "prev"), partials,
                         prev)
    k, nw = shape
    out = torch.empty_like(prev)
    count = torch.empty_like(prev) if with_count else None
    _build.launch(entry, _build.function("mask_reduce", entry, _ARGTYPES), dev,
                  partials.data_ptr(), prev.data_ptr(), out.data_ptr(),
                  count.data_ptr() if with_count else None, k, nw)
    return out, count


def mask_reduce_cuda(partials: torch.Tensor, prev: torch.Tensor,
                     with_count: bool = True):
    """The OR fold on the card -> ``(or_mask, new_bits_per_word or None)``."""
    return _fold_cuda("mask_reduce", partials, prev, with_count)


def payload_min_fold_cuda(partials: torch.Tensor, prev: torch.Tensor,
                          with_count: bool = True):
    """The int32 min fold on the card -> ``(combined, improved or None)``."""
    return _fold_cuda("payload_min_fold", partials, prev, with_count)
