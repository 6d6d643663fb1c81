"""EmbeddingBag: ragged gather + per-bag weighted sum.

    out[b, :] = sum_{l : indices[b, l] >= 0} weights[b, l] * table[indices[b, l], :]

Bags are padded to a fixed width L (index -1 = padding); ``weights=None``
means ones. The table is ``[V, D]`` float32 or bfloat16, the output is in
the table's dtype; sums accumulate in float32 and round once.

* :func:`segment_bag_cuda` launches ``csrc/segment_bag.cu`` (several bags
  a warp at narrow rows, columns across the lanes; weights read in their
  own type);
* :func:`segment_bag_plain` computes the same function in plain PyTorch
  (the CPU path and the version the kernel is held against on the card).

No path of the reference runs it (``repro.kernels.segment_bag`` has no
caller in ``src/``); it is ported with parity alone.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_longlong,)
             + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_DTYPES = (torch.float32, torch.bfloat16)


def _check(table, indices, weights) -> None:
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError("segment_bag: table [V, D] and indices [B, L] "
                         "expected")
    if weights is not None and weights.shape != indices.shape:
        raise ValueError(f"segment_bag: weights {tuple(weights.shape)} != "
                         f"indices {tuple(indices.shape)}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"segment_bag: table dtype {table.dtype} not in "
                         f"{sorted(map(str, _DTYPES))}")
    if indices.dtype != torch.int32:
        raise ValueError(f"segment_bag: indices must be int32, got "
                         f"{indices.dtype}")
    if table.shape[0] == 0 and indices.numel():
        raise ValueError("segment_bag: indices into an empty table")
    if weights is not None and weights.dtype not in (torch.float32,
                                                     table.dtype):
        raise ValueError(f"segment_bag: weights must be float32 or "
                         f"{table.dtype}, got {weights.dtype}")


def segment_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch EmbeddingBag (float32 sums, rounded once)."""
    _check(table, indices, weights)
    valid = indices >= 0
    rows = table[indices.clamp(min=0).long()].float()          # [B, L, D]
    w = (torch.ones(indices.shape, dtype=torch.float32, device=table.device)
         if weights is None else weights.float())
    w = torch.where(valid, w, 0.0)[..., None]
    return (rows * w).sum(1).to(table.dtype)


def segment_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/segment_bag.cu`` on the current stream -> ``[B, D]``.
    Inputs are checked here (the kernel trusts the indices: each must be
    -1 or a row of ``table``); raises if the launch fails."""
    _check(table, indices, weights)
    tensors = (table, indices) + (() if weights is None else (weights,))
    dev = _build.require("segment_bag", None, ("table", "indices", "weights"),
                         *tensors)
    b, l = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    _build.launch("segment_bag", _build.function(
        "segment_bag", "segment_bag", _ARGTYPES), dev,
        table.data_ptr(), indices.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(),
        b, l, d, table.dtype == torch.bfloat16,
        weights is not None and weights.dtype == torch.bfloat16)
    return out
