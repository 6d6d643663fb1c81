"""Per-lane payload (min-plus) pull over ELL-padded parent lists.

The payload sibling of the lane-word pull for the ``min_plus`` combine
spec: each row takes the elementwise minimum over its parents of
``payload[parent] + weight(edge)`` (the weighted-SSSP relaxation; with zero
weights, min-label propagation):

    out[r, q] = min_{k: parents[r,k] >= 0} (payload[parents[r,k], q] + w[r,k])

masked to the combine identity (``COMBINE_SPECS["min_plus"].identity``,
2**30) where ``active[r, q] == 0`` or no parent is valid. The add wraps as
int32 arithmetic does.

* :func:`ell_pull_payload_cuda` launches ``csrc/ell_pull_payload.cu``
  (a group of lanes per row, lane q = payload lane q; idle rows skipped,
  valid parents compacted before the gathers);
* :func:`ell_pull_payload_plain` computes the same function in plain
  PyTorch (the CPU path and the version the kernel is held against on the
  card).

Shapes: parents ``[R, K]`` int32 (-1 padded), payload ``[N, W]`` int32,
weights ``[R, K]`` int32, active ``[R, W]`` int32 -> ``[R, W]`` int32. No
traversal of the reference calls it (its payload plane is push-only); it
is ported with parity alone.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p)


def identity() -> int:
    """The ``min_plus`` combine's identity (2**30; the CUDA source holds the
    same constant)."""
    # imported here: core.comm imports kernels.ops, which imports this module
    from repro_torch.core.comm.base import COMBINE_SPECS
    return COMBINE_SPECS["min_plus"].identity


def _check(parents, payload, weights, active) -> None:
    if any(t.dim() != 2 for t in (parents, payload, weights, active)):
        raise ValueError("ell_pull_payload: parents [R, K], payload [N, W], "
                         "weights [R, K], active [R, W] expected")
    r, _ = parents.shape
    if (weights.shape != parents.shape
            or tuple(active.shape) != (r, payload.shape[1])):
        raise ValueError(
            f"ell_pull_payload: inconsistent shapes parents "
            f"{tuple(parents.shape)}, payload {tuple(payload.shape)}, "
            f"weights {tuple(weights.shape)}, active {tuple(active.shape)}")
    for name, t in (("parents", parents), ("payload", payload),
                    ("weights", weights), ("active", active)):
        if t.dtype != torch.int32:
            raise ValueError(f"ell_pull_payload: {name} must be int32, got "
                             f"{t.dtype}")


def ell_pull_payload_plain(parents: torch.Tensor, payload: torch.Tensor,
                           weights: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch min-plus pull (int64 add wrapped to int32)."""
    _check(parents, payload, weights, active)
    ident = identity()
    r, w = active.shape
    if parents.shape[1] == 0:
        return torch.full((r, w), ident, dtype=torch.int32,
                          device=active.device)
    valid = parents >= 0
    vals = (payload[parents.clamp(min=0).long()].long()
            + weights.long()[..., None]) & 0xFFFFFFFF          # [R, K, W]
    vals = torch.where(vals >= 2**31, vals - 2**32, vals)
    vals = torch.where(valid[..., None], vals, ident)
    acc = vals.amin(1).clamp(max=ident)
    return torch.where(active != 0, acc, ident).to(torch.int32)


def ell_pull_payload_cuda(parents: torch.Tensor, payload: torch.Tensor,
                          weights: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/ell_pull_payload.cu`` on the current stream ->
    ``[R, W]``. Inputs are checked here (the kernel trusts the parent ids:
    each must be -1 or a row of ``payload``); raises if the launch fails."""
    _check(parents, payload, weights, active)
    dev = _build.require("ell_pull_payload", None,
                         ("parents", "payload", "weights", "active"),
                         parents, payload, weights, active)
    r, k = parents.shape
    out = torch.empty_like(active)
    _build.launch("ell_pull_payload", _build.function(
        "ell_pull_payload", "ell_pull_payload", _ARGTYPES), dev,
        parents.data_ptr(), payload.data_ptr(), weights.data_ptr(),
        active.data_ptr(), out.data_ptr(), r, k, active.shape[1])
    return out
