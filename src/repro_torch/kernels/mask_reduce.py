"""Delegate combine folds, the local phase of the paper's delegate
reduction (Section V-A): the all-gathered partials of every partition are
folded into one.

* :func:`mask_reduce_cuda` -- word-wise OR of K partial masks into
  ``prev``, plus (``with_count``) the per-word popcount of the newly set
  bits (the bit-plane OR combine);
* :func:`payload_min_fold_cuda` -- elementwise int32 min of K partials
  into ``prev``, plus (``with_count``) a 0/1 "improved" flag (the ``min``
  combine of the single-source path's delegate levels).

Each fold also has an ``*_apply`` sibling that fuses it with the step
code consuming its output, so a sweep's delegate update is one launch
from the gathered words to the new delegate state:

* :func:`mask_reduce_apply_cuda` -- the serving step's OR fold of the
  gathered lane words, the unvisited mask, the new level (or visited and
  frontier) plane and the per-lane flags (:class:`DelegateApply`);
* :func:`payload_min_fold_apply_cuda` -- the single-source step's min
  fold into its delegate levels with the per-row "improved" flag.

All launch ``csrc/mask_reduce.cu``; ``*_plain`` beside them compute the
same functions in plain PyTorch (the CPU path and the reference the
kernels are held against on the card). Words are int32 bit patterns.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.types import INF_LEVEL

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p)
_OR_APPLY_ARGTYPES = (ctypes.c_void_p,) * 7 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_MIN_APPLY_ARGTYPES = (ctypes.c_void_p,) * 4 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)


class DelegateApply(NamedTuple):
    """One sweep's delegate update of the lane-word step (rows ``p``,
    delegates ``d``, lanes ``W``)."""

    level: torch.Tensor                  # [p, d, W] new levels or visited
    frontier: Optional[torch.Tensor]     # [p, d, W] bool; visited planes only
    lane_new: torch.Tensor               # [p, W] bool: lane marked a delegate
    lane_unhit: Optional[torch.Tensor]   # [p, W] bool: a target still unvisited
    any_new: torch.Tensor                # [p] bool: some delegate was marked


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


def mask_reduce_apply_plain(gathered: torch.Tensor, level: torch.Tensor,
                            it: torch.Tensor,
                            target: Optional[torch.Tensor] = None
                            ) -> DelegateApply:
    """Plain PyTorch ``mask_reduce_apply``: the serving step's delegate
    chain as it ran on the fold's output. ``gathered [K, d * nw]`` int32
    lane words of every partition, ``level [p, d, W]`` int32 levels
    (``INF_LEVEL`` = unvisited; newly marked lanes get ``it + 1``) or bool
    visited (newly marked lanes are set, and are the new frontier), ``it
    [p]`` int32, ``target [p, d, W]`` bool or None."""
    p, d, w = level.shape
    combined, _ = mask_reduce_plain(gathered, gathered.new_zeros(
        gathered.shape[1:]), with_count=False)
    nw = -(-w // 32)
    shifts = torch.arange(32, dtype=torch.int32, device=combined.device)
    words = combined.reshape(d, nw)
    lanes = ((((words[..., None] >> shifts) & 1) > 0)
             .reshape(d, nw * 32)[..., :w])
    visited_planes = level.dtype == torch.bool
    unvis = ~level if visited_planes else level == int(INF_LEVEL)
    newly = lanes & unvis
    if visited_planes:
        new_level, frontier = level | newly, newly
    else:
        new_level = torch.where(newly, (it + 1)[:, None, None], level)
        frontier = None
    unhit = None if target is None else (target & unvis & ~newly).any(1)
    return DelegateApply(new_level, frontier, newly.any(1), unhit,
                         newly.flatten(1).any(1))


def payload_min_fold_apply_plain(gathered: torch.Tensor, prev: torch.Tensor):
    """Plain PyTorch ``payload_min_fold_apply``: ``gathered [K, d]`` int32
    min-folded into every row of ``prev [p, d]`` -> ``(min(prev, min_k
    gathered[k]) [p, d], improved [p] bool)``, the single-source step's
    chain on the fold's output."""
    folded, _ = payload_min_fold_plain(
        gathered, torch.full(gathered.shape[1:], int(INF_LEVEL),
                             dtype=gathered.dtype, device=gathered.device),
        with_count=False)
    out = torch.minimum(prev, folded)
    return out, (out < prev).any(1)


def mask_reduce_apply_cuda(gathered: torch.Tensor, level: torch.Tensor,
                           it: torch.Tensor,
                           target: Optional[torch.Tensor] = None, *,
                           flags: Optional[torch.Tensor] = None
                           ) -> DelegateApply:
    """:func:`mask_reduce_apply_plain` in one launch on the card.
    ``flags`` is the flag buffer (bool ``[p, 4 * (2 * ceil(W / 4) + 1)]``,
    cleared by the call; allocated where None); the lane flags come back
    as views of it."""
    if level.dim() != 3 or gathered.dim() != 2 or it.shape != level.shape[:1]:
        raise ValueError("mask_reduce_apply: gathered [K, d * nw], level "
                         f"[p, d, W], it [p]; got {tuple(gathered.shape)}, "
                         f"{tuple(level.shape)}, {tuple(it.shape)}")
    p, d, w = level.shape
    f4 = -(-w // 4)
    if gathered.shape[1] != d * -(-w // 32):
        raise ValueError(f"mask_reduce_apply: gathered {tuple(gathered.shape)}"
                         f" is not [K, {d} * {-(-w // 32)}]")
    if target is not None and target.shape != level.shape:
        raise ValueError("mask_reduce_apply: target must be shaped as level")
    if flags is None:
        flags = torch.empty((p, 4 * (2 * f4 + 1)), dtype=torch.bool,
                            device=level.device)
    tensors = (gathered, level, it, flags) + (() if target is None
                                              else (target,))
    dev = _build.require("mask_reduce_apply", None,
                         ("gathered", "level", "it", "flags", "target"),
                         *tensors)
    if (gathered.dtype != torch.int32 or it.dtype != torch.int32
            or level.dtype not in (torch.int32, torch.bool)
            or flags.dtype != torch.bool or flags.shape != (p, 4 * (2 * f4 + 1))
            or (target is not None and target.dtype != torch.bool)):
        raise ValueError("mask_reduce_apply: gathered and it int32, level "
                         "int32 or bool, target bool, flags bool "
                         f"[{p}, {4 * (2 * f4 + 1)}]")
    visited = level.dtype == torch.bool
    out = torch.empty_like(level)
    frontier = torch.empty_like(level) if visited else None
    _build.launch("mask_reduce_apply",
                  _build.function("mask_reduce", "mask_reduce_apply",
                                  _OR_APPLY_ARGTYPES), dev,
                  gathered.data_ptr(), level.data_ptr(), it.data_ptr(),
                  None if target is None else target.data_ptr(),
                  out.data_ptr(), None if frontier is None
                  else frontier.data_ptr(), flags.data_ptr(),
                  gathered.shape[0], p, d, w, int(visited), int(INF_LEVEL))
    return DelegateApply(out, frontier, flags[:, :w],
                         None if target is None
                         else flags[:, 4 * f4:4 * f4 + w], flags[:, 8 * f4])


def payload_min_fold_apply_cuda(gathered: torch.Tensor, prev: torch.Tensor,
                                *, flags: Optional[torch.Tensor] = None):
    """:func:`payload_min_fold_apply_plain` in one launch on the card.
    ``flags`` is the flag buffer (bool ``[4 * ceil(p / 4)]``, cleared by the
    call; allocated where None); ``improved`` comes back as a view of it."""
    if gathered.dim() != 2 or prev.dim() != 2 or \
            prev.shape[1] != gathered.shape[1]:
        raise ValueError("payload_min_fold_apply: gathered [K, d] and prev "
                         f"[p, d], got {tuple(gathered.shape)} and "
                         f"{tuple(prev.shape)}")
    p, d = prev.shape
    if flags is None:
        flags = torch.empty(4 * -(-p // 4), dtype=torch.bool,
                            device=prev.device)
    dev = _build.require("payload_min_fold_apply", None,
                         ("gathered", "prev", "flags"), gathered, prev, flags)
    if (gathered.dtype != torch.int32 or prev.dtype != torch.int32
            or flags.dtype != torch.bool or flags.shape != (4 * -(-p // 4),)):
        raise ValueError("payload_min_fold_apply: gathered and prev int32, "
                         f"flags bool [{4 * -(-p // 4)}]")
    out = torch.empty_like(prev)
    _build.launch("payload_min_fold_apply",
                  _build.function("mask_reduce", "payload_min_fold_apply",
                                  _MIN_APPLY_ARGTYPES), dev,
                  gathered.data_ptr(), prev.data_ptr(), out.data_ptr(),
                  flags.data_ptr(), gathered.shape[0], p, d)
    return out, flags[:p]
