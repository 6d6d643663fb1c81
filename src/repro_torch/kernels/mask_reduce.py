"""Delegate combine folds, the local phase of the paper's delegate
reduction (Section V-A): the all-gathered partials of every partition are
folded into one.

* :func:`mask_reduce_cuda` -- word-wise OR of K partial masks into
  ``prev``, plus (``with_count``) the per-word popcount of the newly set
  bits (the bit-plane OR combine);
* :func:`payload_min_fold_cuda` -- elementwise int32 min of K partials
  into ``prev``, plus (``with_count``) a 0/1 "improved" flag (the ``min``
  combine of the single-source path's delegate levels);
* :func:`group_fold_cuda` -- the same OR or min fold without ``prev`` (the
  op's identity held in registers) over K rows read in place by two
  strides, one output row a group: the prev-less fold of a gathered
  ``[K, n]`` and the group fold of the emulated stacked rows ``[p, n]``
  over one axis group (the combine's folds before its last).

Each fold also has an ``*_apply`` sibling that fuses it with the step code
consuming its output, so a sweep's delegate update is one launch from the
gathered words to the new delegate state:

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

_OR_APPLY_ARGTYPES = (ctypes.c_void_p,) * 7 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_MIN_APPLY_ARGTYPES = (ctypes.c_void_p,) * 4 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)
#: ``fold_rows`` (and ``fold_empty``) of ``csrc/mask_reduce.cu``: rows,
#: prev, out, count, op, K, the member stride, groups, the group stride,
#: n (strides and n in words), the stream
_FOLD_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int) + (
    ctypes.c_longlong,) * 4 + (ctypes.c_void_p,)
#: the folds' op codes in ``csrc/mask_reduce.cu``, and their kernels' names
_OPS = {"or": 0, "min": 1}
_NAMES = {"or": "mask_reduce", "min": "payload_min_fold"}


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


def _fold_cuda(entry: str, op: str, partials: torch.Tensor,
               prev: torch.Tensor, with_count: bool):
    """Launch the ``op`` fold of ``partials [K, NW]`` into ``prev [NW]``
    through the C entry ``entry`` of ``csrc/mask_reduce.cu`` (``fold_rows``;
    ``fold_empty``: the same path to an empty kernel) on the current
    stream. Inputs are checked here (the kernel trusts them); raises if the
    launch fails."""
    name, shape = _NAMES[op], partials.shape
    if len(shape) != 2 or prev.shape != shape[1:]:
        raise ValueError(f"{name}: partials [K, NW] and prev [NW], got "
                         f"{tuple(partials.shape)} and {tuple(prev.shape)}")
    dev = _build.require(name, torch.int32, ("partials", "prev"), partials,
                         prev)
    out = torch.empty_like(prev)
    count = torch.empty_like(prev) if with_count else None
    n = shape[1]
    _build.launch(name, _build.function("mask_reduce", entry, _FOLD_ARGTYPES),
                  dev, partials.data_ptr(), prev.data_ptr(), out.data_ptr(),
                  count.data_ptr() if with_count else None, _OPS[op],
                  shape[0], n, 1, 0, n)
    return out, count


def mask_reduce_cuda(partials: torch.Tensor, prev: torch.Tensor,
                     with_count: bool = True):
    """The OR fold on the card -> ``(or_mask, new_bits_per_word or None)``."""
    return _fold_cuda("fold_rows", "or", partials, prev, with_count)


def payload_min_fold_cuda(partials: torch.Tensor, prev: torch.Tensor,
                          with_count: bool = True):
    """The int32 min fold on the card -> ``(combined, improved or None)``."""
    return _fold_cuda("fold_rows", "min", partials, prev, with_count)


def _group_check(rows: torch.Tensor, op: str, k: int, k_stride: int,
                 groups: int, g_stride: int) -> int:
    """The op's code in ``csrc/mask_reduce.cu`` where the geometry is one:
    ``rows`` 2-D, k and groups in [1, 65535], strides >= 0 and every member
    a row; raises ValueError otherwise."""
    code = _OPS.get(op)
    if (code is None or rows.dim() != 2 or k < 1 or groups < 1
            or k_stride < 0 or g_stride < 0 or groups > 65535
            or (groups - 1) * g_stride + (k - 1) * k_stride >= len(rows)):
        raise ValueError(f"group_fold: rows [R, n], op 'or' or 'min', k and "
                         f"groups in [1, 65535], strides >= 0 and every "
                         f"member a row; got {tuple(rows.shape)}, {op!r}, k="
                         f"{k} by {k_stride}, groups={groups} by {g_stride}")
    return code


def group_fold_plain(rows: torch.Tensor, op: str, k: int, k_stride: int = 1,
                     groups: int = 1, g_stride: int = 0) -> torch.Tensor:
    """Plain PyTorch ``group_fold``: ``out[g] = OR`` (``op="or"``) or
    ``min`` (``"min"``) over ``i < k`` of ``rows[g * g_stride + i *
    k_stride]`` -> ``[groups, n]``; no ``prev`` (the op's identity: 0, or
    the int32 maximum)."""
    _group_check(rows, op, k, k_stride, groups, g_stride)
    idx = (torch.arange(groups, device=rows.device)[:, None] * g_stride
           + torch.arange(k, device=rows.device) * k_stride)
    members = rows[idx]                                  # [groups, k, n]
    return or_fold(members, 1) if op == "or" else members.amin(1)


def _group_fold_cuda(entry: str, rows: torch.Tensor, op: str, k: int,
                     k_stride: int, groups: int, g_stride: int):
    """Launch :func:`group_fold_plain`'s fold through the C entry ``entry``
    of ``csrc/mask_reduce.cu`` (``fold_rows``; ``fold_empty``: the same
    path to an empty kernel) on the current stream."""
    code = _group_check(rows, op, k, k_stride, groups, g_stride)
    dev = _build.require("group_fold", torch.int32, ("rows",), rows)
    n = rows.shape[1]
    out = rows.new_empty((groups, n))
    _build.launch("group_fold",
                  _build.function("mask_reduce", entry, _FOLD_ARGTYPES), dev,
                  rows.data_ptr(), None, out.data_ptr(), None, code, k,
                  k_stride * n, groups, g_stride * n, n)
    return out


def group_fold_cuda(rows: torch.Tensor, op: str, k: int, k_stride: int = 1,
                    groups: int = 1, g_stride: int = 0) -> torch.Tensor:
    """:func:`group_fold_plain` in one launch on the card: the members are
    read in place (``rows`` int32, contiguous), one output row a group."""
    return _group_fold_cuda("fold_rows", rows, op, k, k_stride, groups,
                            g_stride)


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
