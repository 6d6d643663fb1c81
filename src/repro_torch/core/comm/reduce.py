"""Delegate combine (paper Section V-A) over the emulated partition axis.

The paper combines delegate visited status with a bitwise-OR AllReduce of
bitmasks. Neither NCCL nor XLA has an OR reduction, so the ``"or"``
combine is always an all-gather of every partition's lane words followed
by a local K-way OR fold -- the ``mask_reduce`` kernel. The single-source
path also combines int32 delegate levels with ``"min"`` and uint8 visited
masks with ``"max"``: under ``auto`` these are the native reductions; under
``allgather`` the int32 min folds through the ``payload_min_fold`` kernel
(the max over {0, 1} bytes stays a plain ``amax``, as in the reference).

In the emulated backend the partitions are the stacked leading dimension,
so the all-gather *is* the stacked ``[p, ...]`` tensor; the fold runs once
and its result is broadcast back to every partition row (the replicated
combine result).

The traversal steps call the ``*_apply`` combines: the same all-gather and
fold, with the step's update of its delegate state fused into the fold's
launch (:func:`delegate_or_apply` for the lane-word step,
:func:`delegate_min_apply` for the single-source levels).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .base import COMBINE_SPECS, CommPlan


def delegate_combine(plan: CommPlan, x: torch.Tensor, op: str = "or"):
    """Global elementwise ``op``-allreduce (``"or"``, ``"min"`` or
    ``"max"``) of the stacked ``x [p, ...]``. Returns ``(reduced [p, ...],
    wire_bytes)`` -- bytes is a Python int (the plan formula for one
    partition's payload, ``auto`` resolved per op)."""
    if op not in ("or", "min", "max"):
        raise NotImplementedError(
            f"combine op {op!r} is not ported yet: ROADMAP.md queue A, "
            "item A9 (payload plane)")
    p = x.shape[0]
    n_elems = x[0].numel()
    nbytes = plan.delegate_bytes(n_elems, x.element_size(), op)
    partials = x.reshape(p, n_elems).contiguous()
    if op == "or":
        folded, _ = ops.mask_reduce(
            partials, torch.zeros(n_elems, dtype=x.dtype, device=x.device),
            with_count=False)
    elif op == "min" and plan.effective_delegate(op) == "allgather":
        folded, _ = ops.payload_min_fold(
            partials, torch.full((n_elems,), COMBINE_SPECS["min"].identity,
                                 dtype=x.dtype, device=x.device),
            with_count=False)
    else:                                   # native min / max reduction
        folded = partials.amin(0) if op == "min" else partials.amax(0)
    return folded.reshape(x.shape[1:]).expand(x.shape), nbytes


def delegate_or_apply(plan: CommPlan, words: torch.Tensor,
                      level: torch.Tensor, it: torch.Tensor,
                      target: torch.Tensor | None = None):
    """The lane-word step's delegate OR combine and update: ``words [p, d,
    nw]`` int32 candidate lane words of every partition are all-gathered
    and OR-folded, and the new delegate ``level [p, d, W]`` plane and lane
    flags are computed in the same launch (``kernels.ops.mask_reduce_apply``;
    ``it [p]``, ``target [p, d, W]`` bool or None). Returns ``(update,
    wire_bytes)``: a :class:`~repro_torch.kernels.mask_reduce.DelegateApply`
    and the plan's bytes for the ``"or"`` combine of ``d * nw`` words."""
    p = words.shape[0]
    n_elems = words.numel() // p
    nbytes = plan.delegate_bytes(n_elems, words.element_size(), "or")
    gathered = words.reshape(p, n_elems).contiguous()
    return ops.mask_reduce_apply(gathered, level, it, target), nbytes


def delegate_min_apply(plan: CommPlan, x: torch.Tensor, prev: torch.Tensor):
    """The single-source step's delegate ``"min"`` combine of the int32
    candidate levels ``x [p, d]`` folded into ``prev [p, d]``: returns
    ``(min(prev, combined) [p, d], improved [p] bool, wire_bytes)``. Under
    ``allgather`` the fold and the update are one launch
    (``kernels.ops.payload_min_fold_apply``); the native reduction keeps
    its ``amin`` and the step's ``minimum`` and ``any``."""
    p = x.shape[0]
    if plan.effective_delegate("min") == "allgather":
        nbytes = plan.delegate_bytes(x.numel() // p, x.element_size(), "min")
        out, improved = ops.payload_min_fold_apply(
            x.reshape(p, -1).contiguous(), prev)
        return out, improved, nbytes
    reduced, nbytes = delegate_combine(plan, x, "min")
    out = torch.minimum(prev, reduced)
    return out, (out < prev).any(1), nbytes


def lane_any_reduce(lane_flags: torch.Tensor) -> torch.Tensor:
    """Global per-lane OR of stacked ``[p, ...]`` bool flags, replicated
    back to every partition row (the emulated elementwise pmax). The
    convergence word of the serving path: one W-bit word per partition,
    excluded from the wire counters as constant."""
    return lane_flags.any(dim=0, keepdim=True).expand(lane_flags.shape)


def any_reduce(flag: torch.Tensor) -> torch.Tensor:
    """Global OR of one bool per partition ``[p]``, replicated back to
    every partition (the emulated scalar pmax)."""
    return lane_any_reduce(flag)
