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
