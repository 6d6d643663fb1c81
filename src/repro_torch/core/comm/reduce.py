"""Delegate combine (paper Section V-A) over the emulated partition axis.

The paper combines delegate visited status with a bitwise-OR AllReduce of
bitmasks. Neither NCCL nor XLA has an OR reduction, so the combine is
always an all-gather of every partition's lane words followed by a local
K-way OR fold -- the ``mask_reduce`` kernel. In the emulated backend the
partitions are the stacked leading dimension, so the all-gather *is* the
stacked ``[p, ...]`` tensor; the fold runs once and its result is
broadcast back to every partition row (the replicated combine result).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .base import CommPlan


def delegate_combine(plan: CommPlan, x: torch.Tensor, op: str = "or"):
    """Global elementwise ``op``-allreduce of the stacked ``x [p, ...]``
    (int32 lane words). Returns ``(reduced [p, ...], wire_bytes)`` --
    bytes is a Python int (the plan formula for one partition's payload)."""
    if op != "or":
        raise NotImplementedError(
            f"combine op {op!r} is not ported yet: ROADMAP.md queue A, "
            "item A9 (payload plane)")
    p = x.shape[0]
    n_elems = x[0].numel()
    nbytes = plan.delegate_bytes(n_elems, x.element_size(), op)
    partials = x.reshape(p, n_elems).contiguous()
    folded, _ = ops.mask_reduce(
        partials, torch.zeros(n_elems, dtype=x.dtype, device=x.device),
        with_count=False)
    return folded.reshape(x.shape[1:]).expand(x.shape), nbytes


def lane_any_reduce(lane_flags: torch.Tensor) -> torch.Tensor:
    """Global per-lane OR of stacked ``[p, ...]`` bool flags, replicated
    back to every partition row (the emulated elementwise pmax). The
    convergence word of the serving path: one W-bit word per partition,
    excluded from the wire counters as constant."""
    return lane_flags.any(dim=0, keepdim=True).expand(lane_flags.shape)
