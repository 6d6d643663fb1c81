"""Delegate combine (paper Section V-A), pluggable, over either backend.

The paper combines delegate visited status with a bitwise-OR AllReduce of
bitmasks. Neither NCCL nor the emulated backend has an OR reduction, so an
``"or"`` combine always gathers lane words and folds them with the
``mask_reduce`` kernel. The strategies of
:class:`~repro_torch.core.comm.base.CommConfig`:

* ``auto``      -- native reductions for ``"min"`` / ``"max"`` /
                   ``"sum"`` (an ``all_reduce`` when distributed, ``amin`` /
                   ``amax`` / ``sum`` over the stacked rows when emulated);
                   ``"or"`` resolves to ``allgather``;
* ``allgather`` -- gather every partition's partial, K-way fold (the
                   ``mask_reduce`` kernel for OR, ``payload_min_fold`` for
                   the int32 min);
* ``ring``      -- the reference's reduce-scatter + all-gather over
                   ``ceil(L/p)``-element chunks, per axis, with the plain
                   elementwise op as its binop: the hops are rolls of the
                   stacked rows when emulated, ``ppermute`` over the axis
                   subgroup when distributed;
* ``hier``      -- the gather-fold per axis group (``axes[:hier_split]``,
                   then the rest); a group of one member is the identity
                   (nothing gathered, nothing launched).

Every strategy is bit-exact with every other for the integer combines:
the folds are associative and commutative (an int32 sum wraps, as the
reference's does) and the result is replicated. A float ``"sum"`` is
exact where the values' sums are order-free.

Every fold but a step's last is the prev-less group fold
(``kernels.ops.group_fold``: OR, or the int32 min): over the gathered
``[K, n]`` of a mesh, or over the emulated stacked rows ``[p, n]`` in
place, a group's members read by stride and folded into one row a group.
The traversal steps call the ``*_apply`` combines: the same strategies,
with the step's update of its delegate state fused into the last fold's
launch (:func:`delegate_or_apply`: ``mask_reduce_apply`` over the last
group's gathered words, or over the ring's one reduced row;
:func:`delegate_min_apply`: ``payload_min_fold_apply`` over the last
group's gathered candidates under allgather and hier, for the
single-source levels and the payload plane's delegate values).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

from . import dist as D
from .base import CommPlan, plan_for

_BINARY = {"or": torch.bitwise_or, "min": torch.minimum,
           "max": torch.maximum, "sum": torch.add}


def _check_op(op: str) -> None:
    if op not in _BINARY:
        raise ValueError(f"unknown combine op {op!r}; one of {sorted(_BINARY)}")


def _sum_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum along ``dim`` in ``x``'s dtype: integers wrap as the
    reference's int32 sums do (the low bits of the exact sum)."""
    if x.is_floating_point():
        return x.sum(dim)
    return x.sum(dim, dtype=torch.int64).to(x.dtype)


def _fold_rows(x2: torch.Tensor, op: str, k: int, k_stride: int = 1,
               groups: int = 1, g_stride: int = 0) -> torch.Tensor:
    """``out[g] = op`` over ``i < k`` of ``x2[g * g_stride + i * k_stride]``
    -> ``[groups, n]``, the members read in place: the OR and the int32
    min through ``kernels.ops.group_fold``, the rest as a reduction over a
    strided view."""
    if op == "or" or (op == "min" and x2.dtype == torch.int32):
        return ops.group_fold(x2, op, k, k_stride, groups, g_stride)
    n = x2.shape[1]
    v = x2.as_strided((groups, k, n), (g_stride * n, k_stride * n, 1))
    if op == "sum":
        return _sum_rows(v, 1)
    return v.amin(1) if op == "min" else v.amax(1)


# -----------------------------------------------------------------------------
# Emulated rows: p = prod(sizes) stacked rows, row-major over plan.axes


def _axis_view(plan: CommPlan, x2: torch.Tensor) -> torch.Tensor:
    return x2.reshape(plan.sizes + x2.shape[1:])


def _fold_groups(plan: CommPlan, x2: torch.Tensor, groups, op: str):
    """Fold ``x2`` over each axis group of ``groups`` in turn (``hier``'s
    levels lead the axes not yet folded). Emulated, the rows are stacked
    row-major over those axes, so member ``i`` of group ``g`` is row ``i *
    rest + g`` (``rest`` the rows a member of the axes after the group) and
    the rows left are the next group's members; over a mesh, ``[1, n]``. A
    group of one member is the identity."""
    sizes = plan.sizes
    for group in groups:
        k = plan.group_size(group)
        sizes = sizes[len(group):]
        if k == 1:
            continue
        if plan.mesh is not None:
            x2 = _fold_rows(D.all_gather(plan.mesh, x2[0], group), op, k)
        else:
            rest = math.prod(sizes)
            x2 = _fold_rows(x2, op, k, rest, rest, 1)
    return x2


def _emulated_ppermute(plan: CommPlan, blk: torch.Tensor, axis: str):
    """The ring hop over the stacked rows: the member at position ``i``
    along ``axis`` receives position ``i - 1``'s block."""
    dim = plan.axes.index(axis)
    return torch.roll(_axis_view(plan, blk), 1, dim).reshape(blk.shape)


def _positions(plan: CommPlan, axis: str, device) -> torch.Tensor:
    """Each stacked row's position along ``axis`` (``[rows]``)."""
    if plan.mesh is not None:
        return torch.full((1,), plan.mesh.index(axis), dtype=torch.long,
                          device=device)
    i = plan.axes.index(axis)
    stride = 1
    for s in plan.sizes[i + 1:]:
        stride *= s
    return (torch.arange(plan.p, device=device) // stride) % plan.sizes[i]


# -----------------------------------------------------------------------------
# The strategies over ``x2 [rows, n]``


def _ring_1axis(plan: CommPlan, x2: torch.Tensor, axis: str, s: int,
                op: str) -> torch.Tensor:
    """Bandwidth-optimal allreduce over one axis of size ``s`` (the
    reference's ``_ring_allreduce_1axis``): reduce-scatter, then
    all-gather, each ``s - 1`` hops of ``ceil(L/s)``-element chunks."""
    if s <= 1:
        return x2
    binop = _BINARY[op]
    hop = ((lambda b: D.ppermute(plan.mesh, b, axis)) if plan.mesh is not None
           else (lambda b: _emulated_ppermute(plan, b, axis)))
    rows, n = x2.shape
    idx = _positions(plan, axis, x2.device)
    r = torch.arange(rows, device=x2.device)
    c = -(-n // s)
    acc = torch.nn.functional.pad(x2, (0, s * c - n)).reshape(rows, s, c)
    # reduce-scatter: after s-1 hops row i owns the reduced chunk (i+1) % s
    for st in range(1, s):
        blk = hop(acc[r, (idx - st + 1) % s])
        recv = (idx - st) % s
        acc = acc.clone()
        acc[r, recv] = binop(acc[r, recv], blk)
    # all-gather: circulate the owned chunk s-1 hops
    blk = acc[r, (idx + 1) % s]
    out = acc.clone()
    for st in range(1, s):
        blk = hop(blk)
        out[r, (idx - st + 1) % s] = blk
    return out.reshape(rows, s * c)[:, :n]


def _combine(plan: CommPlan, x2: torch.Tensor, op: str) -> torch.Tensor:
    strategy = plan.effective_delegate(op)
    if strategy == "auto":                      # native min / max / sum
        if plan.mesh is not None:
            return D.all_reduce(plan.mesh, x2, op)
        red = {"min": lambda: x2.amin(0), "max": lambda: x2.amax(0),
               "sum": lambda: _sum_rows(x2)}[op]()
        return red[None].expand(x2.shape)
    if strategy == "ring":
        for a, s in zip(plan.axes, plan.sizes):
            x2 = _ring_1axis(plan, x2, a, s, op)
        return x2
    rows = x2.shape[0]                          # allgather / hier
    return _fold_groups(plan, x2, plan.delegate_groups(), op).expand(
        rows, -1)


def delegate_combine(plan: CommPlan, x: torch.Tensor, op: str = "or"):
    """Global elementwise ``op``-allreduce (``"or"``, ``"min"``, ``"max"``
    or ``"sum"``) of ``x [rows, ...]`` with the plan's strategy. Returns
    ``(reduced [rows, ...], wire_bytes)`` -- bytes is a Python int (the
    plan formula for one partition's payload, ``auto`` resolved per op)."""
    _check_op(op)
    rows = x.shape[0]
    n_elems = x[0].numel()
    nbytes = plan.delegate_bytes(n_elems, x.element_size(), op)
    out = _combine(plan, x.reshape(rows, n_elems).contiguous(), op)
    return out.reshape(x.shape), nbytes


def _gathered(plan: CommPlan, x2: torch.Tensor, op: str) -> torch.Tensor:
    """The rows the last fold reads, ``[K, n]``, the same for every
    partition: the ring's reduced row (K = 1), or the last axis group's
    members after the groups before it were folded (emulated: the rows
    :func:`_fold_groups` leaves; over a mesh: gathered, where K > 1)."""
    if plan.effective_delegate(op) == "ring":
        for a, s in zip(plan.axes, plan.sizes):
            x2 = _ring_1axis(plan, x2, a, s, op)
        return x2[:1]
    *first, last = plan.delegate_groups()
    x2 = _fold_groups(plan, x2, first, op)
    if plan.mesh is not None and plan.group_size(last) > 1:
        return D.all_gather(plan.mesh, x2[0], last)
    return x2


def delegate_or_apply(plan: CommPlan, words: torch.Tensor,
                      level: torch.Tensor, it: torch.Tensor,
                      target: torch.Tensor | None = None):
    """The lane-word step's delegate OR combine and update: ``words [rows,
    d, nw]`` int32 candidate lane words are combined with the plan's
    strategy, and the new delegate ``level [rows, d, W]`` plane and lane
    flags are computed in the last fold's launch
    (``kernels.ops.mask_reduce_apply``; ``it [rows]``, ``target [rows, d,
    W]`` bool or None). Returns ``(update, wire_bytes)``: a
    :class:`~repro_torch.kernels.mask_reduce.DelegateApply` and the plan's
    bytes for the ``"or"`` combine of ``d * nw`` words."""
    rows = words.shape[0]
    n_elems = words.numel() // rows
    nbytes = plan.delegate_bytes(n_elems, words.element_size(), "or")
    gathered = _gathered(plan, words.reshape(rows, n_elems).contiguous(),
                         "or")
    return ops.mask_reduce_apply(gathered.contiguous(), level, it,
                                 target), nbytes


class _DelegateSum(torch.autograd.Function):
    """The delegate ``"sum"`` combine over a mesh, differentiable: every
    member's result is the sum of every member's ``x``, so the gradient of
    a member's ``x`` is the sum of every member's incoming gradient -- the
    same combine (JAX transposes ``psum`` to ``psum``)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return delegate_combine(plan, x, "sum")[0]

    @staticmethod
    def backward(ctx, grad):
        return delegate_combine(ctx.plan, grad.contiguous(), "sum")[0], None


def delegate_allreduce_sum(vals: torch.Tensor, p, cfg=None) -> torch.Tensor:
    """Global sum of delegate partials ``vals [rows, ...]`` over the
    emulated axis of ``p`` partitions or a mesh (default strategy: the
    native sum). Autograd differentiates it: emulated through the stacked
    rows' own ops, over a mesh through :class:`_DelegateSum`."""
    plan = plan_for(cfg, p)
    if plan.mesh is not None:
        return _DelegateSum.apply(vals, plan)
    return delegate_combine(plan, vals, "sum")[0]


def delegate_allreduce_or(words: torch.Tensor, p, cfg=None) -> torch.Tensor:
    """Global bitwise-OR of packed lane words ``[rows, ...]`` int32 over
    the emulated axes ``p`` (an int or ``{name: size}``) or a mesh -- the
    paper's visited-bitmask AllReduce with BOR: one :func:`delegate_combine`
    (no OR reduction exists, so every strategy but ``ring`` gathers and
    folds with ``mask_reduce``)."""
    return delegate_combine(plan_for(cfg, p), words, "or")[0]


def delegate_allreduce_min(cand: torch.Tensor, p, cfg=None) -> torch.Tensor:
    """Global min of delegate level candidates ``[rows, ...]`` (the
    bitmask OR's analog on the single-source path; default strategy: the
    native min): one :func:`delegate_combine`."""
    return delegate_combine(plan_for(cfg, p), cand, "min")[0]


def delegate_min_apply(plan: CommPlan, x: torch.Tensor, prev: torch.Tensor):
    """A step's delegate ``"min"`` combine of int32 candidates ``x [rows,
    n]`` folded into ``prev [rows, n]`` (the single-source levels, ``n =
    d``; the payload plane's values, ``n = d * W``):
    returns ``(min(prev, combined) [rows, d], improved [rows] bool,
    wire_bytes)``. Under ``allgather`` and ``hier`` the last fold and the
    update are one launch (``kernels.ops.payload_min_fold_apply``) over the
    last group's gathered candidates (one axis: every partition's; two:
    after one group fold); ``auto`` and ``ring`` combine, then take
    ``minimum`` and ``any``."""
    rows = x.shape[0]
    if plan.effective_delegate("min") in ("allgather", "hier"):
        nbytes = plan.delegate_bytes(x.numel() // rows, x.element_size(),
                                     "min")
        gathered = _gathered(plan, x.reshape(rows, -1).contiguous(), "min")
        out, improved = ops.payload_min_fold_apply(gathered.contiguous(),
                                                   prev)
        return out, improved, nbytes
    reduced, nbytes = delegate_combine(plan, x, "min")
    out = torch.minimum(prev, reduced)
    return out, (out < prev).any(1), nbytes


def lane_fold_reduce(lane_vals: torch.Tensor, mesh=None) -> torch.Tensor:
    """Global per-lane int32 max of stacked ``[rows, k, W]`` rows,
    replicated to every row: ``amax`` over the stacked rows, or one
    ``all_reduce(MAX)`` over ``mesh``. The payload step stacks its rows
    (pending-any, under-bucket-any and the *negated* pending minimum, so
    one max also gives a global min) with the bit flags into this one
    reduction."""
    if mesh is not None:
        return D.all_reduce(mesh, lane_vals, "max")
    return lane_vals.amax(0, keepdim=True).expand(lane_vals.shape)


def lane_any_reduce(lane_flags: torch.Tensor, mesh=None) -> torch.Tensor:
    """Global per-lane OR of ``[rows, ...]`` bool flags, replicated to
    every row: :func:`lane_fold_reduce` of the flags as int32, ``> 0``.
    The convergence word of the serving path: one W-bit word per
    partition, excluded from the wire counters as constant."""
    return lane_fold_reduce(lane_flags.to(torch.int32), mesh) > 0


def any_reduce(flag: torch.Tensor, mesh=None) -> torch.Tensor:
    """Global OR of one bool per partition ``[rows]``, replicated."""
    return lane_any_reduce(flag, mesh)
