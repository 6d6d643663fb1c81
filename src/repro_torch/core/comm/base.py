"""Typed communication plans: strategy selection + static wire accounting.

A :class:`CommConfig` names the *strategies* (how the delegate combine is
reduced, which nn wire format ships the frontier); a :class:`CommPlan`
binds those choices to the partition axes of one step (names + static
sizes) and owns the byte formulas every traversal layer uses for its
wire-volume counters. In the emulated backend the partitions are the
stacked leading ``p`` dimension of every tensor, so the plan has one axis
``"p"`` of size ``p``.

Byte convention: **bytes put on the wire per device per collective call**
(payload only; the one-word control reductions of the convergence masks
are excluded as constant and negligible). Summing a state's per-partition
counter rows therefore yields total cluster traffic.

* all-gather + local fold over P devices: each device's payload travels to
  the other P-1, so ``(P-1) * nbytes``.
* ring allreduce (reduce-scatter + all-gather over chunks of
  ``ceil(L / p)`` elements, per axis): ``2 * (p-1) * ceil(L/p) * itemsize``.
* two-level hierarchical: the gather-fold cost of each level,
  ``(P1-1) + (P2-1)`` payloads instead of ``(P1*P2 - 1)``.
* ``auto`` (native fused reductions): modeled with the bandwidth-optimal
  ring formula. Bitwise OR has no native reduction (neither NCCL nor XLA
  offers one), so ``auto`` resolves to the all-gather + fold for ``"or"``.
* all_to_all of a ``[p, ...]`` buffer: the p-1 non-self rows leave the
  device, ``(p-1)/p`` of the buffer bytes.

Two backends bind a plan. The emulated one (:func:`plan_for` with an
int) stacks all ``p`` partitions on one device's leading axis under one
axis ``"p"``; the distributed one (:func:`plan_for` with a
:class:`~repro_torch.core.comm.dist.PartitionMesh`) holds one partition
per process and takes the mesh's axes and sizes, so ``hier`` and the
per-axis rings see the mesh's levels. A plan built directly with several
axes and no mesh stacks ``p = prod(sizes)`` rows in row-major order over
them (the emulated two-axis mesh of the combine's parity tests).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

#: delegate-combine strategies (CommConfig.delegate)
DELEGATE_STRATEGIES = ("auto", "allgather", "ring", "hier")
#: nn wire formats (CommConfig.nn)
NN_FORMATS = ("dense", "sparse", "adaptive", "compressed")


@dataclass(frozen=True)
class CombineSpec:
    """A typed per-lane combine: the monoid one traversal payload reduces
    under. ``op`` names the fold; ``identity`` is the scatter/exchange
    neutral element; ``wire_dtype`` the dtype whose itemsize the byte
    formulas count (lane words travel as int32 bit patterns in the port,
    the same 4 bytes as the reference's uint32)."""

    op: str
    identity: int
    wire_dtype: str

    @property
    def itemsize(self) -> int:
        return 4        # uint32 lane words and int32 payloads alike


COMBINE_SPECS = {
    "or": CombineSpec(op="or", identity=0, wire_dtype="uint32"),
    "min_plus": CombineSpec(op="min", identity=2 ** 30, wire_dtype="int32"),
    "min": CombineSpec(op="min", identity=2 ** 30, wire_dtype="int32"),
}


@dataclass(frozen=True)
class CommConfig:
    """Strategy selection for one traversal layer.

    ``delegate``: ``"auto"`` (native reductions for min/max; bitwise OR
    has none, so it all-gathers and folds), ``"allgather"`` (gather all P
    partials, fold locally), ``"ring"`` (reduce-scatter + all-gather rings
    per partition axis, O(1)-in-P volume) or ``"hier"`` (the gather-fold
    per axis group, ``axes[:hier_split]`` then the rest; on one axis it is
    ``"allgather"``). In the port every K-way OR fold and every gathered
    int32 min runs through the kernels of ``mask_reduce`` and
    ``payload_min_fold``: the prev-less group fold
    (``kernels.ops.group_fold``), and a traversal step's last fold fused
    with its delegate update (``mask_reduce_apply``,
    ``payload_min_fold_apply``).
    ``nn``: ``"dense"`` (one bit per (slot, query), fixed volume),
    ``"sparse"`` (only active slots, as (slot id, lane word) pairs or bare
    slot ids, ``sparse_cap`` per peer; slots beyond it are dropped and
    counted), ``"adaptive"`` (per sweep sparse when every peer's active
    slots fit the cap, dense otherwise, agreed globally) or
    ``"compressed"`` (the adaptive transport, counted as the exact bytes
    of the cheaper of two varint streams of the active slot ids,
    :mod:`.codec`).
    """

    delegate: str = "auto"
    hier_split: int = 1
    nn: str = "dense"
    sparse_cap: int = 0

    def __post_init__(self):
        if self.delegate not in DELEGATE_STRATEGIES:
            raise ValueError(
                f"delegate={self.delegate!r} not in {DELEGATE_STRATEGIES}")
        if self.nn not in NN_FORMATS:
            raise ValueError(f"nn={self.nn!r} not in {NN_FORMATS}")

    def as_dict(self) -> dict:
        return {"delegate": self.delegate, "hier_split": self.hier_split,
                "nn": self.nn, "sparse_cap": self.sparse_cap}


@dataclass(frozen=True)
class CommPlan:
    """A CommConfig bound to concrete partition axes (names + sizes)."""

    cfg: CommConfig
    axes: tuple        # axis names, ("p",) in the emulated backend
    sizes: tuple       # static per-axis sizes; prod == p
    #: the distributed backend's PartitionMesh (None: emulated, all p
    #: partitions stacked on the leading axis)
    mesh: Any = field(default=None, compare=False)

    @property
    def p(self) -> int:
        return math.prod(self.sizes)

    @property
    def rows(self) -> int:
        """Partitions this process holds: its tensors' leading dimension."""
        return self.p if self.mesh is None else 1

    # -- delegate combine ---------------------------------------------------
    def delegate_groups(self) -> tuple:
        """Axis-name groups reduced in sequence (hier: intra, then inter)."""
        if self.cfg.delegate == "hier" and len(self.axes) > 1:
            s = max(1, min(self.cfg.hier_split, len(self.axes) - 1))
            return (self.axes[:s], self.axes[s:])
        return (self.axes,)

    def group_size(self, group: tuple) -> int:
        return math.prod(self.sizes[self.axes.index(a)] for a in group)

    def effective_delegate(self, op: str) -> str:
        """``auto`` resolves per op: native fused collectives exist for
        min/max/sum; bitwise-OR has none, so it gathers and folds."""
        if self.cfg.delegate == "auto":
            return "allgather" if op == "or" else "auto"
        return self.cfg.delegate

    def delegate_bytes(self, n_elems: int, itemsize: int,
                       op: str = "or") -> int:
        """Per-device wire bytes of one delegate combine of ``n_elems``."""
        nbytes = n_elems * itemsize
        strategy = self.effective_delegate(op)
        if strategy in ("ring", "auto"):
            return sum(2 * (s - 1) * -(-n_elems // s) * itemsize
                       for s in self.sizes if s > 1)
        if strategy == "hier":
            return sum((self.group_size(g) - 1) * nbytes
                       for g in self.delegate_groups() if g)
        return (self.p - 1) * nbytes                    # allgather

    # -- nn exchange --------------------------------------------------------
    def sparse_cap_words(self, cap_peer: int) -> int:
        # clamp to cap_peer: more sparse slots than slots exist is meaningless
        return min(max(1, self.cfg.sparse_cap or cap_peer // 4), cap_peer)

    def sparse_cap_bits(self, cap_peer: int) -> int:
        return min(max(1, self.cfg.sparse_cap or cap_peer // 64), cap_peer)

    def nn_dense_words_bytes(self, cap_peer: int, nw: int) -> int:
        return (self.p - 1) * cap_peer * nw * 4

    def nn_sparse_words_bytes(self, cap_sparse: int, nw: int) -> int:
        return (self.p - 1) * cap_sparse * (4 + nw * 4)   # slot id + words

    def nn_dense_payload_bytes(self, cap_peer: int, w: int) -> int:
        """Dense per-lane payload plane: one int32 per (slot, lane)."""
        return (self.p - 1) * cap_peer * w * 4

    def nn_sparse_payload_bytes(self, cap_sparse: int, w: int) -> int:
        """Sparse (slot id, payload row) records: 4 B id + W int32."""
        return (self.p - 1) * cap_sparse * (4 + w * 4)

    def nn_dense_bits_bytes(self, cap_peer: int) -> int:
        return (self.p - 1) * -(-cap_peer // 32) * 4

    def nn_sparse_bits_bytes(self, cap_sparse: int) -> int:
        return (self.p - 1) * cap_sparse * 4              # slot ids only

    # Compressed-format *worst cases* (documentation bounds only):
    # delta stream <= 5 B per active slot, rle stream <= cap + 1 B.
    def nn_compressed_words_max_bytes(self, cap_peer: int, nw: int) -> int:
        return (self.p - 1) * (cap_peer + 1 + cap_peer * nw * 4)

    def nn_compressed_bits_max_bytes(self, cap_peer: int) -> int:
        return (self.p - 1) * (cap_peer + 1)

    def a2a_bytes(self, per_peer_nbytes: int) -> int:
        """Per-device bytes of an all_to_all with ``per_peer_nbytes`` per
        peer row (the p-1 non-self rows leave the device)."""
        return (self.p - 1) * per_peer_nbytes

    def as_dict(self) -> dict:
        return {"axes": list(self.axes), "sizes": list(self.sizes),
                "p": self.p, **self.cfg.as_dict()}


def plan_for(cfg: CommConfig | None, p) -> CommPlan:
    """Bind ``cfg`` to the partition axes: ``p`` an int binds the emulated
    backend's one axis ``"p"`` of that size (the stacked leading
    dimension); a ``{name: size}`` dict binds those emulated axes, rows
    stacked row-major over them (the reference's tuple of axis names);
    ``p`` a :class:`~repro_torch.core.comm.dist.PartitionMesh` binds its
    axes and sizes, one partition per process."""
    cfg = cfg or CommConfig()
    if isinstance(p, int):
        return CommPlan(cfg=cfg, axes=("p",), sizes=(int(p),))
    if isinstance(p, dict):
        return CommPlan(cfg=cfg, axes=tuple(p),
                        sizes=tuple(int(s) for s in p.values()))
    return CommPlan(cfg=cfg, axes=p.axes, sizes=p.sizes, mesh=p)
