"""Generalized degree-separated propagation engine, and its static nn
exchange plan.

The paper's communication model carries 1-bit visited status. Section VI-D
observes the same model extends to algorithms that exchange *values*;
this module is that generalization: one round of

    out[v] = reduce_{(u -> v) in E} w_uv * x[u]

over the four-subgraph partitioned representation, with

* delegate destinations aggregated by one **global sum** (the bitmask
  reduction generalized to ``d x F`` feature values,
  :func:`~repro_torch.core.comm.reduce.delegate_allreduce_sum`), and
* nn-edge remote destinations receiving **pre-aggregated partials**
  through a fixed-capacity all_to_all (the point-to-point exchange, with
  the paper's "uniquification" turned into a static plan: the (owner,
  local-dst) binning of nn edges is graph-static, so the
  permutation/segment structure is precomputed on the host once; plan
  arrays equal the reference package's plan for the same partition).

The propagation functions run over the stacked ``[rows, ...]`` device
view (:func:`repro_torch.core.bfs.device_view`): ``rows`` is ``p`` when
every partition is emulated on one device, 1 on a rank of a ``mesh``
(:class:`~repro_torch.core.comm.dist.PartitionMesh`). Autograd
differentiates them, through the differentiable collectives over a mesh.
This is the substrate the distributed GNN configs train on
(:mod:`repro_torch.train.gnn_dist`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from . import comm
from .bfs import _extended, resolve_device
from .types import CSR, PartitionedGraph, PartitionLayout


@dataclass
class ExchangePlan:
    """Static binning of nn edges by (owner partition, local dst id).

    ``recv_local`` is the receiver-side inverse: for (peer j, slot s) the
    local id that j's slot s refers to on THIS partition -- what makes the
    1-bit static-slot exchange possible (senders ship slot words,
    receivers decode locally).

    The device view (:func:`device_plan`) adds ``flat_seg``: ``seg_ids``
    offset per partition by ``k * (cap_total + 1)`` as one int64 vector, the
    scatter index of the stacked sender-side slot fold.
    """

    perm: Any        # [p, E_nn_max] int32: edge order sorted by (owner, local)
    seg_ids: Any     # [p, E_nn_max] int32: run index of unique (owner, local)
    seg_owner: Any   # [p, cap_total] int32: owner partition per unique dst (p = invalid)
    seg_pos: Any     # [p, cap_total] int32: slot within the owner's bin
    seg_local: Any   # [p, cap_total] int32: local id at the destination
    recv_local: Any = None  # [p, p, cap_peer] int32: (peer, slot) -> my local id
    cap_peer: int = 0   # per-peer slot capacity (multiple of 32)
    cap_total: int = 0  # unique (owner, local) capacity per partition
    flat_seg: Any = None  # [p * E_nn_max] int64 (device view only)
    #: the propagation round's static scatter and gather indices
    #: (:class:`PropagationIndex`), built on first use from the device view
    prop: Any = None


@dataclass
class PropagationIndex:
    """The static indices one :func:`propagate` / :func:`fetch_nn_dst`
    round scatters and gathers with, from a device plan of ``rows``
    partitions (``P`` partitions in all, ``cap = cap_peer``):

    * ``send_ids [rows, P, cap]`` int32: the local id each (peer, slot)
      refers to at the peer, -1 where empty -- the plan's id buffer, which
      the reference builds on every call;
    * ``edge_seg [rows * E_nn]`` int64: each nn edge's unique-destination
      segment in the flattened ``[rows * (cap_total + 1)]`` table, in the
      edges' own order (``seg_ids`` through the inverse of ``perm``; the
      last row of a partition's table is its trash segment);
    * ``slot_flat [rows * cap_total]`` int64: each segment's (peer, slot)
      in the flattened ``[rows * P * cap]`` buffer, ``rows * P * cap`` (a
      trash row) for empty segments.
    """

    send_ids: Any
    edge_seg: Any
    slot_flat: Any


@dataclass
class EdgeWeights:
    """Per-edge weights of the four subgraphs, ``[rows, E_max]`` each."""

    nn: Any
    nd: Any
    dn: Any
    dd: Any


def build_exchange_plan(pg: PartitionedGraph) -> ExchangePlan:
    """Host-side: sort each partition's nn edges by (owner, local dst) and
    record the unique-destination segments and their slots."""
    p = pg.p
    e_max = pg.nn.e_max
    cols = np.asarray(pg.nn.cols)         # local dst id at the owner
    owners = np.asarray(pg.nn_owner)      # owner partition per nn edge
    m = np.asarray(pg.nn.m)

    perms = np.tile(np.arange(e_max, dtype=np.int32), (p, 1))
    seg_ids = np.zeros((p, e_max), dtype=np.int32)
    seg_data = []
    for k in range(p):
        mk = int(m[k])
        owner = owners[k, :mk]
        local = cols[k, :mk]
        order = np.lexsort((local, owner)).astype(np.int32)
        so, sl = owner[order], local[order]
        new_seg = np.ones(mk, dtype=bool)
        if mk > 1:
            new_seg[1:] = (so[1:] != so[:-1]) | (sl[1:] != sl[:-1])
        sid = np.cumsum(new_seg) - 1
        u_owner = so[new_seg]
        u_local = sl[new_seg]
        # slot within owner's bin
        u_pos = np.zeros(u_owner.shape[0], dtype=np.int32)
        for peer in range(p):
            sel = u_owner == peer
            u_pos[sel] = np.arange(sel.sum(), dtype=np.int32)
        perms[k, :mk] = order
        # padding edges get a dedicated trash segment
        seg_ids[k, :mk] = sid
        seg_ids[k, mk:] = (sid[-1] + 1) if mk else 0
        seg_data.append((u_owner, u_pos, u_local))

    cap_peer = 1
    for u_owner, _, _ in seg_data:
        if u_owner.size:
            cap_peer = max(cap_peer, int(np.bincount(u_owner, minlength=p).max()))
    cap_peer = -(-cap_peer // 32) * 32          # word-align for bit packing
    cap_total = max(1, max((u[0].size for u in seg_data), default=1))
    seg_owner = np.full((p, cap_total), p, dtype=np.int32)
    seg_pos = np.zeros((p, cap_total), dtype=np.int32)
    seg_local = np.zeros((p, cap_total), dtype=np.int32)
    recv_local = np.full((p, p, cap_peer), -1, dtype=np.int32)
    for k, (uo, up, ul) in enumerate(seg_data):
        seg_owner[k, : uo.size] = uo
        seg_pos[k, : up.size] = up
        seg_local[k, : ul.size] = ul
        # receiver-side inverse: owner j's table gets (sender k, slot) -> local
        recv_local[uo, k, up] = ul
    return ExchangePlan(
        perm=perms, seg_ids=seg_ids, seg_owner=seg_owner, seg_pos=seg_pos,
        seg_local=seg_local, recv_local=recv_local,
        cap_peer=cap_peer, cap_total=cap_total,
    )


def local_plan(plan: ExchangePlan, part: int) -> ExchangePlan:
    """Partition ``part``'s rows of a host plan alone (leading dimension 1;
    ``cap_peer`` / ``cap_total`` unchanged): what one rank of a sharded run
    holds. Its ``recv_local`` row is the receiver-side table of every
    peer's slots into ``part``."""
    p = int(np.asarray(plan.perm).shape[0])
    if not 0 <= part < p:
        raise ValueError(f"partition {part} not in [0, {p})")
    one = lambda a: np.asarray(a)[part:part + 1]
    return dataclasses.replace(
        plan, perm=one(plan.perm), seg_ids=one(plan.seg_ids),
        seg_owner=one(plan.seg_owner), seg_pos=one(plan.seg_pos),
        seg_local=one(plan.seg_local), recv_local=one(plan.recv_local))


def device_plan(plan: ExchangePlan, device) -> ExchangePlan:
    """The plan's arrays as tensors on ``device`` (reference dtypes), plus
    the flattened slot-fold index ``flat_seg``."""
    put = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    p = int(np.asarray(plan.perm).shape[0])
    seg = put(plan.seg_ids).long()
    seg = seg + (torch.arange(p, device=seg.device) * (plan.cap_total + 1))[:, None]
    return dataclasses.replace(
        plan, perm=put(plan.perm), seg_ids=put(plan.seg_ids),
        seg_owner=put(plan.seg_owner), seg_pos=put(plan.seg_pos),
        seg_local=put(plan.seg_local), recv_local=put(plan.recv_local),
        flat_seg=seg.reshape(-1))


def _propagation_index(plan: ExchangePlan) -> PropagationIndex:
    """``plan.prop``, built on first use (``plan`` from
    :func:`device_plan`)."""
    if plan.prop is not None:
        return plan.prop
    perm, seg_ids = plan.perm.long(), plan.seg_ids.long()
    rows, e = perm.shape
    big_p, cap, ct = plan.recv_local.shape[1], plan.cap_peer, plan.cap_total
    dev = perm.device
    r = torch.arange(rows, device=dev)[:, None]
    owner, pos = plan.seg_owner.long(), plan.seg_pos.long()
    ok = owner < big_p
    send = torch.full((rows * big_p * cap + 1,), -1, dtype=torch.int32,
                      device=dev)
    slot = torch.where(ok, r * (big_p * cap) + owner.clamp(max=big_p - 1) * cap
                       + pos, rows * big_p * cap)
    send[slot.reshape(-1)] = torch.where(ok, plan.seg_local, -1).reshape(-1)
    inv = torch.empty_like(perm).scatter_(
        1, perm, torch.arange(e, device=dev).expand(rows, e).contiguous())
    edge_seg = seg_ids.gather(1, inv).clamp(max=ct) + r * (ct + 1)
    plan.prop = PropagationIndex(
        send_ids=send[:-1].reshape(rows, big_p, cap),
        edge_seg=edge_seg.reshape(-1), slot_flat=slot.reshape(-1))
    return plan.prop


def build_edge_weights(pg: PartitionedGraph, degrees: np.ndarray,
                       mode: str = "sym") -> EdgeWeights:
    """Per-edge weights: 'sym' = 1/sqrt(d_u d_v) (GCN), 'mean' = 1/d_v,
    'sum' = 1. Computed host-side from global degrees (numpy ``[p,
    E_max]`` float32 each; padding edges weigh 1)."""
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    deg = np.maximum(degrees.astype(np.float64), 1.0)
    dvids = np.asarray(pg.delegate_vids).reshape(-1)[: max(pg.d, 1)]
    nn_owner = np.asarray(pg.nn_owner)

    def w(csr: CSR, src_kind: str, dst_kind: str) -> np.ndarray:
        rowids = np.asarray(csr.rowids)
        cols = np.asarray(csr.cols)
        p, e = rowids.shape
        out = np.ones((p, e), dtype=np.float32)
        if mode == "sum":
            return out
        for k in range(p):
            mk = int(np.asarray(csr.m)[k])
            r, c = rowids[k, :mk], cols[k, :mk]
            if src_kind == "n":
                src_v = layout.global_of(np.full(mk, k), r)
            else:
                src_v = dvids[np.minimum(r, len(dvids) - 1)]
            if dst_kind == "g":
                dst_v = layout.global_of(nn_owner[k, :mk], c)
            elif dst_kind == "n":
                dst_v = layout.global_of(np.full(mk, k), c)
            else:
                dst_v = dvids[np.minimum(c, len(dvids) - 1)]
            if mode == "sym":
                out[k, :mk] = (1.0 / np.sqrt(deg[src_v] * deg[dst_v])
                               ).astype(np.float32)
            elif mode == "mean":
                out[k, :mk] = (1.0 / deg[dst_v]).astype(np.float32)
            else:
                raise ValueError(mode)
        return out

    return EdgeWeights(
        nn=w(pg.nn, "n", "g"), nd=w(pg.nd, "n", "d"),
        dn=w(pg.dn, "d", "n"), dd=w(pg.dd, "d", "d"),
    )


def device_weights(w: EdgeWeights, device, part: int | None = None
                   ) -> EdgeWeights:
    """Host edge weights as tensors on ``device``; ``part`` keeps only that
    partition's row (a rank's :func:`~repro_torch.core.bfs.local_partition`)."""
    device = resolve_device(device)
    put = lambda a: torch.as_tensor(
        np.asarray(a) if part is None else np.asarray(a)[part:part + 1]
    ).to(device)
    return EdgeWeights(nn=put(w.nn), nd=put(w.nd), dn=put(w.dn), dd=put(w.dd))


def _gather_messages(csr: CSR, x_src: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Per-edge messages ``[rows, E, F]``: ``x_src[row(e)] * w_e``,
    padding rows -> 0."""
    return _gather_rows(csr, x_src) * w[..., None]


def _segment_to_cols(csr: CSR, msgs: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Scatter-add per-edge ``msgs [rows, E, F]`` onto their destination
    columns ``[rows, n_dst, F]`` (``n_dst`` is the view's destination
    count)."""
    rows, f = msgs.shape[0], msgs.shape[-1]
    return msgs.new_zeros((rows * n_dst, f)).index_add(
        0, csr.flat_cols, msgs.reshape(-1, f)).reshape(rows, n_dst, f)


def _exchange_partials(pgv: PartitionedGraph, plan: ExchangePlan,
                       msgs_nn: torch.Tensor, out_n: torch.Tensor,
                       cplan) -> torch.Tensor:
    """The nn half of a round: pre-aggregate ``msgs_nn [rows, E, F]`` by
    (owner, local dst) segment, ship each segment's sum in its plan slot
    (payload all_to_all) and scatter-add what arrives into ``out_n
    [rows, nl, F]``."""
    ix = _propagation_index(plan)
    rows, nl, f = out_n.shape
    big_p, cap, ct = ix.send_ids.shape[1], plan.cap_peer, plan.cap_total
    partials = msgs_nn.new_zeros((rows * (ct + 1), f)).index_add(
        0, ix.edge_seg, msgs_nn.reshape(-1, f)).reshape(rows, ct + 1, f)
    buf = msgs_nn.new_zeros((rows * big_p * cap + 1, f)).index_add(
        0, ix.slot_flat, partials[:, :ct].reshape(-1, f))
    r_ids, r_vals = comm.exchange_payload(
        ix.send_ids, buf[:-1].reshape(rows, big_p, cap, f), cplan)
    r = torch.arange(rows, device=r_ids.device)[:, None, None]
    dst = torch.where(r_ids >= 0, r * nl + r_ids.long(), rows * nl)
    ext = torch.cat([out_n.reshape(rows * nl, f), out_n.new_zeros((1, f))])
    return ext.index_add(0, dst.reshape(-1), r_vals.reshape(-1, f)
                         )[:-1].reshape(rows, nl, f)


def _cplan(pgv: PartitionedGraph, mesh, comm_cfg):
    return comm.plan_for(comm_cfg, mesh if mesh is not None else pgv.p)


def propagate(pgv: PartitionedGraph, plan: ExchangePlan, weights: EdgeWeights,
              x_n: torch.Tensor, x_d: torch.Tensor, comm_cfg=None, mesh=None):
    """One aggregation round over ``x_n [rows, n_local, F]`` (local normal
    features) and ``x_d [rows, d, F]`` (replicated delegate features):
    returns ``(out_n [rows, n_local, F], out_d [rows, d, F])``.

    ``out_d`` is identical on all partitions (a global sum -- the native
    sum by default, or the allgather / ring / hierarchical combine named by
    ``comm_cfg.delegate``), mirroring the paper's replicated delegate
    state. :func:`payload_round_bytes` gives the static wire model of one
    round under the same config. ``plan`` and ``weights`` are device views
    (:func:`device_plan`, :func:`device_weights`) of the partitions
    ``pgv`` holds."""
    cplan = _cplan(pgv, mesh, comm_cfg)
    nl, d = x_n.shape[1], x_d.shape[1]
    # delegate destinations: nd + dd partials -> global reduction
    part_d = _segment_to_cols(pgv.nd, _gather_messages(pgv.nd, x_n, weights.nd), d)
    part_d = part_d + _segment_to_cols(
        pgv.dd, _gather_messages(pgv.dd, x_d, weights.dd), d)
    out_d = comm.delegate_allreduce_sum(
        part_d, pgv.p if mesh is None else mesh, comm_cfg)
    # normal destinations: dn is local by construction
    out_n = _segment_to_cols(pgv.dn, _gather_messages(pgv.dn, x_d, weights.dn), nl)
    # nn: static-plan pre-aggregation, payload all_to_all, scatter-add
    out_n = _exchange_partials(
        pgv, plan, _gather_messages(pgv.nn, x_n, weights.nn), out_n, cplan)
    return out_n, out_d


def fetch_nn_dst(pgv: PartitionedGraph, plan: ExchangePlan,
                 x_n: torch.Tensor, mesh=None) -> torch.Tensor:
    """Reverse exchange: per-nn-edge *destination* features.

    Edge-MLP models (MeshGraphNet/GraphCast) need both endpoint features per
    edge. By Algorithm 1's placement every non-nn edge has both endpoints
    locally available (delegates are replicated); only nn edges have a
    remote destination. The static exchange plan is symmetric, so the owner
    of each unique remote destination ships its feature vector back along
    the same slots: an all_to_all of the requested ids (the plan's static
    id buffer) and one payload all_to_all back, no new plan.

    Returns ``[rows, E_nn_max, F]`` dst features aligned with ``pgv.nn``'s
    edge order (padding edges: zeros)."""
    ix = _propagation_index(plan)
    cplan = _cplan(pgv, mesh, None)
    rows, nl, f = x_n.shape
    big_p, cap, ct = ix.send_ids.shape[1], plan.cap_peer, plan.cap_total
    # 1) owners learn which of their locals each peer needs
    req = comm.exchange_normal(ix.send_ids, cplan)
    # 2) owners gather and ship back
    r = torch.arange(rows, device=req.device)[:, None, None]
    src = torch.where(req >= 0, r * nl + req.long(), rows * nl)
    ext = torch.cat([x_n.reshape(rows * nl, f), x_n.new_zeros((1, f))])
    reply = ext.index_select(0, src.reshape(-1)).reshape(rows, big_p, cap, f)
    got = comm.exchange_values(reply, cplan)
    # 3) per unique-dst segment, then expand to edges (own edge order)
    got = torch.cat([got.reshape(rows * big_p * cap, f), got.new_zeros((1, f))])
    seg = got.index_select(0, ix.slot_flat).reshape(rows, ct, f)
    seg = torch.cat([seg, seg.new_zeros((rows, 1, f))], 1).reshape(-1, f)
    return seg.index_select(0, ix.edge_seg).reshape(rows, -1, f)


def aggregate_messages(pgv: PartitionedGraph, plan: ExchangePlan, msgs: dict,
                       comm_cfg=None, mesh=None):
    """Two-class aggregation of arbitrary per-edge messages ``msgs``
    (``{"nn", "nd", "dn", "dd"}: [rows, E_max, F]``; the BFS comm model
    generalized): delegate destinations globally summed (strategy per
    ``comm_cfg``), nn remote destinations pre-aggregated and
    all_to_all'd. Returns ``(out_n [rows, n_local, F], out_d [rows, d,
    F])``."""
    cplan = _cplan(pgv, mesh, comm_cfg)
    nl, d = pgv.n_local, max(pgv.d, 1)
    part_d = (_segment_to_cols(pgv.nd, msgs["nd"], d)
              + _segment_to_cols(pgv.dd, msgs["dd"], d))
    out_d = comm.delegate_allreduce_sum(
        part_d, pgv.p if mesh is None else mesh, comm_cfg)
    out_n = _segment_to_cols(pgv.dn, msgs["dn"], nl)
    return _exchange_partials(pgv, plan, msgs["nn"], out_n, cplan), out_d


def payload_round_bytes(plan: ExchangePlan, *, axis_sizes, d: int, feat: int,
                        itemsize: int = 4, comm_cfg=None) -> dict:
    """Static per-device wire model of one :func:`propagate` round.

    Payload shapes are graph-static, so the engine's wire volume is a
    host-side formula: the delegate sum of ``[d, feat]`` under the
    configured combine strategy plus the nn payload all_to_all of ``(id +
    feat * itemsize)`` bytes per plan slot. ``axis_sizes`` are the
    partition-axis sizes (a mesh's ``sizes``), matching the byte
    convention of :mod:`repro_torch.core.comm.base`."""
    axis_sizes = tuple(int(s) for s in axis_sizes)
    cplan = comm.CommPlan(cfg=comm_cfg or comm.CommConfig(),
                          axes=tuple(f"ax{i}" for i in range(len(axis_sizes))),
                          sizes=axis_sizes)
    return {
        "delegate_bytes": cplan.delegate_bytes(d * feat, itemsize, "sum"),
        "nn_payload_bytes": cplan.a2a_bytes(
            plan.cap_peer * (4 + feat * itemsize)),
        "p": cplan.p,
    }


def _gather_rows(csr: CSR, x_src: torch.Tensor) -> torch.Tensor:
    """Per-edge source rows ``[rows, E, F]`` (padding edges: zeros). Every
    gather of the engine is an ``index_select``, whose backward is one
    ``index_add`` (advanced indexing's backward sorts the index first:
    about half of a GCN step's device time at scale 20)."""
    rows, e = csr.rowids.shape
    return _extended(x_src).index_select(0, csr.flat_rows).reshape(rows, e, -1)


def _gather_cols(csr: CSR, x_dst: torch.Tensor) -> torch.Tensor:
    """Per-edge destination rows ``[rows, E, F]``."""
    rows, e = csr.cols.shape
    return x_dst.reshape(-1, x_dst.shape[-1]).index_select(
        0, csr.flat_cols).reshape(rows, e, -1)


def edge_endpoints(pgv: PartitionedGraph, plan: ExchangePlan,
                   x_n: torch.Tensor, x_d: torch.Tensor, mesh=None,
                   dst: tuple | None = None) -> dict:
    """Per-subgraph (src_feats, dst_feats) pairs, each ``[rows, E_max,
    F]``. Only the nn destination requires communication
    (:func:`fetch_nn_dst`). ``dst = (dst_n, dst_d)`` gathers the
    destinations' features from those instead of ``x_n`` / ``x_d`` (a
    model whose messages read less of the destination fetches less)."""
    dst_n, dst_d = (x_n, x_d) if dst is None else dst
    return {
        "nn": (_gather_rows(pgv.nn, x_n), fetch_nn_dst(pgv, plan, dst_n, mesh)),
        "nd": (_gather_rows(pgv.nd, x_n), _gather_cols(pgv.nd, dst_d)),
        "dn": (_gather_rows(pgv.dn, x_d), _gather_cols(pgv.dn, dst_n)),
        "dd": (_gather_rows(pgv.dd, x_d), _gather_cols(pgv.dd, dst_d)),
    }


def edge_valid_masks(pgv: PartitionedGraph) -> dict:
    """``[rows, E_max]`` validity per subgraph (padding edges excluded)."""
    out = {}
    for kind in ("nn", "nd", "dn", "dd"):
        csr = pgv.subgraph(kind)
        out[kind] = csr.rowids < csr.n_rows
    return out


def scatter_features(pg: PartitionedGraph, x_global: np.ndarray):
    """Host-side: split a global [n, F] feature matrix into
    (x_n [p, n_local, F], x_d [d, F]) following the layout."""
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    vids = np.arange(pg.n, dtype=np.int64)
    x_n = np.zeros((pg.p, pg.n_local, x_global.shape[1]), x_global.dtype)
    x_n[layout.part_of(vids), layout.local_of(vids)] = x_global
    dvids = np.asarray(pg.delegate_vids).reshape(-1)[: max(pg.d, 1)]
    x_d = (x_global[dvids] if pg.d
           else np.zeros((1, x_global.shape[1]), x_global.dtype))
    return x_n, x_d


def gather_features(pg: PartitionedGraph, out_n: np.ndarray,
                    out_d: np.ndarray) -> np.ndarray:
    """Host-side inverse of scatter_features (delegate rows win)."""
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    vids = np.arange(pg.n, dtype=np.int64)
    out = np.asarray(out_n)[layout.part_of(vids), layout.local_of(vids)].copy()
    if pg.d:
        dvids = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
        out[dvids] = np.asarray(out_d)[: pg.d]
    return out
