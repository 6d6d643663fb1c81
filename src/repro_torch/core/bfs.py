"""Distributed BFS / direction-optimized BFS on the four-subgraph
representation (paper Sections IV and V): the single-source traversal.

One superstep processes the four subgraphs:

  ``nn``  forward push only (paper: DO is never used for nn), producing
          remote normal-vertex updates -> binned all_to_all exchange (or
          the static slot bitmask exchange);
  ``nd``  push from the normal frontier into delegate candidates, or pull
          (via the dn subgraph) for unvisited delegates  -> delegate reduce;
  ``dd``  push/pull among delegates                       -> delegate reduce;
  ``dn``  push from the delegate frontier into local normals, or pull (via
          the nd subgraph) for unvisited normals          -> local only.

The per-subgraph direction is chosen by the paper's workload estimates:
FV = sum of frontier out-degrees, BV ~= |U| (q + s) / q, with two switch
factors per DO subgraph, in float32 with the reference's expression order.

Every function works on a *stacked* partition axis: tensors carry a
leading dimension of the partitions this process holds -- all ``p`` in
the emulated backend (the reference's ``vmap(axis_name="p")``), this
rank's one under a ``mesh`` (the reference's ``shard_map``,
:func:`make_sharded_bfs`) -- and the collectives run over it or over the
process group. Pushes are
edge-parallel gathers and scatter-ORs; the three pulls of a sweep are
one launch of the fused chunked bit-pull kernel
(``kernels.ops.ell_pull_bits_sweep``) for every partition, so no host
round trip happens per chunk. The host driver
:func:`run_bfs_emulated` reads one scalar per sweep for its loop
condition. The state has the reference's leaves, shapes and dtypes, so
states compare leaf by leaf after every sweep.

This module also holds the device placement, the direction decision and
the scatter / slot-binning helpers the batched msBFS path shares (they
take an optional trailing lane axis).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch

from . import comm
from .comm import pack_lanes
from .types import CSR, INF_LEVEL, PartitionedGraph, PartitionLayout
from repro_torch.kernels import ops
from repro_torch.kernels.pull_schedule import build_schedule

# The delegate level reduction is the "min" combine: its identity is
# INF_LEVEL, so unvisited candidates ride the reduction as the identity.
_MIN_SPEC = comm.COMBINE_SPECS["min"]
assert int(_MIN_SPEC.identity) == int(INF_LEVEL)

# -----------------------------------------------------------------------------
# Config / state


@dataclass(frozen=True)
class BFSConfig:
    max_iters: int = 64
    cap_nn: int = 0          # per-peer a2a capacity; 0 -> E_nn_max (safe but
                             # p-times oversized); <0 -> |cap_nn| * E_nn_max / p
    enable_do: bool = True
    delegate_u8: bool = False  # communicate the delegate update as a uint8
                               # OR-mask (1 B/delegate) instead of int32
                               # levels (4 B) -- levels derived locally
    static_exchange: bool = False  # nn exchange as 1-bit masks over the
                                   # static (owner, local) slot layout of an
                                   # ExchangePlan: no runtime sort
    uniquify: bool = False
    pull_chunk: int = 32
    # direction-switch factors (paper Section VI-B): factor0 switches
    # forward->backward, factor1 switches back. Order: (dd, dn, nd).
    factor0: tuple = (0.5, 0.05, 1e-7)
    factor1: tuple = (1e-3, 1e-4, 1e-9)
    comm: comm.CommConfig = comm.CommConfig()
    # Out-of-core sweep mode: > 0 runs the dd/nd/dn pushes and the static
    # exchange's slot fold over blocks of this many edge slots of every
    # partition (a Python loop, one scatter per block into one output), so
    # the per-edge temporaries are O(edge_chunk) instead of O(E_max).
    # Scatter-OR and the counts are order-free, so every leaf equals the
    # monolithic sweep's. The pulls read the CSR in place and need no
    # block; the legacy binned nn path stays monolithic, as in the
    # reference. 0 = monolithic.
    edge_chunk: int = 0
    # True carries the per-sweep telemetry leaves tm_* ([p, max_iters]
    # int32: frontier popcounts and the direction bitmask); False keeps
    # them zero-width. Answers and counters are the same either way.
    telemetry: bool = False


@dataclass
class BFSState:
    """Single-source traversal state (leaves, shapes and dtypes as in the
    reference package). The telemetry leaves are zero-width unless
    ``cfg.telemetry``, as the reference keeps them."""

    level_n: Any      # [p, n_local] int32
    level_d: Any      # [p, d] int32 (replicated content)
    backward: Any     # [p, 3] bool -- current direction per (dd, dn, nd)
    it: Any           # [p] int32
    done: Any         # [p] bool
    # per-iteration statistics [p, max_iters] int32:
    work_fwd: Any     # edges examined by pushes
    work_bwd: Any     # parent checks by pulls
    nn_sent: Any      # normal vertices sent (post-binning)
    nn_overflow: Any  # dropped by capacity (must be 0 for a valid run)
    delegate_round: Any  # 1 if the delegate reduction carried updates
    wire_delegate: Any   # per-device bytes per sweep (comm/base.py)
    wire_nn: Any
    nn_sparse: Any    # 1 if the nn exchange shipped the sparse format
                      # (nn="compressed": 1 if the delta-id stream won)
    # per-sweep telemetry ([p, max_iters] int32 with cfg.telemetry, [p, 0]
    # otherwise); frontier counts accumulate, the direction bits are set:
    tm_frontier_n: Any  # per-partition normal-frontier popcount
    tm_frontier_d: Any  # delegate-frontier popcount (replicated content)
    tm_backward: Any    # bits 1, 2, 4 set where dd, dn, nd pulled


STATE_LEAVES = tuple(f.name for f in fields(BFSState))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises -- there is no silent CPU fallback (pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def _csr_view(csr: CSR, n_dst: int, device, pulled: bool = True) -> CSR:
    """``csr`` on ``device`` with its sweep indices; a subgraph that is
    ``pulled`` gets its row schedule on a card (the plain pulls of the CPU
    need none)."""
    put = lambda a: torch.as_tensor(np.asarray(a)).to(device)
    rowids, cols, offsets = put(csr.rowids), put(csr.cols), put(csr.offsets)
    p = rowids.shape[0]
    ks = torch.arange(p, device=rowids.device)[:, None]
    return CSR(
        offsets=offsets, cols=cols, rowids=rowids, m=put(csr.m),
        eidx=None, n_rows=csr.n_rows, e_max=csr.e_max,
        flat_rows=(rowids.long() + ks * (csr.n_rows + 1)).reshape(-1),
        flat_cols=(cols.long() + ks * n_dst).reshape(-1),
        sched=(build_schedule(offsets)
               if pulled and offsets.device.type == "cuda" else None))


def local_partition(pg: PartitionedGraph, part: int) -> PartitionedGraph:
    """Partition ``part`` of a host graph alone: every per-partition leaf
    keeps only its row ``part`` (leading dimension 1, padded widths and
    ``p`` unchanged), the replicated delegate ids stay whole -- what one
    rank of a sharded run holds."""
    if not 0 <= part < pg.p:
        raise ValueError(f"partition {part} not in [0, {pg.p})")
    one = lambda a: None if a is None else np.asarray(a)[part:part + 1]
    csr = lambda c: dataclasses.replace(
        c, offsets=one(c.offsets), cols=one(c.cols), rowids=one(c.rowids),
        m=one(c.m), eidx=one(c.eidx))
    return dataclasses.replace(
        pg, nn=csr(pg.nn), nd=csr(pg.nd), dn=csr(pg.dn), dd=csr(pg.dd),
        nn_owner=one(pg.nn_owner), normal_valid=one(pg.normal_valid),
        nd_src_mask=one(pg.nd_src_mask), dn_src_mask=one(pg.dn_src_mask),
        dd_src_mask=one(pg.dd_src_mask))


def device_view(pg: PartitionedGraph, device="cuda") -> PartitionedGraph:
    """All data leaves as tensors on ``device``, with a leading partition
    axis (delegate ids tiled to ``[rows, d]`` int32; ``rows`` is ``p``, or
    1 for a :func:`local_partition`); the host-only edge index (``eidx``)
    is stripped. Each CSR also carries its flattened sweep indices; on a
    card, the three pulled subgraphs (dd, dn, nd) also carry their pull
    schedule, over the partitions the view holds (see
    :class:`~repro_torch.core.types.CSR`)."""
    dev = resolve_device(device)
    put = lambda a: torch.as_tensor(np.asarray(a)).to(dev)
    dslots = max(pg.d, 1)
    dv = np.repeat(np.asarray(pg.delegate_vids).astype(np.int32)[None],
                   np.asarray(pg.normal_valid).shape[0], axis=0)
    return dataclasses.replace(
        pg,
        nn=_csr_view(pg.nn, pg.n_local, dev, pulled=False),
        nd=_csr_view(pg.nd, dslots, dev),
        dn=_csr_view(pg.dn, pg.n_local, dev),
        dd=_csr_view(pg.dd, dslots, dev),
        nn_owner=put(pg.nn_owner), delegate_vids=put(dv),
        normal_valid=put(pg.normal_valid), nd_src_mask=put(pg.nd_src_mask),
        dn_src_mask=put(pg.dn_src_mask), dd_src_mask=put(pg.dd_src_mask))


def init_state(pg: PartitionedGraph, source: int, cfg: BFSConfig,
               device="cuda", mesh=None) -> BFSState:
    """Seed one source vertex (built on the host, then placed on
    ``device``); with ``mesh``, this rank's partition only (leading
    dimension 1)."""
    dev = resolve_device(device)
    if not 0 <= int(source) < pg.n:
        raise ValueError(f"source id {source} out of range [0, {pg.n})")
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    p, nl = (pg.p, pg.n_local) if mesh is None else (1, pg.n_local)
    part0 = 0 if mesh is None else mesh.rank
    d = max(pg.d, 1)
    level_n = np.full((p, nl), INF_LEVEL, dtype=np.int32)
    level_d = np.full((p, d), INF_LEVEL, dtype=np.int32)
    dvids = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
    pos = int(np.searchsorted(dvids, source))
    if pos < pg.d and dvids[pos] == source:
        level_d[:, pos] = 0
    elif 0 <= int(layout.part_of(np.int64(source))) - part0 < p:
        level_n[int(layout.part_of(np.int64(source))) - part0,
                int(layout.local_of(np.int64(source)))] = 0
    i32 = lambda *s: np.zeros(s, dtype=np.int32)
    mi = cfg.max_iters
    tmi = mi if cfg.telemetry else 0
    host = dict(
        level_n=level_n, level_d=level_d,
        backward=np.zeros((p, 3), dtype=bool), it=i32(p),
        done=np.zeros((p,), dtype=bool),
        work_fwd=i32(p, mi), work_bwd=i32(p, mi), nn_sent=i32(p, mi),
        nn_overflow=i32(p, mi), delegate_round=i32(p, mi),
        wire_delegate=i32(p, mi), wire_nn=i32(p, mi), nn_sparse=i32(p, mi),
        tm_frontier_n=i32(p, tmi), tm_frontier_d=i32(p, tmi),
        tm_backward=i32(p, tmi))
    return BFSState(**{k: torch.from_numpy(v).to(dev)
                       for k, v in host.items()})


# -----------------------------------------------------------------------------
# Traversal primitives (stacked over the partition axis)


def _row_degrees(csr: CSR) -> torch.Tensor:
    """Per-row out-degree ``[p, n_rows]`` int32 of a stacked device CSR."""
    return csr.offsets[..., 1:] - csr.offsets[..., :-1]


def _extended(rows: torch.Tensor) -> torch.Tensor:
    """``[p, R, ...]`` rows plus one all-zero row per partition (what
    padding edges, rowid = R, gather), flattened to ``[p * (R + 1),
    ...]``: the table ``CSR.flat_rows`` indexes."""
    p, lanes = rows.shape[0], rows.shape[2:]
    return torch.cat([rows, rows.new_zeros((p, 1) + lanes)],
                     1).reshape((-1,) + lanes)


def _edge_active(csr: CSR, frontier_rows: torch.Tensor) -> torch.Tensor:
    """Edge-parallel frontier gather: ``[p, E]`` active flag per (padded)
    edge slot (padding edges gather an all-False row)."""
    p = frontier_rows.shape[0]
    return _extended(frontier_rows)[csr.flat_rows].reshape(p, -1)


def _scatter_or(n_out: int, index: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """Scatter-OR of bool rows ``vals [E, ...]`` onto ``[n_out, ...]`` (an
    int32 scatter-add then ``> 0``: OR is order-free, so this is
    deterministic)."""
    out = torch.zeros((n_out,) + vals.shape[1:], dtype=torch.int32,
                      device=vals.device)
    out.index_add_(0, index, vals.to(torch.int32))
    return out > 0


def edge_blocks(e_max: int, edge_chunk: int) -> list:
    """The edge slot ranges ``[a, b)`` a sweep visits, one scatter each:
    one range of all ``e_max`` slots when ``edge_chunk`` is 0 or covers
    them (monolithic), else blocks of ``edge_chunk`` slots, the last one
    short (the reference pads it with edges that scatter nothing)."""
    if edge_chunk <= 0 or edge_chunk >= e_max:
        return [(0, e_max)]
    return [(a, min(a + edge_chunk, e_max))
            for a in range(0, e_max, edge_chunk)]


def _block_index(flat: torch.Tensor, p: int, a: int, b: int) -> torch.Tensor:
    """Slots ``[a, b)`` of every partition of a flat ``[p * E]`` index, as
    one flat index (no copy for the monolithic range)."""
    return flat.view(p, -1)[:, a:b].reshape(-1)


def _push_fused(csr: CSR, frontier_rows: torch.Tensor, n_dst: int,
                edge_chunk: int = 0) -> torch.Tensor:
    """Push: gather + scatter-OR of the frontier along every edge ->
    ``[p, n_dst]`` bool, over :func:`edge_blocks` of ``edge_chunk``."""
    p = frontier_rows.shape[0]
    ext = _extended(frontier_rows)
    out = torch.zeros(p * n_dst, dtype=torch.int32,
                      device=frontier_rows.device)
    for a, b in edge_blocks(csr.e_max, edge_chunk):
        out.index_add_(0, _block_index(csr.flat_cols, p, a, b),
                       ext[_block_index(csr.flat_rows, p, a, b)].to(
                           torch.int32))
    return (out > 0).reshape(p, n_dst)


def _nn_slots_bits(csr: CSR, frontier_rows: torch.Tensor, plan,
                   edge_chunk: int = 0):
    """Sender-side unique-slot occupancy for the static-exchange nn path:
    ``(sa [p, cap_total] bool, act_sum [p])`` with ``act_sum`` the active
    nn edge count (``plan.perm`` is a permutation, so the permuted sum is
    identical), over :func:`edge_blocks` of the permuted edge order."""
    p = frontier_rows.shape[0]
    ext = _extended(frontier_rows)
    rows = csr.flat_rows.view(p, -1)
    sa = torch.zeros(p * (plan.cap_total + 1), dtype=torch.int32,
                     device=ext.device)
    act_sum = 0
    for a, b in edge_blocks(csr.e_max, edge_chunk):
        act = ext[rows.gather(1, plan.perm[:, a:b].long()).reshape(-1)]
        sa.index_add_(0, _block_index(plan.flat_seg, p, a, b),
                      act.to(torch.int32))
        act_sum = act_sum + act.view(p, -1).sum(1, dtype=torch.int32)
        del act             # before the next block's is made
    return (sa.view(p, -1)[:, : plan.cap_total] > 0), act_sum


def _dense_slots(plan, sa: torch.Tensor, p: int) -> torch.Tensor:
    """Each sender's unique slots ``sa [rows, cap_total, ...]`` binned by
    owner peer (of ``p``): ``[rows, p, cap_peer, ...]`` bool (invalid
    slots drop out)."""
    rows, lanes = sa.shape[0], sa.shape[2:]
    owner = plan.seg_owner.long()
    ok = (owner < p).reshape(owner.shape + (1,) * len(lanes))
    idx = (torch.arange(rows, device=sa.device)[:, None] * p
           + owner.clamp(max=p - 1)) * plan.cap_peer + plan.seg_pos.long()
    dense = _scatter_or(rows * p * plan.cap_peer, idx.reshape(-1),
                        (sa & ok).reshape((-1,) + lanes))
    return dense.reshape((rows, p, plan.cap_peer) + lanes)


def _pull_sweep(pulls, chunk: int):
    """The bottom-up pulls of a sweep, one kernel launch for all three
    subgraphs and every partition: rows scan their parent lists chunk by
    chunk and drop out after the first chunk holding a frontier parent
    (paper Section IV-B). ``pulls`` holds ``(csr, rows_active [p, R] bool,
    col_mask [p, ceil(N/32)])``, the column domain's frontier bit-packed.
    Returns ``(found [p, R] bool, work [p] int32)`` per pull."""
    out = ops.ell_pull_bits_sweep(
        [(csr, mask, act.to(torch.int32)) for csr, act, mask in pulls], chunk)
    return [(found > 0, work.sum(1, dtype=torch.int32))
            for found, work in out]


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Popcount of ``mask`` over axis 1 (rows) -> int32."""
    return mask.sum(1, dtype=torch.int32)


def _degree_sum(mask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Frontier out-degree sum (the FV estimate) over axis 1 -> int32."""
    return (mask.to(torch.int32) * deg).sum(1, dtype=torch.int32)


def _bv_estimate(q, s, u):
    """BV ~= u (q + s) / max(q, 1) in float32, inf where q == 0."""
    qf = q.to(torch.float32)
    sf = s.to(torch.float32)
    return torch.where(q > 0, u.to(torch.float32) * (qf + sf) / qf.clamp(min=1.0),
                       torch.inf)


def _decide_direction(backward, fv, bv, f0, f1):
    """Paper Section IV-B: forward if FV <= factor0*BV else backward, with
    hysteresis through factor1 on the way back. float32 throughout, with
    the reference's expression order (``f0 * bv`` multiplies a float32
    tensor by a Python float), so no decision can flip between packages."""
    go_back = (~backward) & (fv.to(torch.float32) > f0 * bv)
    go_fwd = backward & (fv.to(torch.float32) < f1 * bv)
    return (backward | go_back) & ~go_fwd


# -----------------------------------------------------------------------------
# One superstep over the stacked partitions


def bfs_step(pgv: PartitionedGraph, state: BFSState, cfg: BFSConfig,
             plan=None, mesh=None) -> BFSState:
    """One sweep of every partition the state holds. ``pgv`` is a device
    view (:func:`device_view`, of this rank's partition when ``mesh`` is
    given); ``plan`` (:func:`~repro_torch.core.engine.device_plan`) is
    needed only with ``cfg.static_exchange``."""
    p, nl = pgv.p, pgv.n_local
    rows = state.it.shape[0]
    d = state.level_d.shape[1]
    it = state.it
    cplan = comm.plan_for(cfg.comm, p if mesh is None else mesh)
    chunk = cfg.pull_chunk

    at_it = it[:, None]
    unvis_n = (state.level_n == INF_LEVEL) & pgv.normal_valid
    unvis_d = state.level_d == INF_LEVEL
    frontier_n = (state.level_n == at_it) & pgv.normal_valid
    frontier_d = state.level_d == at_it
    nd_m, dn_m, dd_m = pgv.nd_src_mask, pgv.dn_src_mask, pgv.dd_src_mask

    # ---- direction decisions (per subgraph and partition) -----------------
    fv_dd = _degree_sum(frontier_d, _row_degrees(pgv.dd))
    fv_dn = _degree_sum(frontier_d, _row_degrees(pgv.dn))
    fv_nd = _degree_sum(frontier_n, _row_degrees(pgv.nd))
    if cfg.enable_do:
        bv_dd = _bv_estimate(_count(frontier_d & dd_m), _count(unvis_d & dd_m),
                             _count(unvis_d & dd_m))
        bv_dn = _bv_estimate(_count(frontier_d & dn_m), _count(unvis_d & dn_m),
                             _count(unvis_n & nd_m))
        bv_nd = _bv_estimate(_count(frontier_n & nd_m), _count(unvis_n & nd_m),
                             _count(unvis_d & dn_m))
        f0, f1 = cfg.factor0, cfg.factor1
        backward = torch.stack([
            _decide_direction(state.backward[:, 0], fv_dd, bv_dd, f0[0], f1[0]),
            _decide_direction(state.backward[:, 1], fv_dn, bv_dn, f0[1], f1[1]),
            _decide_direction(state.backward[:, 2], fv_nd, bv_nd, f0[2], f1[2]),
        ], dim=1)
    else:
        backward = torch.zeros((rows, 3), dtype=torch.bool, device=it.device)
    bwd_dd, bwd_dn, bwd_nd = (backward[:, i, None] for i in range(3))

    # The reference computes every pull and push and selects by direction.
    # Here each pull's active rows are masked by its partition's direction,
    # so a forward partition's rows exit at once: the same found rows where
    # the pull is selected, and work 0 exactly where the reference discards
    # it. One launch pulls all three subgraphs: dd, nd (walks the dn
    # subgraph), dn (walks the nd subgraph).
    mask_d = pack_lanes(frontier_d)
    (pull_dd, work_dd_b), (pull_nd, work_nd_b), (pull_dn, work_dn_b) = \
        _pull_sweep([(pgv.dd, unvis_d & dd_m & bwd_dd, mask_d),
                     (pgv.dn, unvis_d & dn_m & bwd_nd, pack_lanes(frontier_n)),
                     (pgv.nd, unvis_n & nd_m & bwd_dn, mask_d)], chunk)

    # ---- dd: delegate -> delegate ----------------------------------------
    ec = cfg.edge_chunk
    push_dd = _push_fused(pgv.dd, frontier_d, d, ec)
    cand_dd = torch.where(bwd_dd, pull_dd, push_dd)

    # ---- nd: normal -> delegate -------------------------------------------
    push_nd = _push_fused(pgv.nd, frontier_n, d, ec)
    cand_nd = torch.where(bwd_nd, pull_nd, push_nd)

    # ---- dn: delegate -> normal -------------------------------------------
    push_dn = _push_fused(pgv.dn, frontier_d, nl, ec)
    new_n_local = torch.where(bwd_dn, pull_dn, push_dn)

    # ---- nn: normal -> normal, forward only, remote exchange --------------
    if cfg.static_exchange:
        # 1 bit per unique (owner, local) slot of the static plan
        sa, act_nn_sum = _nn_slots_bits(pgv.nn, frontier_n, plan, ec)
        recv_mask, nn_bytes, nn_sparse, ovf = comm.nn_exchange_bits(
            cplan, _dense_slots(plan, sa, p), plan.recv_local, nl)
        sent = _count(sa)
    else:
        # legacy runtime-binned path: active destination ids sorted into
        # per-owner bins of `cap` int32 ids (monolithic under edge_chunk,
        # as in the reference: its [p, E] bool flags are the working set)
        act_nn = _edge_active(pgv.nn, frontier_n)
        act_nn_sum = _count(act_nn)
        if cfg.cap_nn > 0:
            cap = cfg.cap_nn
        elif cfg.cap_nn < 0:
            cap = max(-cfg.cap_nn * pgv.nn.e_max // p, 8)
        else:
            cap = pgv.nn.e_max
        buf, ovf, sent = comm.bin_by_owner(
            pgv.nn_owner, pgv.nn.cols, act_nn, p=p, cap=cap,
            uniquify=cfg.uniquify)
        recv = comm.exchange_normal(buf, cplan).reshape(rows, -1)
        ridx = (recv.long().clamp(0, nl - 1)
                + torch.arange(rows, device=it.device)[:, None] * nl)
        recv_mask = _scatter_or(rows * nl, ridx.reshape(-1),
                                (recv >= 0).reshape(-1)).reshape(rows, nl)
        nn_bytes = cplan.a2a_bytes(cap * 4)     # [p, cap] int32 ids
        nn_sparse = 0

    # ---- delegate global reduction ----------------------------------------
    cand_d = cand_dd | cand_nd
    nxt = (it + 1)[:, None]
    if cfg.delegate_u8:
        # 1 B/delegate OR-mask (max over {0, 1} == OR); every partition
        # sets level = it + 1 locally
        delta, d_bytes = comm.delegate_combine(
            cplan, (cand_d & unvis_d).to(torch.uint8), "max")
        newly = (delta > 0) & unvis_d
        new_level_d = torch.where(newly, nxt, state.level_d)
        new_d_any = newly.any(1)
    else:
        cand_levels = torch.where(cand_d & unvis_d, nxt,
                                  _MIN_SPEC.identity).to(torch.int32)
        new_level_d, new_d_any, d_bytes = comm.delegate_min_apply(
            cplan, cand_levels, state.level_d)

    # ---- normal level updates ---------------------------------------------
    new_n_mask = (new_n_local | recv_mask) & unvis_n
    new_level_n = torch.where(new_n_mask, nxt, state.level_n)
    updated = comm.any_reduce(new_n_mask.any(1) | new_d_any, mesh)

    # ---- statistics (int32, the reference's wraparound included) ----------
    w_fwd = (torch.where(bwd_dd[:, 0], 0, fv_dd)
             + torch.where(bwd_nd[:, 0], 0, fv_nd)
             + torch.where(bwd_dn[:, 0], 0, fv_dn) + act_nn_sum)
    w_bwd = work_dd_b + work_nd_b + work_dn_b
    at = (torch.arange(rows, device=it.device),
          it.clamp(0, cfg.max_iters - 1).long())

    def put(buf, val):
        out = buf.clone()
        out[at] = torch.as_tensor(val, device=buf.device).to(torch.int32)
        return out

    def add(buf, val):
        out = buf.clone()
        out[at] += val
        return out

    if cfg.telemetry:
        # the frontier masks and directions are live already: telemetry
        # adds no collective and no host read, only its own writes
        tm = dict(
            tm_frontier_n=add(state.tm_frontier_n, _count(frontier_n)),
            tm_frontier_d=add(state.tm_frontier_d, _count(frontier_d)),
            tm_backward=put(state.tm_backward,
                            bwd_dd[:, 0].to(torch.int32)
                            + 2 * bwd_dn[:, 0].to(torch.int32)
                            + 4 * bwd_nd[:, 0].to(torch.int32)))
    else:
        tm = dict(tm_frontier_n=state.tm_frontier_n,
                  tm_frontier_d=state.tm_frontier_d,
                  tm_backward=state.tm_backward)
    return BFSState(
        level_n=new_level_n,
        level_d=new_level_d,
        backward=backward,
        it=it + 1,
        done=~updated,
        work_fwd=put(state.work_fwd, w_fwd),
        work_bwd=put(state.work_bwd, w_bwd),
        nn_sent=put(state.nn_sent, sent),
        nn_overflow=put(state.nn_overflow, ovf),
        delegate_round=put(state.delegate_round, new_d_any),
        wire_delegate=add(state.wire_delegate, d_bytes),
        wire_nn=add(state.wire_nn, nn_bytes),
        nn_sparse=add(state.nn_sparse, nn_sparse),
        **tm,
    )


# -----------------------------------------------------------------------------
# Drivers


def run_bfs_emulated(pgv: PartitionedGraph, state: BFSState, cfg: BFSConfig,
                     plan=None, mesh=None) -> BFSState:
    """Sweep until every partition reports done or ``max_iters`` is hit:
    the reference's loop condition ``~all(done) & all(it < max_iters)``,
    read as one scalar per sweep (replicated: every rank decides alike)."""
    if cfg.static_exchange and plan is None:
        raise ValueError("static_exchange=True needs the device ExchangePlan "
                         "(plan=)")
    while bool((~state.done.all()) & (state.it < cfg.max_iters).all()):
        state = bfs_step(pgv, state, cfg, plan, mesh)
    return state


def make_sharded_bfs(mesh, partition_axes, cfg: BFSConfig,
                     with_plan: bool = False):
    """Single-source BFS over a
    :class:`~repro_torch.core.comm.dist.PartitionMesh`, one partition per
    rank (paper: each partition is a GPU): ``run(pgv, state)``, or
    ``run(pgv, plan, state)`` with ``with_plan=True`` (the static
    exchange), on this rank's views and state (``init_state(...,
    mesh=mesh)``). The partition axes must be the mesh's axes."""
    mesh.check_axes(partition_axes)
    if with_plan:
        return lambda pgv, plan, st: run_bfs_emulated(pgv, st, cfg, plan,
                                                      mesh)
    return lambda pgv, st: run_bfs_emulated(pgv, st, cfg, None, mesh)


def gather_levels(pg: PartitionedGraph, state: BFSState,
                  mesh=None) -> np.ndarray:
    """Assemble global hop distances ``[n]`` int32 from partition-local and
    delegate levels (a sharded state's rows are all-gathered first: every
    rank calls it and gets every level)."""
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    level_n = state.level_n
    if mesh is not None:
        level_n = comm.dist.all_gather(mesh, level_n[0])
    level_n = level_n.cpu().numpy()
    level_d = state.level_d[0].cpu().numpy()
    vids = np.arange(pg.n, dtype=np.int64)
    out = level_n[layout.part_of(vids), layout.local_of(vids)].copy()
    if pg.d:
        out[np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]] = level_d[: pg.d]
    return out
