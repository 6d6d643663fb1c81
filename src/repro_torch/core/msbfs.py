"""Batched multi-source BFS (msBFS) over the four-subgraph representation.

The paper's communication model carries 1 bit of visited status per
vertex; widening each bit to a W-bit **lane word** runs W independent BFS
queries in one sweep (lane ``q`` of vertex ``v``'s word is query ``q``'s
visited/frontier bit):

* **push** is a scatter-OR of lane words along edges;
* **pull** is the chunked parent scan with *word-OR early exit*, fused
  into one kernel launch for the three subgraphs of a sweep
  (``kernels.ops.ell_pull_chunked_sweep``): a row stops scanning once its
  accumulated parent word covers all of its still-unvisited lanes;
* **delegate reduction** packs the candidate lanes to ``[d, n_words]``
  words and OR-combines them over the partitions (all-gather + the
  ``mask_reduce`` fold kernel, which also applies the result to the
  delegate levels and lane flags in the same launch);
* **nn exchange** ships one word per 32 queries per static
  (owner, local) slot of the :class:`~repro_torch.core.engine.ExchangePlan`;
* **direction optimization** is decided per lane from per-lane FV/BV
  estimates, in float32 with the reference's expression order.

Every function works on the *stacked* partition axis: tensors carry a
leading ``p`` dimension and the collectives run over it (the emulated
backend -- the reference's ``vmap(axis_name="p")``). The state has the
reference's leaves, shapes and dtypes (lane words as int32 bit patterns),
so states compare leaf by leaf after every sweep.

Typed queries ride the same lanes: a per-lane depth cap folds into the
frontier gate, per-lane target words latch ``lane_stop`` once covered,
and ``track_levels=False`` runs reachability-only batches on bool visited
words with explicit frontier words.

The host driver :func:`run_msbfs_emulated` loops one sweep at a time and
reads one scalar per sweep for its loop condition (PyTorch has no
device-side while loop).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Sequence

import numpy as np
import torch

from . import comm
from .bfs import (_bv_estimate, _count, _decide_direction, _dense_slots,
                  _row_degrees, _scatter_or, resolve_device)
from .comm import n_words, pack_lanes, unpack_lanes
from .types import CSR, INF_LEVEL, PartitionedGraph, PartitionLayout
from repro_torch.kernels import ops

# Sentinel per-lane depth cap meaning "unlimited".
NO_DEPTH_CAP = np.int32(INF_LEVEL)


# -----------------------------------------------------------------------------
# Config / state


@dataclass(frozen=True)
class MSBFSConfig:
    n_queries: int = 32     # W: concurrent BFS queries per batch
    max_iters: int = 64
    enable_do: bool = True
    pull_chunk: int = 32
    # per-lane direction-switch factors, order (dd, dn, nd)
    factor0: tuple = (0.5, 0.05, 1e-7)
    factor1: tuple = (1e-3, 1e-4, 1e-9)
    # False: the reachability-only variant (bool visited words + explicit
    # frontier words instead of int32 levels)
    track_levels: bool = True
    # False drops the per-sweep multi-target coverage scan for batches with
    # no MULTI_TARGET lane; seeding targets then raises
    enable_targets: bool = True
    comm: comm.CommConfig = comm.CommConfig()


@dataclass
class MSBFSState:
    """Lane-word traversal state (leaves, shapes and dtypes as in the
    reference package; lane words are int32 bit patterns).

    Levels are stored *absolute*: a lane seeded at global iteration ``b``
    records its source at ``b`` (``base_it``) and depth-k vertices at
    ``b + k``; :func:`gather_levels_multi` subtracts ``base_it``. The
    telemetry and payload leaves are zero-width, as the reference keeps
    them when those modes are off.
    """

    level_n: Any     # [p, n_local, W] int32 (bool visited in reach-only mode)
    level_d: Any     # [p, d, W] int32 (replicated content)
    backward: Any    # [p, 3, W] bool -- per-lane direction per (dd, dn, nd)
    it: Any          # [p] int32
    done: Any        # [p] bool
    lane_active: Any  # [p, W] bool -- lane's frontier non-empty at `it`
    base_it: Any     # [p, W] int32 -- iteration the lane was seeded at
    lane_stop: Any   # [p, W] bool -- latched early exit (cap / targets hit)
    depth_cap: Any   # [p, W] int32 -- max hop depth (NO_DEPTH_CAP = none)
    has_targets: Any  # [p, W] bool
    target_n: Any    # [p, n_local, W] bool
    target_d: Any    # [p, d, W] bool
    frontier_n: Any  # [p, n_local, W] bool ([p, 1, 1] unless reach-only)
    frontier_d: Any  # [p, d, W] bool ([p, 1, 1] unless reach-only)
    work_fwd: Any    # [p, max_iters] int32 -- edge-lane pairs pushed
    work_bwd: Any    # [p, max_iters] int32 -- parent slots pulled
    nn_sent: Any     # [p, max_iters] int32 -- active (slot, lane) pairs sent
    delegate_round: Any  # [p, max_iters] int32 -- delegate combine found news
    wire_delegate: Any   # [p, max_iters] int32 -- delegate-combine bytes
    wire_nn: Any         # [p, max_iters] int32 -- nn-exchange bytes
    nn_sparse: Any       # [p, max_iters] int32 -- sparse nn format used
    nn_overflow: Any     # [p, max_iters] int32 -- slots dropped by a cap
    tm_frontier_n: Any   # [p, 0] int32 (telemetry off)
    tm_frontier_d: Any   # [p, 0] int32
    tm_backward: Any     # [p, 0, 3, n_words(W)] int32
    payload_n: Any       # [p, n_local, 0] int32 (payload plane off)
    payload_d: Any       # [p, d, 0] int32
    pay_pending_n: Any   # [p, n_local, 0] bool
    pay_pending_d: Any   # [p, d, 0] bool
    pay_bucket: Any      # [p, 0] int32
    pay_delta: Any       # [p, 0] int32
    pay_weighted: Any    # [p, 0] bool
    wire_pay_delegate: Any   # [p, 0] int32
    wire_pay_nn: Any         # [p, 0] int32


STATE_LEAVES = tuple(f.name for f in fields(MSBFSState))


def validate_sources(pg: PartitionedGraph, sources) -> np.ndarray:
    """Flatten to int64 and range-check source vertex ids."""
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    if sources.size and ((sources < 0).any() or (sources >= pg.n).any()):
        bad = sources[(sources < 0) | (sources >= pg.n)]
        raise ValueError(f"source ids out of range [0, {pg.n}): {bad[:8].tolist()}")
    return sources


def locate_source(pg: PartitionedGraph, layout: PartitionLayout,
                  dvids: np.ndarray, src: int):
    """Host-side seed coordinates for one source vertex: ``(is_delegate,
    part, local, dpos)``. ``dvids`` must hold exactly the ``pg.d`` real
    delegate ids (empty on a delegate-free graph)."""
    pos = int(np.searchsorted(dvids, src))
    if pos < dvids.size and dvids[pos] == src:
        return True, 0, 0, pos
    return (False, int(layout.part_of(np.int64(src))),
            int(layout.local_of(np.int64(src))), 0)


def init_multi_state(
    pg: PartitionedGraph, sources: Sequence[int], cfg: MSBFSConfig,
    *, depth_caps: Sequence | None = None, targets: Sequence | None = None,
    device="cuda",
) -> MSBFSState:
    """Seed one lane per source (built on the host, then placed on
    ``device``). Fewer than ``n_queries`` sources leaves the tail lanes
    unseeded. ``depth_caps`` gives lane ``q`` a max hop depth (``None`` =
    unlimited); ``targets`` gives lane ``q`` target vertex ids (the lane
    retires the sweep all of them are visited)."""
    dev = resolve_device(device)
    w = cfg.n_queries
    sources = validate_sources(pg, sources)
    if sources.size > w:
        raise ValueError(f"{sources.size} sources > n_queries={w}")
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    p, nl = pg.p, pg.n_local
    d = max(pg.d, 1)
    dvids = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
    if cfg.track_levels:
        level_n = np.full((p, nl, w), INF_LEVEL, dtype=np.int32)
        level_d = np.full((p, d, w), INF_LEVEL, dtype=np.int32)
        frontier_n = np.zeros((p, 1, 1), dtype=bool)
        frontier_d = np.zeros((p, 1, 1), dtype=bool)
    else:
        level_n = np.zeros((p, nl, w), dtype=bool)     # visited words
        level_d = np.zeros((p, d, w), dtype=bool)
        frontier_n = np.zeros((p, nl, w), dtype=bool)
        frontier_d = np.zeros((p, d, w), dtype=bool)
    for q, src in enumerate(sources):
        isd, part, local, dpos = locate_source(pg, layout, dvids, int(src))
        if isd:
            level_d[:, dpos, q] = 0 if cfg.track_levels else True
            if not cfg.track_levels:
                frontier_d[:, dpos, q] = True
        else:
            level_n[part, local, q] = 0 if cfg.track_levels else True
            if not cfg.track_levels:
                frontier_n[part, local, q] = True
    depth_cap = np.full((p, w), NO_DEPTH_CAP, dtype=np.int32)
    if depth_caps is not None:
        for q, cap in enumerate(depth_caps):
            if cap is not None:
                depth_cap[:, q] = np.int32(cap)
    target_n = np.zeros((p, nl, w), dtype=bool)
    target_d = np.zeros((p, d, w), dtype=bool)
    has_targets = np.zeros((p, w), dtype=bool)
    if targets is not None:
        for q, tgts in enumerate(targets):
            if tgts is None or len(tgts) == 0:
                continue
            if not cfg.enable_targets:
                raise ValueError(
                    "targets given but cfg.enable_targets is False")
            has_targets[:, q] = True
            for t in validate_sources(pg, tgts):
                isd, part, local, dpos = locate_source(pg, layout, dvids, int(t))
                if isd:
                    target_d[:, dpos, q] = True
                else:
                    target_n[part, local, q] = True
    lane_active = np.zeros((p, w), dtype=bool)
    lane_active[:, : sources.size] = True
    mi = cfg.max_iters
    i32 = lambda *s: np.zeros(s, dtype=np.int32)
    host = dict(
        level_n=level_n, level_d=level_d,
        backward=np.zeros((p, 3, w), dtype=bool),
        it=i32(p), done=np.zeros((p,), dtype=bool),
        lane_active=lane_active, base_it=i32(p, w),
        lane_stop=np.zeros((p, w), dtype=bool), depth_cap=depth_cap,
        has_targets=has_targets, target_n=target_n, target_d=target_d,
        frontier_n=frontier_n, frontier_d=frontier_d,
        work_fwd=i32(p, mi), work_bwd=i32(p, mi), nn_sent=i32(p, mi),
        delegate_round=i32(p, mi), wire_delegate=i32(p, mi),
        wire_nn=i32(p, mi), nn_sparse=i32(p, mi), nn_overflow=i32(p, mi),
        tm_frontier_n=i32(p, 0), tm_frontier_d=i32(p, 0),
        tm_backward=i32(p, 0, 3, n_words(w)),
        payload_n=i32(p, nl, 0), payload_d=i32(p, d, 0),
        pay_pending_n=np.zeros((p, nl, 0), dtype=bool),
        pay_pending_d=np.zeros((p, d, 0), dtype=bool),
        pay_bucket=i32(p, 0), pay_delta=i32(p, 0),
        pay_weighted=np.zeros((p, 0), dtype=bool),
        wire_pay_delegate=i32(p, 0), wire_pay_nn=i32(p, 0))
    return MSBFSState(**{k: torch.from_numpy(v).to(dev)
                         for k, v in host.items()})


# -----------------------------------------------------------------------------
# Lane-word traversal primitives (stacked over the partition axis)


def _extended(rows: torch.Tensor) -> torch.Tensor:
    """``[p, R, W]`` rows plus one all-False row per partition (what padding
    edges, rowid = R, gather), flattened to ``[p * (R + 1), W]``."""
    p, _, w = rows.shape
    return torch.cat([rows, rows.new_zeros((p, 1, w))], 1).reshape(-1, w)


def _push_multi(csr: CSR, frontier_rows: torch.Tensor,
                n_dst: int) -> torch.Tensor:
    """Push: gather each edge's source lane word, scatter-OR it onto the
    destination domain -> ``[p, n_dst, W]`` bool."""
    p, _, w = frontier_rows.shape
    act = _extended(frontier_rows)[csr.flat_rows]           # [p*E, W]
    return _scatter_or(p * n_dst, csr.flat_cols, act).reshape(p, n_dst, w)


def _nn_slots_multi(csr: CSR, frontier_rows: torch.Tensor, plan):
    """Sender-side unique-slot lane words for the nn exchange:
    ``(sa [p, cap_total, W] bool, act_sum [p])`` with ``act_sum`` the total
    active (edge, lane) count (the nn term of ``work_fwd``; ``plan.perm``
    is a permutation, so summing in permuted order is identical)."""
    p, _, w = frontier_rows.shape
    rows = csr.flat_rows.view(p, -1).gather(1, plan.perm.long()).reshape(-1)
    act = _extended(frontier_rows)[rows]                    # [p*E, W]
    sa = _scatter_or(p * (plan.cap_total + 1), plan.flat_seg, act)
    sa = sa.reshape(p, plan.cap_total + 1, w)[:, : plan.cap_total]
    return sa, act.reshape(p, -1).sum(1)


def _pull_sweep_multi(pulls, chunk: int):
    """The chunked bottom-up pulls of a sweep with word-OR early exit, one
    kernel launch for all three subgraphs and every partition: ``pulls``
    holds ``(csr, rows_need [p, R, W], col_words [p, N, n_words(W)])``,
    the lanes each row still wants and the column domain's packed frontier
    words. Returns ``(found [p, R, W] bool, work [p])`` per pull."""
    w = pulls[0][1].shape[-1]
    out = ops.ell_pull_chunked_sweep(
        [(csr, words, pack_lanes(need)) for csr, need, words in pulls], chunk)
    return [(unpack_lanes(found, w), work.sum(1)) for found, work in out]


def _lane_degree_sum(mask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Per-lane frontier out-degree sum (FV estimate) -> ``[p, W]`` int32."""
    return (mask.to(torch.int32) * deg[..., None]).sum(1, dtype=torch.int32)


# -----------------------------------------------------------------------------
# One superstep over the stacked partitions


def msbfs_step(pgv: PartitionedGraph, plan, state: MSBFSState,
               cfg: MSBFSConfig) -> MSBFSState:
    """One sweep of every partition. ``pgv``/``plan`` are device views
    (:func:`repro_torch.core.bfs.device_view`,
    :func:`repro_torch.core.engine.device_plan`)."""
    p, nl = pgv.p, pgv.n_local
    w = cfg.n_queries
    d = state.level_d.shape[1]
    it = state.it
    cplan = comm.plan_for(cfg.comm, p)

    # typed-query liveness gate: a lane with a latched stop or at its depth
    # cap contributes no frontier this sweep
    depth = it[:, None] - state.base_it                      # [p, W]
    expand = (~state.lane_stop & (depth < state.depth_cap))[:, None, :]

    nv = pgv.normal_valid[:, :, None]
    if cfg.track_levels:
        unvis_n = (state.level_n == INF_LEVEL) & nv
        unvis_d = state.level_d == INF_LEVEL
        at_it = it[:, None, None]
        frontier_n = (state.level_n == at_it) & nv & expand
        frontier_d = (state.level_d == at_it) & expand
    else:
        unvis_n = ~state.level_n & nv
        unvis_d = ~state.level_d
        frontier_n = state.frontier_n & nv & expand
        frontier_d = state.frontier_d & expand

    deg_nd = _row_degrees(pgv.nd)
    deg_dn = _row_degrees(pgv.dn)
    deg_dd = _row_degrees(pgv.dd)
    nd_m = pgv.nd_src_mask[:, :, None]
    dn_m = pgv.dn_src_mask[:, :, None]
    dd_m = pgv.dd_src_mask[:, :, None]

    # ---- per-lane direction decisions (paper Section IV-B, widened) -------
    fv_dd = _lane_degree_sum(frontier_d, deg_dd)
    fv_dn = _lane_degree_sum(frontier_d, deg_dn)
    fv_nd = _lane_degree_sum(frontier_n, deg_nd)
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
        # a converged (or never-seeded) lane must not pull: its empty
        # frontier word could never satisfy the early exit
        backward = backward & state.lane_active[:, None, :]
    else:
        backward = torch.zeros((p, 3, w), dtype=torch.bool, device=it.device)
    bwd_dd, bwd_dn, bwd_nd = (backward[:, i, None, :] for i in range(3))

    # Lanes in forward mode push their frontier word; lanes in backward
    # mode pull into their unvisited word; the per-lane merge is an OR. One
    # launch pulls all three subgraphs: dd, nd (walks the dn subgraph), dn
    # (walks the nd subgraph).
    words_d = pack_lanes(frontier_d)
    (pull_dd, work_dd_b), (pull_nd, work_nd_b), (pull_dn, work_dn_b) = \
        _pull_sweep_multi([(pgv.dd, unvis_d & dd_m & bwd_dd, words_d),
                           (pgv.dn, unvis_d & dn_m & bwd_nd,
                            pack_lanes(frontier_n)),
                           (pgv.nd, unvis_n & nd_m & bwd_dn, words_d)],
                          cfg.pull_chunk)

    # ---- dd: delegate -> delegate ----------------------------------------
    push_dd = _push_multi(pgv.dd, frontier_d & ~bwd_dd, d)
    cand_dd = push_dd | pull_dd

    # ---- nd: normal -> delegate -------------------------------------------
    push_nd = _push_multi(pgv.nd, frontier_n & ~bwd_nd, d)
    cand_nd = push_nd | pull_nd

    # ---- dn: delegate -> normal -------------------------------------------
    push_dn = _push_multi(pgv.dn, frontier_d & ~bwd_dn, nl)
    cand_dn = push_dn | pull_dn

    # ---- nn: normal -> normal, forward only, static slot exchange ---------
    sa, act_nn_sum = _nn_slots_multi(pgv.nn, frontier_n, plan)
    recv, nn_bytes, nn_sparse, nn_ovf = comm.nn_exchange_words(
        cplan, _dense_slots(plan, sa), plan.recv_local, nl)
    sent = sa.reshape(p, -1).sum(1)

    # ---- delegate global reduction: packed-word bitwise-OR combine, with
    # the delegate level / visited update and lane flags in its launch ----
    dl, d_bytes = comm.delegate_or_apply(
        cplan, pack_lanes(cand_dd | cand_nd), state.level_d, it,
        state.target_d if cfg.enable_targets else None)
    new_d_any = dl.any_new

    # ---- level / visited updates ------------------------------------------
    newly_n = (cand_dn | recv) & unvis_n
    if cfg.track_levels:
        nxt = (it + 1)[:, None, None]
        new_level_n = torch.where(newly_n, nxt, state.level_n)
        new_frontier_n, new_frontier_d = state.frontier_n, state.frontier_d
    else:
        new_level_n = state.level_n | newly_n
        new_frontier_n, new_frontier_d = newly_n, dl.frontier

    # per-lane convergence: lane q stays live iff it marked a new vertex on
    # some partition this sweep; the target word rides the same reduction
    # (flag 1: "lane q still has an unvisited target somewhere")
    if cfg.enable_targets:
        unhit_n = (state.target_n & unvis_n & ~newly_n).any(1)
        red = comm.lane_any_reduce(torch.stack([newly_n.any(1), unhit_n], 1))
        unhit = red[:, 1] | dl.lane_unhit
        upd_global = red[:, 0]
        stop_targets = state.has_targets & ~unhit
    else:
        upd_global = comm.lane_any_reduce(newly_n.any(1))
        stop_targets = torch.zeros_like(state.lane_stop)
    # latch the stop: every target covered, or the next sweep would exceed
    # the lane's depth cap
    new_stop = state.lane_stop | stop_targets | (depth + 1 >= state.depth_cap)
    lane_upd = (upd_global | dl.lane_new) & ~new_stop
    updated = lane_upd.any(1)

    # ---- statistics (int32, the reference's wraparound included) ----------
    w_fwd = (torch.where(bwd_dd[:, 0], 0, fv_dd).sum(1)
             + torch.where(bwd_nd[:, 0], 0, fv_nd).sum(1)
             + torch.where(bwd_dn[:, 0], 0, fv_dn).sum(1))
    if cfg.track_levels:
        # exact per-edge-lane push count; the reachability-only variant
        # keeps the frontier degree-sum estimates
        w_fwd = w_fwd + act_nn_sum
    w_bwd = work_dd_b + work_nd_b + work_dn_b
    at = (torch.arange(p, device=it.device),
          it.clamp(0, cfg.max_iters - 1).long())

    def put(buf, val):
        out = buf.clone()
        out[at] = val.to(torch.int32)
        return out

    def add(buf, val):
        out = buf.clone()
        out[at] += val
        return out

    return MSBFSState(
        level_n=new_level_n,
        level_d=dl.level,
        backward=backward,
        it=it + 1,
        done=~updated,
        lane_active=lane_upd,
        base_it=state.base_it,
        lane_stop=new_stop,
        depth_cap=state.depth_cap,
        has_targets=state.has_targets,
        target_n=state.target_n,
        target_d=state.target_d,
        frontier_n=new_frontier_n,
        frontier_d=new_frontier_d,
        work_fwd=put(state.work_fwd, w_fwd),
        work_bwd=put(state.work_bwd, w_bwd),
        nn_sent=put(state.nn_sent, sent),
        delegate_round=put(state.delegate_round, new_d_any),
        wire_delegate=add(state.wire_delegate, d_bytes),
        wire_nn=add(state.wire_nn, nn_bytes),
        nn_sparse=add(state.nn_sparse, nn_sparse),
        nn_overflow=add(state.nn_overflow, nn_ovf),
        **{k: getattr(state, k) for k in STATE_LEAVES
           if k.startswith(("tm_", "pay", "wire_pay"))},
    )


# -----------------------------------------------------------------------------
# Drivers


def msbfs_step_emulated(pgv: PartitionedGraph, plan, state: MSBFSState,
                        cfg: MSBFSConfig) -> MSBFSState:
    """One emulated superstep (the host-stepped sibling of
    :func:`run_msbfs_emulated`)."""
    return msbfs_step(pgv, plan, state, cfg)


def run_msbfs_emulated(pgv: PartitionedGraph, plan, state: MSBFSState,
                       cfg: MSBFSConfig) -> MSBFSState:
    """Sweep until every partition reports done or ``max_iters`` is hit:
    the reference's loop condition ``~all(done) & all(it < max_iters)``,
    read as one scalar per sweep."""
    while bool((~state.done.all()) & (state.it < cfg.max_iters).all()):
        state = msbfs_step(pgv, plan, state, cfg)
    return state


def _gather_lane_columns(pg: PartitionedGraph, state: MSBFSState, lanes):
    """Host-side assembly of per-lane global vertex columns: ``[k, n]`` in
    the level arrays' dtype, plus the matching base iterations ``[k]``.
    The lane slice happens on the device, so only ``k`` columns cross to
    the host."""
    layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    level_n, level_d, bi = state.level_n, state.level_d[0], state.base_it[0]
    if lanes is not None:
        sel = torch.as_tensor(np.asarray(lanes), dtype=torch.long,
                              device=level_n.device)
        level_n, level_d, bi = level_n[..., sel], level_d[..., sel], bi[sel]
    level_n, level_d = level_n.cpu().numpy(), level_d.cpu().numpy()
    vids = np.arange(pg.n, dtype=np.int64)
    out = level_n[layout.part_of(vids), layout.local_of(vids)]   # [n, k]
    out = np.ascontiguousarray(out.T)                            # [k, n]
    if pg.d:
        dvids = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
        out[:, dvids] = level_d[: pg.d].T
    return out, bi.cpu().numpy()


def gather_levels_multi(pg: PartitionedGraph, state: MSBFSState,
                        lanes=None) -> np.ndarray:
    """Per-query global hop distances ``[W, n]`` int32 (``[len(lanes), n]``
    when ``lanes`` is given); ``base_it`` is subtracted per lane."""
    out, base = _gather_lane_columns(pg, state, lanes)
    return np.where(out == INF_LEVEL, INF_LEVEL, out - base[:, None])


def gather_reachable_multi(pg: PartitionedGraph, state: MSBFSState,
                           lanes=None) -> np.ndarray:
    """Per-query reachability masks ``[W, n]`` bool from the reachability-
    only variant's visited words."""
    out, _ = _gather_lane_columns(pg, state, lanes)
    return out
