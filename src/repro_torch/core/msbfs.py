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

Every function works on a *stacked* partition axis: tensors carry a
leading dimension of the partitions this process holds. Emulated, that is
all ``p`` of them and the collectives run over it (the reference's
``vmap(axis_name="p")``); sharded (``mesh=``, a
:class:`~repro_torch.core.comm.dist.PartitionMesh`), each rank holds its
own partition -- leading dimension 1 -- and the collectives run over the
process group (the reference's ``shard_map``). The state has the
reference's leaves, shapes and dtypes (lane words as int32 bit patterns),
so states compare leaf by leaf after every sweep.

Typed queries ride the same lanes: a per-lane depth cap folds into the
frontier gate, per-lane target words latch ``lane_stop`` once covered,
and ``track_levels=False`` runs reachability-only batches on bool visited
words with explicit frontier words.

``MSBFSConfig(payload=True)`` carries a second plane beside the lane
words: an int32 value per (vertex, lane) under the ``min_plus`` combine
(weighted SSSP distances over the synthetic edge weights of
:mod:`~repro_torch.core.weights`, with delta-stepping buckets; connected
component labels, by min-label propagation). A payload sweep relaxes the
pending vertices under each lane's bucket with a dense min-plus scatter
along every edge, folds the delegate values with a global min
(``comm.delegate_min_apply``: one ``payload_min_fold_apply`` launch under
``allgather`` and ``hier``) and ships per-slot minimums to the normal
vertices' owners (``comm.nn_exchange_payload``); its convergence rows
ride the bit lanes' one lane reduction. Payload lanes and bit lanes mix
in one batch.

The host drivers (:func:`run_msbfs_emulated`, :func:`make_sharded_msbfs`)
loop one sweep at a time and read one scalar per sweep for their loop
condition (PyTorch has no device-side while loop; the scalar is
replicated, so every rank takes the same decision). The refill pipeline
reseeds converged lanes in place on the device (:func:`reseed_lanes`),
and its fused blocks (:func:`make_msbfs_block_emulated`,
:func:`make_sharded_msbfs_block`) run gated sweeps that stop at the exact
sweep a watched lane retires -- CUDA graph replays on a card where every
collective of the sweep can be captured.
"""
from __future__ import annotations

import dataclasses
import gc
from collections import deque
from dataclasses import dataclass, fields
from typing import Any, Sequence

import numpy as np
import torch

from . import comm
from .bfs import (_block_index, _bv_estimate, _count, _decide_direction,
                  _dense_slots, _extended, _row_degrees, edge_blocks,
                  resolve_device)
from .comm import n_words, pack_lanes, unpack_lanes
from .types import CSR, INF_LEVEL, PartitionedGraph, PartitionLayout
from .weights import SSSP_DELTA, edge_weights
from repro_torch.kernels import ops

# Sentinel per-lane depth cap meaning "unlimited".
NO_DEPTH_CAP = np.int32(INF_LEVEL)

# The per-lane payload combine identity (the min / min_plus specs): +inf
# of the min semiring, equal to INF_LEVEL, so "unreached" means the same
# in the level and payload planes.
PAY_IDENT = np.int32(comm.COMBINE_SPECS["min_plus"].identity)
assert int(PAY_IDENT) == int(INF_LEVEL)
_PAY = int(PAY_IDENT)


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
    # True carries the per-lane int32 payload plane (weighted SSSP and
    # component lanes, mixed freely with bit lanes); False keeps its leaves
    # zero-width and every bit-only counter as it was
    payload: bool = False
    # Out-of-core sweep mode: > 0 runs every push (bit and min-plus) and
    # the nn slot folds over blocks of this many edge slots of every
    # partition (a Python loop, one scatter per block into one output), so
    # the [E, W] per-edge temporaries shrink to [edge_chunk, W]. OR, min
    # and the counts are order-free, so every leaf equals the monolithic
    # sweep's. The pulls read the CSR in place and need no block. 0 =
    # monolithic.
    edge_chunk: int = 0
    # True carries the per-sweep telemetry leaves tm_* (frontier popcounts
    # and the packed per-lane directions, [p, max_iters, ...]); False
    # keeps them zero-width. Answers, schedule and counters are the same
    # either way.
    telemetry: bool = False


@dataclass
class MSBFSState:
    """Lane-word traversal state (leaves, shapes and dtypes as in the
    reference package; lane words are int32 bit patterns).

    Levels are stored *absolute*: a lane seeded at global iteration ``b``
    records its source at ``b`` (``base_it``) and depth-k vertices at
    ``b + k``; :func:`gather_levels_multi` subtracts ``base_it``. The
    telemetry leaves are zero-width unless ``cfg.telemetry``, as the
    reference keeps them; the payload leaves are too unless ``cfg.payload``
    (``Wp = W`` then, ``0`` otherwise). Payload values are absolute (SSSP
    distances from the seed's 0, component labels = global ids),
    ``PAY_IDENT`` where unreached; ``pay_pending_*`` marks vertices whose
    value improved and was not expanded yet.
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
                         # (nn="compressed": the delta-id stream won)
    nn_overflow: Any     # [p, max_iters] int32 -- slots dropped by a cap
    # per-sweep telemetry (Tm = max_iters with cfg.telemetry, else 0):
    tm_frontier_n: Any   # [p, Tm] int32 -- expand-gated normal frontier
                         # popcount (accumulated, as the wire counters)
    tm_frontier_d: Any   # [p, Tm] int32 -- delegate frontier popcount
    tm_backward: Any     # [p, Tm, 3, n_words(W)] int32 -- per-lane
                         # (dd, dn, nd) pull decisions, packed
    payload_n: Any       # [p, n_local, Wp] int32
    payload_d: Any       # [p, d, Wp] int32 (replicated content)
    pay_pending_n: Any   # [p, n_local, Wp] bool
    pay_pending_d: Any   # [p, d, Wp] bool
    pay_bucket: Any      # [p, Wp] int32 -- delta-stepping threshold
    pay_delta: Any       # [p, Wp] int32 -- bucket width (PAY_IDENT: none)
    pay_weighted: Any    # [p, Wp] bool -- pushes add the edge weight
    wire_pay_delegate: Any   # [p, max_iters or 0] int32 -- payload bytes
    wire_pay_nn: Any         # [p, max_iters or 0] int32


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


def lane_descriptors(pg: PartitionedGraph, w: int, lanes, sources, *,
                     depth_caps=None, targets=None, n_targets: int = 0,
                     layout: PartitionLayout | None = None,
                     dvids: np.ndarray | None = None) -> tuple:
    """Host-side seed coordinates and typed-query parameters of ``lanes``
    (one source each, aligned with ``depth_caps`` / ``targets``; ``None``
    entries = unlimited / none): the tuple ``(mask, part, local, dpos,
    is_delegate, depth_cap)`` of ``[W]`` arrays plus ``(tgt_part,
    tgt_local, tgt_dpos, tgt_is_delegate, tgt_valid)`` of ``[W, T]``, with
    ``T = max(n_targets, most targets of a lane)`` -- the arguments of
    :func:`reseed_lanes`, as the reference engine builds them."""
    layout = layout or PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
    if dvids is None:
        dvids = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
    lanes = [int(q) for q in lanes]
    tg = [() if targets is None or targets[i] is None else
          validate_sources(pg, targets[i]) for i in range(len(lanes))]
    t = max([n_targets] + [len(x) for x in tg])
    mask = np.zeros(w, dtype=bool)
    part, local, dpos = (np.zeros(w, dtype=np.int32) for _ in range(3))
    isd = np.zeros(w, dtype=bool)
    cap = np.full(w, NO_DEPTH_CAP, dtype=np.int32)
    tpart, tlocal, tdpos = (np.zeros((w, t), dtype=np.int32) for _ in range(3))
    tisd = np.zeros((w, t), dtype=bool)
    tvalid = np.zeros((w, t), dtype=bool)
    for i, (q, src) in enumerate(zip(lanes, sources)):
        mask[q] = True
        isd[q], part[q], local[q], dpos[q] = locate_source(pg, layout, dvids,
                                                           int(src))
        if depth_caps is not None and depth_caps[i] is not None:
            cap[q] = np.int32(depth_caps[i])
        for j, tgt in enumerate(tg[i]):
            (tisd[q, j], tpart[q, j], tlocal[q, j],
             tdpos[q, j]) = locate_source(pg, layout, dvids, int(tgt))
            tvalid[q, j] = True
    return (mask, part, local, dpos, isd, cap,
            tpart, tlocal, tdpos, tisd, tvalid)


def payload_descriptors(w: int, lanes, modes) -> tuple:
    """Host-side payload parameters of ``lanes`` (aligned with ``modes``:
    ``"sssp"``, ``"components"`` or None for a bit lane): ``(pay_lane,
    pay_seed_all, pay_weighted, pay_delta)`` ``[W]`` arrays -- the payload
    arguments of :func:`reseed_lanes`, as the reference engine builds
    them. An SSSP lane adds the edge weights under buckets of
    ``SSSP_DELTA``; a components lane seeds every vertex with its own id
    under one infinite bucket (plain min-label propagation)."""
    play, seed_all, weighted = (np.zeros(w, dtype=bool) for _ in range(3))
    delta = np.full(w, PAY_IDENT, dtype=np.int32)
    for q, mode in zip(lanes, modes):
        if mode is None:
            continue
        if mode not in ("sssp", "components"):
            raise ValueError(f"unknown payload mode {mode!r}")
        play[q] = True
        if mode == "sssp":
            weighted[q] = True
            delta[q] = np.int32(SSSP_DELTA)
        else:
            seed_all[q] = True
    return play, seed_all, weighted, delta


def gid_planes(pg: PartitionedGraph) -> tuple:
    """The global-id planes components lanes are seeded from: ``gid_n [p,
    n_local]`` int32 (``PAY_IDENT`` at slots holding no vertex) and
    ``gid_d [max(d, 1)]`` int32 (``PAY_IDENT`` at the padding slot); the
    identity keeps those slots out of the worklist."""
    k = np.arange(pg.p, dtype=np.int64)[:, None]
    gids = ((k // pg.p_gpu) + pg.p_rank * (k % pg.p_gpu)
            + pg.p * np.arange(pg.n_local, dtype=np.int64)[None, :])
    gid_n = np.where(np.asarray(pg.normal_valid), gids, PAY_IDENT)
    gid_d = np.full(max(pg.d, 1), PAY_IDENT, dtype=np.int32)
    gid_d[: pg.d] = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
    return gid_n.astype(np.int32), gid_d


def _part0(mesh) -> int:
    """The first partition a process holds: its rank when sharded."""
    return 0 if mesh is None else mesh.rank


def _empty_state(pg: PartitionedGraph, cfg: MSBFSConfig,
                 dev: torch.device, rows: int | None = None) -> MSBFSState:
    """A state with no lane seeded, built on ``dev`` with ``rows``
    partition rows (default all ``pg.p``; ``pg`` may be the host graph or
    its device view: only its sizes are read)."""
    p = pg.p if rows is None else rows
    nl, w, mi = pg.n_local, cfg.n_queries, cfg.max_iters
    d = max(pg.d, 1)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
    b = lambda *s: torch.zeros(s, dtype=torch.bool, device=dev)
    if cfg.track_levels:
        inf = lambda *s: torch.full(s, int(INF_LEVEL), dtype=torch.int32,
                                    device=dev)
        level_n, level_d = inf(p, nl, w), inf(p, d, w)
        frontier_n, frontier_d = b(p, 1, 1), b(p, 1, 1)
    else:
        level_n, level_d = b(p, nl, w), b(p, d, w)      # visited words
        frontier_n, frontier_d = b(p, nl, w), b(p, d, w)
    wp, pmi = (w, mi) if cfg.payload else (0, 0)
    tmi = mi if cfg.telemetry else 0
    ident = lambda *s: torch.full(s, _PAY, dtype=torch.int32, device=dev)
    return MSBFSState(
        level_n=level_n, level_d=level_d, backward=b(p, 3, w), it=i32(p),
        done=b(p), lane_active=b(p, w), base_it=i32(p, w), lane_stop=b(p, w),
        depth_cap=torch.full((p, w), int(NO_DEPTH_CAP), dtype=torch.int32,
                             device=dev),
        has_targets=b(p, w), target_n=b(p, nl, w), target_d=b(p, d, w),
        frontier_n=frontier_n, frontier_d=frontier_d,
        work_fwd=i32(p, mi), work_bwd=i32(p, mi), nn_sent=i32(p, mi),
        delegate_round=i32(p, mi), wire_delegate=i32(p, mi),
        wire_nn=i32(p, mi), nn_sparse=i32(p, mi), nn_overflow=i32(p, mi),
        tm_frontier_n=i32(p, tmi), tm_frontier_d=i32(p, tmi),
        tm_backward=i32(p, tmi, 3, n_words(w)),
        payload_n=ident(p, nl, wp), payload_d=ident(p, d, wp),
        pay_pending_n=b(p, nl, wp), pay_pending_d=b(p, d, wp),
        pay_bucket=ident(p, wp), pay_delta=ident(p, wp),
        pay_weighted=b(p, wp), wire_pay_delegate=i32(p, pmi),
        wire_pay_nn=i32(p, pmi))


def _upload_descriptors(desc: tuple, dev: torch.device) -> torch.Tensor:
    """The descriptor tuple of :func:`lane_descriptors` (followed by the
    four of :func:`payload_descriptors` for a payload reseed) as one int32
    ``[W, 6 + 5T (+ 4)]`` tensor on ``dev``: one host-to-device copy, from
    pinned memory on a card (so it never waits for the sweeps in flight)."""
    w = desc[0].shape[0]
    host = torch.from_numpy(np.concatenate(
        [np.asarray(a).reshape(w, -1).astype(np.int32) for a in desc], 1))
    if dev.type == "cuda":
        return host.pin_memory().to(dev, non_blocking=True)
    return host.to(dev)


def _seed_lanes(state: MSBFSState, desc: torch.Tensor, part0: int = 0,
                gids: tuple | None = None) -> MSBFSState:
    """Retire the lanes of ``desc``'s mask and seed them in place of the
    old tenants, on the state's device (``desc``: the packed descriptors
    of :func:`_upload_descriptors`; the state's rows are partitions
    ``part0, part0 + 1, ...``, and a seed or target on another partition
    leaves them untouched). Every other lane stays bit-identical.

    Each seeded lane's columns are cleared (INF levels, or no visited /
    frontier bit), its source is seeded at the *current* iteration
    ``it[0]`` (the ``level == it`` frontier test picks it up on the next
    sweep), ``base_it`` records that iteration, its direction resets to
    forward, and its depth cap, target words and stop latch are replaced.
    The seed scatters write one slot per lane, so they are plain index
    writes; the target words of a lane are distinct vertices, so their
    scatter is an exact add of 0/1 bytes onto the cleared columns.

    ``gids`` (the device planes of :func:`gid_planes`) marks a payload
    reseed: ``desc`` then ends in the four payload columns. Seeded lanes'
    payload columns are cleared to the identity; a payload lane keeps its
    bit columns empty and is seeded by kind (0 at an SSSP source; every
    vertex's own id for components), its bucket set to its delta."""
    w = desc.shape[0]
    t = (desc.shape[1] - (10 if gids is not None else 6)) // 5
    lanes = torch.arange(w, device=desc.device)
    mask, isd = desc[:, 0] > 0, desc[:, 4] > 0
    part, local, dpos = (desc[:, i].long() for i in (1, 2, 3))
    rows = state.level_n.shape[0]
    part = part - part0
    mine = (part >= 0) & (part < rows)
    it = state.it[0]                      # replicated across partitions
    clear = mask[None, None, :]
    seed_n, seed_d = mask & ~isd & mine, mask & isd
    extra = {}
    if gids is not None:
        play, seed_all = desc[:, -4] > 0, desc[:, -3] > 0
        # payload lanes keep their bit columns empty
        seed_n, seed_d = seed_n & ~play, seed_d & ~play
        extra = _seed_payload(state, desc, gids, part0, mask, isd, part,
                              local, dpos, play, seed_all)
    idx_n = (torch.where(seed_n, part, 0), torch.where(seed_n, local, 0), lanes)
    idx_d = torch.where(seed_d, dpos, 0)
    if state.level_n.dtype == torch.bool:
        # reachability-only mode: visited + frontier words, seed = True
        level_n = state.level_n & ~clear
        level_n[idx_n] |= seed_n
        level_d = state.level_d & ~clear
        level_d[:, idx_d, lanes] |= seed_d[None, :]
        frontier_n = state.frontier_n & ~clear
        frontier_n[idx_n] |= seed_n
        frontier_d = state.frontier_d & ~clear
        frontier_d[:, idx_d, lanes] |= seed_d[None, :]
    else:
        inf = int(INF_LEVEL)
        level_n = torch.where(clear, inf, state.level_n)
        level_n[idx_n] = torch.minimum(level_n[idx_n],
                                       torch.where(seed_n, it, inf))
        level_d = torch.where(clear, inf, state.level_d)
        level_d[:, idx_d, lanes] = torch.minimum(
            level_d[:, idx_d, lanes], torch.where(seed_d, it, inf)[None, :])
        frontier_n, frontier_d = state.frontier_n, state.frontier_d

    tp, tl, tdp, tisd, tv = (desc[:, 6 + i * t:6 + (i + 1) * t]
                             for i in range(5))
    tv, tisd = tv > 0, tisd > 0
    tp = tp - part0
    lanes_wt = lanes[:, None].expand(w, t)
    target_n = state.target_n & ~clear
    tn = tv & ~tisd & mask[:, None] & (tp >= 0) & (tp < rows)
    target_n.view(torch.uint8).index_put_(
        (torch.where(tn, tp, 0).long(), torch.where(tn, tl, 0).long(),
         lanes_wt), tn.to(torch.uint8), accumulate=True)
    p = state.target_d.shape[0]
    target_d = state.target_d & ~clear
    td = tv & tisd & mask[:, None]
    target_d.view(torch.uint8).index_put_(
        (torch.arange(p, device=desc.device)[:, None, None],
         torch.where(td, tdp, 0).long()[None], lanes_wt[None]),
        td.to(torch.uint8)[None].expand(p, w, t), accumulate=True)

    m = mask[None, :]
    return dataclasses.replace(
        state,
        level_n=level_n, level_d=level_d,
        frontier_n=frontier_n, frontier_d=frontier_d,
        backward=state.backward & ~mask[None, None, :],
        base_it=torch.where(m, it, state.base_it),
        lane_active=state.lane_active | m,
        lane_stop=state.lane_stop & ~m,
        depth_cap=torch.where(m, desc[:, 5][None, :], state.depth_cap),
        has_targets=torch.where(m, tv.any(1)[None, :], state.has_targets),
        target_n=target_n, target_d=target_d,
        done=state.done & ~mask.any(),
        **extra,
    )


def _seed_payload(state: MSBFSState, desc, gids, part0: int, mask, isd,
                  part, local, dpos, play, seed_all) -> dict:
    """The payload leaves of :func:`_seed_lanes`' reseed (``part`` is
    already relative to this process's first row)."""
    w = mask.shape[0]
    rows = state.payload_n.shape[0]
    if state.payload_n.shape[-1] != w:
        raise ValueError("payload lanes need a cfg.payload state")
    lanes = torch.arange(w, device=mask.device)
    gid_n = gids[0][part0:part0 + rows]                     # [rows, nl]
    gid_d = gids[1]                                         # [d]
    clear = mask[None, None, :]
    pay_n = torch.where(clear, _PAY, state.payload_n)
    pay_d = torch.where(clear, _PAY, state.payload_d)
    pend_n = state.pay_pending_n & ~clear
    pend_d = state.pay_pending_d & ~clear
    # seed-all lanes (components): every vertex's own id; the identity at
    # slots holding no vertex keeps them out of the worklist
    sa = (mask & play & seed_all)[None, None, :]
    pay_n = torch.where(sa, gid_n[..., None], pay_n)
    pend_n = pend_n | (sa & (gid_n[..., None] < _PAY))
    pay_d = torch.where(sa, gid_d[None, :, None], pay_d)
    pend_d = pend_d | (sa & (gid_d[None, :, None] < _PAY))
    # single-source lanes (sssp): 0 at the source, one slot per lane
    ss = mask & play & ~seed_all
    ss_n = ss & ~isd & (part >= 0) & (part < rows)
    ss_d = ss & isd
    seed = lambda on: torch.where(on, 0, _PAY).to(torch.int32)
    idx_n = (torch.where(ss_n, part, 0), torch.where(ss_n, local, 0), lanes)
    pay_n[idx_n] = torch.minimum(pay_n[idx_n], seed(ss_n))
    pend_n[idx_n] |= ss_n
    idx_d = torch.where(ss_d, dpos, 0)
    pay_d[:, idx_d, lanes] = torch.minimum(pay_d[:, idx_d, lanes],
                                           seed(ss_d)[None, :])
    pend_d[:, idx_d, lanes] |= ss_d[None, :]
    m = mask[None, :]
    delta = desc[:, -1][None, :]
    return dict(payload_n=pay_n, payload_d=pay_d, pay_pending_n=pend_n,
                pay_pending_d=pend_d,
                pay_bucket=torch.where(m, delta, state.pay_bucket),
                pay_delta=torch.where(m, delta, state.pay_delta),
                pay_weighted=torch.where(m, (desc[:, -2] > 0)[None, :],
                                         state.pay_weighted))


def _device_gids(gids, dev: torch.device) -> tuple:
    """``(gid_n, gid_d)`` as int32 tensors on ``dev`` (no copy when they
    are there already)."""
    return tuple(torch.as_tensor(np.asarray(g) if not isinstance(
        g, torch.Tensor) else g, dtype=torch.int32, device=dev)
        for g in gids)


def init_multi_state(
    pg: PartitionedGraph, sources: Sequence[int], cfg: MSBFSConfig,
    *, depth_caps: Sequence | None = None, targets: Sequence | None = None,
    payload_modes: Sequence | None = None, gids: tuple | None = None,
    device="cuda", mesh=None,
) -> MSBFSState:
    """Seed one lane per source, on ``device``: the planes are filled
    there and the seed coordinates go up as one small descriptor tensor
    (nothing of ``[p, n_local, W]`` is built on the host); with ``mesh``
    it holds this rank's partition only (leading dimension 1). Fewer than
    ``n_queries`` sources leaves the tail lanes unseeded. ``depth_caps``
    gives lane ``q`` a max hop depth (``None`` = unlimited); ``targets``
    gives lane ``q`` target vertex ids (the lane retires the sweep all of
    them are visited). ``payload_modes`` (needs ``cfg.payload``) makes
    lane ``q`` an ``"sssp"`` or ``"components"`` payload lane (``None``:
    a bit lane); ``gids`` are :func:`gid_planes` already on ``device``
    (made and uploaded here where None)."""
    dev = resolve_device(device)
    w = cfg.n_queries
    sources = validate_sources(pg, sources)
    if sources.size > w:
        raise ValueError(f"{sources.size} sources > n_queries={w}")
    if (targets is not None and not cfg.enable_targets
            and any(tg is not None and len(tg) for tg in targets)):
        raise ValueError("targets given but cfg.enable_targets is False")
    modes = list(payload_modes) if payload_modes is not None else []
    modes += [None] * (sources.size - len(modes))
    if any(m is not None for m in modes) and not cfg.payload:
        raise ValueError("payload_modes given but cfg.payload is False")
    desc = lane_descriptors(pg, w, range(sources.size), sources,
                            depth_caps=depth_caps, targets=targets)
    if cfg.payload:
        desc += payload_descriptors(w, range(sources.size), modes)
        gids = _device_gids(gids if gids is not None else gid_planes(pg),
                            dev)
    rows = None if mesh is None else 1
    return _seed_lanes(_empty_state(pg, cfg, dev, rows),
                       _upload_descriptors(desc, dev), _part0(mesh),
                       gids if cfg.payload else None)


def reseed_lanes(
    state: MSBFSState, lane_mask, src_part, src_local, src_dpos,
    src_is_delegate, depth_cap=None, tgt_part=None, tgt_local=None,
    tgt_dpos=None, tgt_is_delegate=None, tgt_valid=None, pay_lane=None,
    pay_seed_all=None, pay_weighted=None, pay_delta=None, gid_n=None,
    gid_d=None, *, mesh=None,
) -> MSBFSState:
    """Retire converged lanes and reseed them with fresh queries in place
    (the reference's ``reseed_lanes``, same arguments and semantics: bit
    lanes on levels and reach-only planes, with depth caps and targets,
    and payload lanes).

    The arguments are host arrays (``[W]``, and ``[W, T]`` for the
    targets), as :func:`lane_descriptors` and :func:`payload_descriptors`
    build them; omitted typed-query arrays reset reseeded lanes to plain
    full-levels semantics. They go up to the state's device as one small
    tensor and the reseed runs there (:func:`_seed_lanes`); untouched lanes
    are bit-identical. The payload arguments are all-or-none and need a
    ``cfg.payload`` state; ``gid_n [p, n_local]`` / ``gid_d [d]`` are
    :func:`gid_planes` (tensors already on the state's device are used as
    they are). Without them the payload leaves are left alone. The result
    is a new state: unchanged leaves are shared with ``state``, the others
    are new tensors. ``mesh``: the state is this rank's partition of a
    sharded run."""
    pay = (pay_lane, pay_seed_all, pay_weighted, pay_delta, gid_n, gid_d)
    if any(a is not None for a in pay) and any(a is None for a in pay):
        raise ValueError("the payload reseed arguments are all-or-none")
    mask = np.asarray(lane_mask, dtype=bool)
    w = mask.shape[0]
    cap = (np.full(w, NO_DEPTH_CAP, dtype=np.int32) if depth_cap is None
           else depth_cap)
    tgt = (tgt_part, tgt_local, tgt_dpos, tgt_is_delegate, tgt_valid)
    if tgt_valid is None:
        tgt = tuple(np.zeros((w, 0), dtype=np.int32) for _ in range(5))
    desc = (mask, src_part, src_local, src_dpos, src_is_delegate, cap) + tgt
    dev = state.it.device
    gids = None
    if pay_lane is not None:
        desc += (pay_lane, pay_seed_all, pay_weighted, pay_delta)
        gids = _device_gids((gid_n, gid_d), dev)
    return _seed_lanes(state, _upload_descriptors(desc, dev), _part0(mesh),
                       gids)


# -----------------------------------------------------------------------------
# Lane-word traversal primitives (stacked over the partition axis)


def _push_multi(csr: CSR, frontier_rows: torch.Tensor, n_dst: int,
                edge_chunk: int = 0) -> torch.Tensor:
    """Push: gather each edge's source lane word, scatter-OR it onto the
    destination domain -> ``[p, n_dst, W]`` bool; the ``[p * E, W]``
    gather and its int32 copy are made block by block
    (:func:`~repro_torch.core.bfs.edge_blocks` of ``edge_chunk``) into one
    int32 count (OR as count > 0, order-free)."""
    p, _, w = frontier_rows.shape
    ext = _extended(frontier_rows)
    out = torch.zeros((p * n_dst, w), dtype=torch.int32,
                      device=frontier_rows.device)
    for a, b in edge_blocks(csr.e_max, edge_chunk):
        out.index_add_(0, _block_index(csr.flat_cols, p, a, b),
                       ext[_block_index(csr.flat_rows, p, a, b)].to(
                           torch.int32))
    return (out > 0).reshape(p, n_dst, w)


def _nn_slots_multi(csr: CSR, frontier_rows: torch.Tensor, plan,
                    edge_chunk: int = 0):
    """Sender-side unique-slot lane words for the nn exchange:
    ``(sa [p, cap_total, W] bool, act_sum [p])`` with ``act_sum`` the total
    active (edge, lane) count (the nn term of ``work_fwd``; ``plan.perm``
    is a permutation, so summing in permuted order is identical), over
    blocks of the permuted edge order as :func:`_push_multi`."""
    p, _, w = frontier_rows.shape
    ext = _extended(frontier_rows)
    rows = csr.flat_rows.view(p, -1)
    sa = torch.zeros((p * (plan.cap_total + 1), w), dtype=torch.int32,
                     device=frontier_rows.device)
    act_sum = 0
    for a, b in edge_blocks(csr.e_max, edge_chunk):
        act = ext[rows.gather(1, plan.perm[:, a:b].long()).reshape(-1)]
        sa.index_add_(0, _block_index(plan.flat_seg, p, a, b),
                      act.to(torch.int32))
        act_sum = act_sum + act.view(p, -1).sum(1)
        del act             # before the next block's is made
    sa = (sa > 0).reshape(p, plan.cap_total + 1, w)[:, : plan.cap_total]
    return sa, act_sum


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
# Payload-plane primitives (min_plus combine, stacked over the partitions)


@dataclass
class PayloadView:
    """What a payload sweep reads of a device view besides the view
    itself, built once per view and plan (:func:`payload_view`): each
    subgraph's per-edge weights (the reference hashes the endpoints'
    global ids inside every sweep; the weights depend only on the graph,
    so they are hashed once here, to the same values) and the nn edges'
    gather index in the plan's order."""

    w_dd: torch.Tensor    # [rows, E_dd] int32 per-edge weights
    w_nd: torch.Tensor    # [rows, E_nd]
    w_dn: torch.Tensor    # [rows, E_dn]
    w_nn: torch.Tensor    # [rows, E_nn], in the plan's permuted edge order
    nn_rows: torch.Tensor  # [rows * E_nn] int64: permuted nn gather index


def _edge_weights_of(csr: CSR, gid_rows: torch.Tensor,
                     gid_cols: torch.Tensor) -> torch.Tensor:
    """``[rows, E]`` weights of a stacked CSR's edge slots from the row and
    column domains' global ids (``[rows, R]``, ``[rows, C]``; padding edges
    hash row id 0, as the reference's extended id vector gives them; their
    value never lands)."""
    g_ext = torch.cat([gid_rows, gid_rows.new_zeros((gid_rows.shape[0], 1))],
                      1)
    return edge_weights(g_ext.gather(1, csr.rowids.long()),
                        gid_cols.gather(1, csr.cols.long().clamp(
                            0, gid_cols.shape[1] - 1)))


def payload_view(pgv: PartitionedGraph, plan, mesh=None) -> PayloadView:
    """The :class:`PayloadView` of a device view and plan (of this rank's
    partition on ``mesh``), cached on the view: payload sessions build it
    on their first sweep, bit-only ones never."""
    cache = pgv.__dict__.setdefault("_payload_views", [])
    part0 = _part0(mesh)
    for pl, k, view in cache:
        if pl is plan and k == part0:
            return view
    rows, nl = pgv.normal_valid.shape
    dev = pgv.normal_valid.device
    k = torch.arange(part0, part0 + rows, device=dev)[:, None]
    gid_n = ((k // pgv.p_gpu) + pgv.p_rank * (k % pgv.p_gpu)
             + pgv.p * torch.arange(nl, device=dev)[None, :]).to(torch.int32)
    d = max(pgv.d, 1)
    dv = pgv.delegate_vids[0]
    gid_d = torch.zeros(d, dtype=torch.int32, device=dev)
    kd = min(dv.shape[0], d)
    gid_d[:kd] = dv[:kd]
    gid_d = gid_d[None].expand(rows, d)
    own = pgv.nn_owner.long()
    nn_dst = ((own // pgv.p_gpu) + pgv.p_rank * (own % pgv.p_gpu)
              + pgv.p * pgv.nn.cols.long()).to(torch.int32)
    perm = plan.perm.long()
    g_ext = torch.cat([gid_n, gid_n.new_zeros((rows, 1))], 1)
    view = PayloadView(
        w_dd=_edge_weights_of(pgv.dd, gid_d, gid_d),
        w_nd=_edge_weights_of(pgv.nd, gid_n, gid_d),
        w_dn=_edge_weights_of(pgv.dn, gid_d, gid_n),
        w_nn=edge_weights(g_ext.gather(1, pgv.nn.rowids.long().gather(1, perm)),
                          nn_dst.gather(1, perm)),
        nn_rows=pgv.nn.flat_rows.view(rows, -1).gather(1, perm).reshape(-1))
    cache.append((plan, part0, view))
    return view


def _extended_pay(front: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``[p, R, W]`` payload rows where ``front`` (the identity elsewhere)
    plus one identity row per partition (what padding edges, rowid = R,
    gather), flattened to ``[p * (R + 1), W]``; built in one buffer (no
    second plane-sized temporary)."""
    p, r, w = vals.shape
    ext = vals.new_full((p, r + 1, w), _PAY)
    ext[:, :r] = vals
    ext[:, :r].masked_fill_(~front, _PAY)
    return ext.view(-1, w)


def _relax(ext: torch.Tensor, index: torch.Tensor, wts: torch.Tensor,
           wsel: torch.Tensor) -> torch.Tensor:
    """The min-plus candidates of one block of edges, ``[p * e, W]`` int32:
    each edge's source row of ``ext`` (:func:`_extended_pay` of the rows,
    the identity where a (row, lane) pair does not relax) plus the edge's
    weight ``wts [p, e]`` in the lanes of ``wsel [p, W]``. Identity +
    weight >= identity, so padding edges and gated lanes are no-ops of the
    min that follows."""
    p, w = wsel.shape
    cand = ext[index].view(p, -1, w)
    cand.addcmul_(wts[:, :, None], wsel[:, None, :].to(torch.int32))
    return cand.view(-1, w)


def _scatter_min_blocks(n_out: int, p: int, e_max: int, edge_chunk: int,
                        ext: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, wts: torch.Tensor,
                        wsel: torch.Tensor) -> torch.Tensor:
    """Scatter-min of the min-plus candidates of every edge slot (source
    index ``rows``, destination index ``cols``: flat ``[p * E]``; weights
    ``wts [p, E]``) onto ``[n_out, W]`` rows that start at the identity,
    block by block (:func:`~repro_torch.core.bfs.edge_blocks` of
    ``edge_chunk``; min is order-free: the result is exact)."""
    w = wsel.shape[-1]
    out = torch.full((n_out, w), _PAY, dtype=torch.int32, device=ext.device)
    for a, b in edge_blocks(e_max, edge_chunk):
        cand = _relax(ext, _block_index(rows, p, a, b), wts[:, a:b], wsel)
        out.scatter_reduce_(0, _block_index(cols, p, a, b)[:, None].expand(
            -1, w), cand, "amin")
        del cand            # before the next block's is made
    return out


def _push_payload(csr: CSR, front: torch.Tensor, pay_rows: torch.Tensor,
                  wts: torch.Tensor, wsel: torch.Tensor, n_dst: int,
                  edge_chunk: int = 0) -> torch.Tensor:
    """Min-plus push: scatter-min of ``payload[src] + weight`` along every
    edge onto the destination domain -> ``[p, n_dst, W]`` int32. ``front
    [p, R, W]`` gates which (row, lane) pairs relax; ``wsel [p, W]`` picks
    the lanes that add the weight (SSSP) or 0 (component labels). Padding
    edges land on column 0 of their partition with the identity."""
    p, _, w = front.shape
    ext = _extended_pay(front, pay_rows)
    return _scatter_min_blocks(p * n_dst, p, csr.e_max, edge_chunk, ext,
                               csr.flat_rows, csr.flat_cols, wts,
                               wsel).view(p, n_dst, w)


def _nn_slots_payload(pv: PayloadView, front_n: torch.Tensor,
                      pay_n: torch.Tensor, wsel: torch.Tensor, plan,
                      edge_chunk: int = 0) -> torch.Tensor:
    """Sender-side per-slot payload minimums of the nn edges, each edge's
    own weight added before the fold (weights differ per source at a
    shared destination): ``[p, cap_total, W]`` int32, blocked as
    :func:`_push_payload` over the plan's permuted edge order (``w_nn``
    and ``nn_rows`` are in it already). Padding edges land in the trash
    segment the slice drops."""
    p, _, w = front_n.shape
    ext = _extended_pay(front_n, pay_n)
    sa = _scatter_min_blocks(p * (plan.cap_total + 1), p, pv.w_nn.shape[1],
                             edge_chunk, ext, pv.nn_rows, plan.flat_seg,
                             pv.w_nn, wsel)
    return sa.view(p, plan.cap_total + 1, w)[:, : plan.cap_total]


def _dense_slots_payload(plan, sa: torch.Tensor, p: int) -> torch.Tensor:
    """Each sender's slot minimums ``sa [rows, cap_total, W]`` binned by
    owner peer: ``[rows, p, cap_peer, W]`` int32, the identity where no
    slot is (the min sibling of ``bfs._dense_slots``). ``sa`` is the
    sweep's own: its invalid slots are set to the identity in place."""
    rows, _, w = sa.shape
    owner = plan.seg_owner.long()
    idx = (torch.arange(rows, device=sa.device)[:, None] * p
           + owner.clamp(max=p - 1)) * plan.cap_peer + plan.seg_pos.long()
    sa.masked_fill_((owner >= p)[..., None], _PAY)
    out = torch.full((rows * p * plan.cap_peer, w), _PAY, dtype=torch.int32,
                     device=sa.device)
    out.scatter_reduce_(0, idx.reshape(-1)[:, None].expand(-1, w),
                        sa.reshape(-1, w), "amin")
    return out.view(rows, p, plan.cap_peer, w)


def _payload_sweep(pgv, plan, state: MSBFSState, cplan, mesh,
                   edge_chunk: int = 0) -> dict:
    """The payload plane's part of one sweep: relax every pending vertex
    under its lane's bucket along all four subgraphs, combine the
    delegates' candidates with a global min (one ``payload_min_fold_apply``
    launch under ``allgather`` and ``hier``) and exchange the nn slots'
    minimums.
    Returns the new payload leaves, the three convergence rows ``[rows,
    3, W]`` for the lane reduction, and the wire counters."""
    pv = payload_view(pgv, plan, mesh)
    p, nl = pgv.p, pgv.n_local
    rows, d, w = state.payload_d.shape
    wsel = state.pay_weighted
    bucket = state.pay_bucket[:, None, :]
    nv = pgv.normal_valid[:, :, None]
    # frontier: worklist vertices under the lane's current bucket
    front_n = state.pay_pending_n & nv & (state.payload_n < bucket)
    front_d = state.pay_pending_d & (state.payload_d < bucket)
    ec = edge_chunk
    # the nn slots go first, the dn push last and straight into the
    # received minimums: the fewest plane-sized buffers live at once (the
    # sweep's peak memory under edge_chunk)
    new_n, nn_bytes, _, nn_ovf = comm.nn_exchange_payload(
        cplan, _dense_slots_payload(plan, _nn_slots_payload(
            pv, front_n, state.payload_n, wsel, plan, ec), p),
        plan.recv_local, nl)
    push_dd = _push_payload(pgv.dd, front_d, state.payload_d, pv.w_dd, wsel,
                            d, ec)
    push_nd = _push_payload(pgv.nd, front_n, state.payload_n, pv.w_nd, wsel,
                            d, ec)
    new_d, _, d_bytes = comm.delegate_min_apply(
        cplan, torch.minimum(push_dd, push_nd).reshape(rows, d * w),
        state.payload_d.reshape(rows, d * w))
    new_d = new_d.view(rows, d, w)
    del push_dd, push_nd
    # new_n = min(payload_n, push_dn, received) in the received buffer
    torch.minimum(new_n, _push_payload(pgv.dn, front_d, state.payload_d,
                                       pv.w_dn, wsel, nl, ec), out=new_n)
    torch.minimum(new_n, state.payload_n, out=new_n)
    new_n.masked_fill_(~nv, _PAY)
    # expanded vertices leave the worklist; improved ones (re)enter it
    pend_n = (state.pay_pending_n & ~front_n) | (new_n < state.payload_n)
    pend_d = (state.pay_pending_d & ~front_d) | (new_d < state.payload_d)
    # local convergence rows: pending-any, under-bucket-any and the
    # negated pending minimum (the lane max reduction then gives its min)
    under = ((pend_n & (new_n < bucket)).any(1)
             | (pend_d & (new_d < bucket)).any(1))
    minpend = torch.minimum(torch.where(pend_n, new_n, _PAY).amin(1),
                            torch.where(pend_d, new_d, _PAY).amin(1))
    conv = torch.stack([(pend_n.any(1) | pend_d.any(1)).to(torch.int32),
                        under.to(torch.int32), -minpend], 1)
    return dict(payload_n=new_n, payload_d=new_d, pay_pending_n=pend_n,
                pay_pending_d=pend_d, conv=conv, d_bytes=d_bytes,
                nn_bytes=nn_bytes, nn_ovf=nn_ovf)


def _bucket_advance(state: MSBFSState, red: torch.Tensor):
    """The delta-stepping bucket advance from the reduced convergence rows
    ``red [rows, 3, W]``: a lane with pending work anywhere but none under
    its bucket jumps to the bucket boundary past the global pending
    minimum. Components lanes (delta = bucket = +inf) never advance.
    Returns ``(pending-anywhere [rows, W] bool, new bucket)``."""
    g_pend, g_under, g_min = red[:, 0] > 0, red[:, 1] > 0, -red[:, 2]
    step = state.pay_delta.clamp(min=1).long()
    nb = (g_min.clamp(0, _PAY).long() // step + 1) * step
    bucket = torch.where(g_pend & ~g_under, nb.clamp(max=_PAY).to(torch.int32),
                         state.pay_bucket)
    return g_pend, bucket


# -----------------------------------------------------------------------------
# One superstep over the stacked partitions


def msbfs_step(pgv: PartitionedGraph, plan, state: MSBFSState,
               cfg: MSBFSConfig, mesh=None) -> MSBFSState:
    """One sweep of every partition the state holds. ``pgv``/``plan`` are
    device views (:func:`repro_torch.core.bfs.device_view`,
    :func:`repro_torch.core.engine.device_plan`), of this rank's
    partition when ``mesh`` is given."""
    p, nl = pgv.p, pgv.n_local
    rows = state.it.shape[0]
    w = cfg.n_queries
    d = state.level_d.shape[1]
    it = state.it
    cplan = comm.plan_for(cfg.comm, p if mesh is None else mesh)

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
        backward = torch.zeros((rows, 3, w), dtype=torch.bool,
                               device=it.device)
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
    ec = cfg.edge_chunk
    push_dd = _push_multi(pgv.dd, frontier_d & ~bwd_dd, d, ec)
    cand_dd = push_dd | pull_dd

    # ---- nd: normal -> delegate -------------------------------------------
    push_nd = _push_multi(pgv.nd, frontier_n & ~bwd_nd, d, ec)
    cand_nd = push_nd | pull_nd

    # ---- dn: delegate -> normal -------------------------------------------
    push_dn = _push_multi(pgv.dn, frontier_d & ~bwd_dn, nl, ec)
    cand_dn = push_dn | pull_dn
    # plane-sized temporaries go once folded: the sweep's peak memory
    # under edge_chunk is its working set of planes
    del push_dn, pull_dn

    # ---- nn: normal -> normal, forward only, static slot exchange ---------
    sa, act_nn_sum = _nn_slots_multi(pgv.nn, frontier_n, plan, ec)
    sent = sa.reshape(rows, -1).sum(1)
    dense = _dense_slots(plan, sa, p)
    del sa
    recv, nn_bytes, nn_sparse, nn_ovf = comm.nn_exchange_words(
        cplan, dense, plan.recv_local, nl)
    del dense

    # ---- delegate global reduction: packed-word bitwise-OR combine, with
    # the delegate level / visited update and lane flags in its launch ----
    dl, d_bytes = comm.delegate_or_apply(
        cplan, pack_lanes(cand_dd | cand_nd), state.level_d, it,
        state.target_d if cfg.enable_targets else None)
    new_d_any = dl.any_new

    # ---- payload plane sweep (cfg.payload only) ---------------------------
    pay = (_payload_sweep(pgv, plan, state, cplan, mesh, ec) if cfg.payload
           else None)

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
    # some partition this sweep; the target word (flag 1: "lane q still has
    # an unvisited target somewhere") and the payload plane's convergence
    # rows ride the same one reduction
    flags = [newly_n.any(1)]
    if cfg.enable_targets:
        flags.append((state.target_n & unvis_n & ~newly_n).any(1))
    flags = torch.stack(flags, 1)                            # [rows, f, W]
    if cfg.payload:
        red = comm.lane_fold_reduce(
            torch.cat([flags.to(torch.int32), pay["conv"]], 1), mesh)
        pay_red, red = red[:, -3:], red[:, :-3] > 0
    else:
        red = comm.lane_any_reduce(flags, mesh)
    upd_global = red[:, 0]
    if cfg.enable_targets:
        stop_targets = state.has_targets & ~(red[:, 1] | dl.lane_unhit)
    else:
        stop_targets = torch.zeros_like(state.lane_stop)
    # latch the stop: every target covered, or the next sweep would exceed
    # the lane's depth cap
    new_stop = state.lane_stop | stop_targets | (depth + 1 >= state.depth_cap)
    lane_upd = (upd_global | dl.lane_new) & ~new_stop
    if cfg.payload:
        # payload lanes stay live while pending work remains anywhere
        # (their bit planes are empty, so the bit flags never fire for them)
        g_pend, new_bucket = _bucket_advance(state, pay_red)
        lane_upd = lane_upd | g_pend
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
    at = (torch.arange(rows, device=it.device),
          it.clamp(0, cfg.max_iters - 1).long())

    def put(buf, val):
        out = buf.clone()
        out[at] = val.to(torch.int32)
        return out

    def add(buf, val):
        out = buf.clone()
        out[at] += val
        return out

    if cfg.payload:
        # the overflow guard covers both planes
        nn_ovf = nn_ovf + pay["nn_ovf"]
        pay_leaves = dict(
            payload_n=pay["payload_n"], payload_d=pay["payload_d"],
            pay_pending_n=pay["pay_pending_n"],
            pay_pending_d=pay["pay_pending_d"], pay_bucket=new_bucket,
            pay_delta=state.pay_delta, pay_weighted=state.pay_weighted,
            wire_pay_delegate=add(state.wire_pay_delegate, pay["d_bytes"]),
            wire_pay_nn=add(state.wire_pay_nn, pay["nn_bytes"]))
    else:
        pay_leaves = {k: getattr(state, k) for k in STATE_LEAVES
                      if k.startswith(("pay", "wire_pay"))}
    if cfg.telemetry:
        # the gated frontier masks and directions are live already:
        # telemetry adds no collective and no host read, only its writes
        tm = dict(
            tm_frontier_n=add(state.tm_frontier_n,
                              frontier_n.reshape(rows, -1).sum(
                                  1, dtype=torch.int32)),
            tm_frontier_d=add(state.tm_frontier_d,
                              frontier_d.reshape(rows, -1).sum(
                                  1, dtype=torch.int32)),
            tm_backward=put(state.tm_backward, pack_lanes(backward)))
    else:
        tm = {k: getattr(state, k) for k in STATE_LEAVES
              if k.startswith("tm_")}

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
        **tm,
        **pay_leaves,
    )


# -----------------------------------------------------------------------------
# Drivers


def msbfs_step_emulated(pgv: PartitionedGraph, plan, state: MSBFSState,
                        cfg: MSBFSConfig) -> MSBFSState:
    """One emulated superstep (the host-stepped sibling of
    :func:`run_msbfs_emulated`)."""
    return msbfs_step(pgv, plan, state, cfg)


def run_msbfs_emulated(pgv: PartitionedGraph, plan, state: MSBFSState,
                       cfg: MSBFSConfig, mesh=None) -> MSBFSState:
    """Sweep until every partition reports done or ``max_iters`` is hit:
    the reference's loop condition ``~all(done) & all(it < max_iters)``,
    read as one scalar per sweep (``done`` and ``it`` are replicated, so a
    rank's own rows decide for the world)."""
    while bool((~state.done.all()) & (state.it < cfg.max_iters).all()):
        state = msbfs_step(pgv, plan, state, cfg, mesh)
    return state


def make_sharded_msbfs(mesh, partition_axes, cfg: MSBFSConfig):
    """msBFS over a :class:`~repro_torch.core.comm.dist.PartitionMesh`,
    one partition per rank: ``run(pgv, plan, state) -> state`` on this
    rank's views (:func:`repro_torch.core.bfs.local_partition` and
    :func:`repro_torch.core.engine.local_plan`, placed on its device) and
    state (``init_multi_state(..., mesh=mesh)``). Every rank calls it with
    the same sources in the same order."""
    mesh.check_axes(partition_axes)
    return lambda pgv, plan, st: run_msbfs_emulated(pgv, plan, st, cfg, mesh)


def make_sharded_msbfs_step(mesh, partition_axes, cfg: MSBFSConfig):
    """One sharded superstep: ``step(pgv, plan, state) -> state`` (the
    mesh sibling of :func:`msbfs_step_emulated`, for the refill engine)."""
    mesh.check_axes(partition_axes)
    return lambda pgv, plan, st: msbfs_step(pgv, plan, st, cfg, mesh)


# -----------------------------------------------------------------------------
# Fused k-sweep blocks (the overlapped serving pipeline's device step)

#: sweeps a runner keeps in flight past the last one whose lane word the
#: host has read. A sweep dispatched before the host saw a retirement runs
#: gated off -- still a full sweep on the device -- so this, not the block
#: length k, bounds the device time spent past a retirement. One: at the
#: serving widths a sweep takes tens of ms on the card and reading its
#: lane word then replaying the next takes tens of us (PERF.md, section 6)
LOOKAHEAD = 1


class Probe:
    """The host's copy of one sweep's outcome: row 0 of ``lane_active`` and
    ``lane_stop`` ([W] bool), ``it[0]``, and whether the sweep ran (False:
    a watched lane had retired at its entry, so it left the state as it
    was)."""

    __slots__ = ("active", "stop", "it", "ran")

    def __init__(self, v: np.ndarray, w: int):
        self.active, self.stop = v[:w] > 0, v[w:2 * w] > 0
        self.it, self.ran = int(v[2 * w]), bool(v[2 * w + 1])


def _gated_step(pgv, plan, state: MSBFSState, watch: torch.Tensor,
                cfg: MSBFSConfig, out: MSBFSState | None = None, mesh=None):
    """One sweep of a block, gated on the device: the step where no
    watched lane has retired, the state unchanged otherwise (the
    reference's ``_block_loop`` condition, evaluated per sweep). Writes
    into ``out`` where given. Returns ``(state, probe)``: ``probe`` int32
    ``[2W + 2]`` = lane_active[0], lane_stop[0], it[0], ran. The sweep
    always runs (with its collectives, on every rank): only its result is
    gated, and ``lane_active`` is replicated, so every rank gates alike."""
    go = ~(watch[None, :] & ~state.lane_active).any()
    new = msbfs_step(pgv, plan, state, cfg, mesh)
    if out is None:
        out = MSBFSState(**{k: torch.where(go, getattr(new, k),
                                           getattr(state, k))
                            for k in STATE_LEAVES})
    else:
        for k in STATE_LEAVES:
            torch.where(go, getattr(new, k), getattr(state, k),
                        out=getattr(out, k))
    i32 = torch.int32
    probe = torch.cat([out.lane_active[0].to(i32), out.lane_stop[0].to(i32),
                       out.it[:1], go.to(i32)[None]])
    return out, probe


class BlockRun:
    """One fused block in flight: up to ``k`` sweeps from ``src`` (a state,
    or the block it is chained behind), stopping at the exact sweep any
    lane of ``watch`` retires -- the reference's ``_block_loop`` contract,
    so the state at a block boundary equals the per-sweep driver's leaf for
    leaf. A block whose watch already holds a retired lane runs zero sweeps.

    Sweeps are dispatched one at a time, each gated on the device, and the
    host reads each one's :class:`Probe` (on a card from pinned memory,
    behind an event), with at most ``LOOKAHEAD`` sweeps in flight.
    :meth:`ready` never blocks; :meth:`wait` returns the block's final
    probe; ``out`` is its final state. :meth:`cancel` drops a speculative
    block (a sweep already dispatched for it runs and is discarded)."""

    def __init__(self, runner: "_Runner", src, watch: np.ndarray, k: int):
        self.runner, self.src, self.k = runner, src, int(k)
        self.watch = np.array(watch, dtype=bool)
        dev = runner.device
        host = torch.from_numpy(self.watch)
        self.watch_dev = (host.pin_memory().to(dev, non_blocking=True)
                          if dev.type == "cuda" else host.to(dev))
        self.dispatched = self.observed = 0
        self.out = None           # state after the last dispatched sweep
        self.buf = None           # ring buffer holding ``out`` (graph mode)
        self.probe: Probe | None = None
        self.cancelled = False

    @property
    def complete(self) -> bool:
        """No more sweeps to dispatch (stopped, or k dispatched)."""
        return self.probe is not None or self.dispatched == self.k

    def ready(self) -> bool:
        self.runner.pump(self, wait=False)
        return self.probe is not None

    def wait(self) -> Probe:
        self.runner.pump(self, wait=True)
        return self.probe

    def cancel(self) -> None:
        self.cancelled = True
        if self in self.runner.pending:
            self.runner.pending.remove(self)

    def _note(self, probe: Probe) -> None:
        """The host read one of this block's sweeps (in dispatch order)."""
        self.observed += 1
        if self.probe is None and ((self.watch & ~probe.active).any()
                                   or self.observed == self.k):
            self.probe = probe


class _Runner:
    """Dispatches the gated sweeps of one msBFS variant's blocks, in order.

    On the CPU each sweep runs eagerly and its probe is there when it
    returns, so a block is the reference's loop. On a card with
    ``graph=True`` one gated sweep is captured per buffer of a ring of
    ``LOOKAHEAD + 1`` static states (graph ``a`` reads buffer ``a`` and
    writes ``a + 1``); a block
    that starts from an outside state copies it into the buffer after the
    last one written. A block's final state then stays intact while up to
    ``LOOKAHEAD`` more sweeps run, which is all a speculative successor can
    dispatch before the host reads that state. The captured launches do not
    count in ``ops.LAUNCHES``; each replay adds them to ``ops.REPLAYED``.
    With ``graph=False`` on a card the same gated sweep runs eagerly (for
    timing the two apart). Sharded (``mesh``), every rank dispatches the
    same sweeps in the same order, so the captured collectives of their
    replays match."""

    def __init__(self, pgv, plan, cfg: MSBFSConfig, graph: bool, pool=None,
                 mesh=None):
        self.pgv, self.plan, self.cfg, self.mesh = pgv, plan, cfg, mesh
        self.device = pgv.normal_valid.device
        self.cuda = self.device.type == "cuda"
        self.lookahead = LOOKAHEAD
        self.pending: deque = deque()   # blocks not yet complete, in order
        self.inflight: deque = deque()  # (block, host probe, start, end)
        self.sweeps = self.gated = self.replays = 0
        self.gated_ms = 0.0
        self.graphs = None
        w = cfg.n_queries
        if self.cuda:
            self.host = torch.empty((self.lookahead + 1, 2 * w + 2),
                                    dtype=torch.int32, pin_memory=True)
            self.slot = 0
        if graph:
            if not self.cuda:
                raise ValueError("graph=True needs a card")
            self._capture(pool)

    def _capture(self, pool) -> None:
        n = self.lookahead + 1
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        rows = self.pgv.normal_valid.shape[0]
        self.bufs = [_empty_state(self.pgv, self.cfg, self.device, rows)
                     for _ in range(n)]
        self.watch = torch.zeros(self.cfg.n_queries, dtype=torch.bool,
                                 device=self.device)
        self.probes = [torch.zeros(2 * self.cfg.n_queries + 2,
                                   dtype=torch.int32, device=self.device)
                       for _ in range(n)]
        step = lambda a: self.probes[(a + 1) % n].copy_(_gated_step(
            self.pgv, self.plan, self.bufs[a], self.watch, self.cfg,
            out=self.bufs[(a + 1) % n], mesh=self.mesh)[1])
        # one eager sweep on a side stream first: it builds whatever a
        # kernel wrapper prepares on first use (and a communicator its
        # first collective), so the capture records launches only
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step(0)
        cur.wait_stream(side)
        before = dict(ops.LAUNCHES)
        self.graphs = []
        # a CUDA graph destroyed while another is being captured invalidates
        # that capture, and the graphs of a dropped engine die with its
        # reference cycles (runner <-> blocks) whenever the collector runs:
        # collect them now, and keep the collector off during the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            for a in range(n):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool):
                    step(a)
                self.graphs.append(g)
        finally:
            if collecting:
                gc.enable()
        self.per_replay = {k: (ops.LAUNCHES[k] - before[k]) // n
                           for k in before}
        ops.LAUNCHES.update(before)     # captured, not launched
        self.last = 0                   # buffer the last sweep wrote
        self.watch_of = None            # block whose watch is loaded

    def start(self, src, watch, k: int) -> BlockRun:
        blk = BlockRun(self, src, watch, k)
        self.pending.append(blk)
        self._fill()
        return blk

    def _fill(self) -> None:
        """Dispatch what the lookahead allows, blocks in order."""
        while self.pending and len(self.inflight) < self.lookahead:
            blk = self.pending[0]
            if blk.complete:            # stopped by a sweep read since
                self.pending.popleft()
                continue
            src = blk.src
            if blk.dispatched == 0 and isinstance(src, BlockRun):
                if not src.complete:
                    return
                if src.probe is not None and (blk.watch
                                              & ~src.probe.active).any():
                    # frozen at entry and the host knows it: zero sweeps
                    blk.out, blk.buf, blk.probe = src.out, src.buf, src.probe
                    self.pending.popleft()
                    continue
            self._dispatch(blk)
            if blk.complete:
                self.pending.popleft()

    def _dispatch(self, blk: BlockRun) -> None:
        first = blk.dispatched == 0
        prev = ((blk.src.out if isinstance(blk.src, BlockRun) else blk.src)
                if first else blk.out)
        start = end = None
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        if self.graphs is not None:
            n = len(self.bufs)
            a = (blk.src.buf if first and isinstance(blk.src, BlockRun)
                 else blk.buf)
            if a is None:               # an outside state: load it
                a = (self.last + 1) % n
                for key in STATE_LEAVES:
                    getattr(self.bufs[a], key).copy_(getattr(prev, key))
            if self.watch_of is not blk:
                self.watch.copy_(blk.watch_dev)
                self.watch_of = blk
            start.record()
            self.graphs[a].replay()
            self.replays += 1
            ops.count_replay(self.per_replay)
            blk.buf = self.last = (a + 1) % n
            blk.out, probe = self.bufs[blk.buf], self.probes[blk.buf]
        else:
            if self.cuda:
                start.record()
            blk.out, probe = _gated_step(self.pgv, self.plan, prev,
                                         blk.watch_dev, self.cfg,
                                         mesh=self.mesh)
        if self.cuda:
            host = self.host[self.slot]
            self.slot = (self.slot + 1) % self.host.shape[0]
            host.copy_(probe, non_blocking=True)
            end.record()
        else:
            host = probe
        blk.dispatched += 1
        self.sweeps += 1
        self.inflight.append((blk, host, start, end))

    def _read(self, wait: bool) -> bool:
        """Read the oldest sweep in flight; False if it is not done yet
        (``wait=False``)."""
        blk, host, start, end = self.inflight[0]
        if self.cuda:
            if wait:
                end.synchronize()
            elif not end.query():
                return False
        self.inflight.popleft()
        probe = Probe(host.numpy().copy(), self.cfg.n_queries)
        if not probe.ran:
            self.gated += 1
            if self.cuda:
                self.gated_ms += start.elapsed_time(end)
        if not blk.cancelled:
            blk._note(probe)
        return True

    def pump(self, blk: BlockRun, wait: bool) -> None:
        """Dispatch and read sweeps until ``blk``'s probe is known, or
        (``wait=False``) until the oldest sweep in flight is not done;
        then dispatch what the lookahead allows, so the card stays busy
        while the host works."""
        while blk.probe is None:
            self._fill()
            if not self.inflight:
                raise RuntimeError("block has no sweep in flight to wait on")
            if not self._read(wait):
                break
        self._fill()

    def drain(self) -> None:
        """Read every sweep still in flight (blocking)."""
        while self.inflight:
            self._read(True)


class SweepBlock:
    """The fused block of one msBFS variant:
    ``block(pgv, plan, state, watch) -> BlockRun`` runs up to ``k``
    sweeps, stopping at the exact sweep any watched lane converges (see
    :class:`BlockRun`); ``state`` may be a :class:`BlockRun` to chain
    behind. Its runner is built on the first call (on a card with
    ``graph`` true, the default there where it can be, that call captures
    the sweep). Sharded (``mesh``), ``graph`` defaults to true only on
    ``nccl`` (gloo collectives are host operations) and for a fixed nn
    format (the adaptive one reads its agreed scalar on the host)."""

    def __init__(self, cfg: MSBFSConfig, k: int, graph: bool | None = None,
                 pool=None, mesh=None):
        if int(k) < 1:
            raise ValueError(f"a block runs k >= 1 sweeps, got {k}")
        self.cfg, self.k, self.graph, self.pool = cfg, int(k), graph, pool
        self.mesh = mesh
        self.runner: _Runner | None = None

    def capturable(self, cuda: bool) -> bool:
        """Whether this block's sweep can be a CUDA graph."""
        return cuda and (self.mesh is None or (
            self.mesh.backend == "nccl" and self.cfg.comm.nn != "adaptive"))

    def __call__(self, pgv, plan, state, watch) -> BlockRun:
        if self.runner is None:
            cuda = pgv.normal_valid.device.type == "cuda"
            graph = self.capturable(cuda) if self.graph is None else self.graph
            self.runner = _Runner(pgv, plan, self.cfg, graph, self.pool,
                                  self.mesh)
        elif self.runner.pgv is not pgv or self.runner.plan is not plan:
            raise ValueError("a SweepBlock serves the one graph it was "
                             "first called on")
        return self.runner.start(state, watch, self.k)


def make_msbfs_block_emulated(cfg: MSBFSConfig, k: int,
                              graph: bool | None = None,
                              pool=None) -> SweepBlock:
    """The fused block for the emulated path: ``block(pgv, plan, state,
    watch) -> BlockRun`` runs up to ``k`` sweeps per host round trip with
    the reference's stop-at-retirement contract (``BlockRun.wait()`` then
    ``.out`` is the state). On a card the sweep is a CUDA graph replay
    (``graph=False`` runs it eagerly); ``pool`` is the graph memory pool
    to share (``torch.cuda.graph_pool_handle()``)."""
    return SweepBlock(cfg, k, graph, pool)


def make_sharded_msbfs_block(mesh, partition_axes, cfg: MSBFSConfig, k: int,
                             graph: bool | None = None,
                             pool=None) -> SweepBlock:
    """The mesh sibling of :func:`make_msbfs_block_emulated`: up to ``k``
    gated sharded sweeps per block with the same stop-at-retirement
    contract, on this rank's views and state. Captured on a card under
    ``nccl`` for a fixed nn format (every rank captures and replays the
    same graphs in the same order), eager otherwise."""
    mesh.check_axes(partition_axes)
    return SweepBlock(cfg, k, graph, pool, mesh)


class LaneGather:
    """Per-lane global vertex rows on their way to the host.

    Everything runs on the state's device: the lane slice, the gather of
    every vertex's slot (``part_of(v) * n_local + local_of(v)``), the
    delegate columns and, for int32 levels, the ``base_it`` subtraction;
    then the ``[k, n]`` rows are copied to the host at once -- on a card
    into pinned memory, behind an event -- so a sweep dispatched afterwards
    cannot overwrite what the copy reads. :meth:`rows` waits for the copy:
    hop distances ``[k, n]`` int32 (INF_LEVEL where unreached) from a
    levels state, reachability masks ``[k, n]`` bool from a reach-only
    one. ``payload=True`` reads the payload plane instead: absolute int32
    values (SSSP distances, component labels; ``PAY_IDENT`` where
    unreached), nothing subtracted. A sharded state (``mesh``) first
    all-gathers the partitions' selected lane columns (unpack traffic, not
    counted as wire): every rank calls it alike and gets every row."""

    def __init__(self, pg: PartitionedGraph, state: MSBFSState, lanes=None,
                 mesh=None, payload: bool = False):
        level_n, level_d, bi = ((state.payload_n, state.payload_d[0], None)
                                if payload else
                                (state.level_n, state.level_d[0],
                                 state.base_it[0]))
        dev = level_n.device
        cuda = dev.type == "cuda"
        if lanes is not None:
            sel = torch.as_tensor(np.asarray(lanes), dtype=torch.long)
            sel = sel.pin_memory().to(dev, non_blocking=True) if cuda \
                else sel.to(dev)
            level_n, level_d = level_n[..., sel], level_d[..., sel]
            bi = None if bi is None else bi[sel]
        if mesh is not None:
            level_n = comm.dist.all_gather(mesh, level_n[0])
        p, nl, k = level_n.shape
        v = torch.arange(pg.n, device=dev)
        slot = (((v % pg.p_rank) * pg.p_gpu + (v // pg.p_rank) % pg.p_gpu)
                * nl + v // p)
        rows = level_n.reshape(p * nl, k).index_select(0, slot)   # [n, k]
        if pg.d:
            dv = torch.from_numpy(np.ascontiguousarray(
                np.asarray(pg.delegate_vids).reshape(-1)[: pg.d],
                dtype=np.int64))
            dv = dv.pin_memory().to(dev, non_blocking=True) if cuda \
                else dv.to(dev)
            rows[dv] = level_d[: pg.d]
        rows = rows.t()
        if bi is not None and rows.dtype != torch.bool:
            inf = int(INF_LEVEL)
            rows = torch.where(rows == inf, inf, rows - bi[:, None])
        rows = rows.contiguous()
        self.event = None
        if cuda:
            self.host = torch.empty(rows.shape, dtype=rows.dtype,
                                    pin_memory=True)
            self.host.copy_(rows, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = rows

    def rows(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def gather_levels_multi(pg: PartitionedGraph, state: MSBFSState,
                        lanes=None, mesh=None) -> np.ndarray:
    """Per-query global hop distances ``[W, n]`` int32 (``[len(lanes), n]``
    when ``lanes`` is given); ``base_it`` is subtracted per lane."""
    return LaneGather(pg, state, lanes, mesh).rows()


def gather_reachable_multi(pg: PartitionedGraph, state: MSBFSState,
                           lanes=None, mesh=None) -> np.ndarray:
    """Per-query reachability masks ``[W, n]`` bool from the reachability-
    only variant's visited words."""
    return LaneGather(pg, state, lanes, mesh).rows()


def gather_payload_multi(pg: PartitionedGraph, state: MSBFSState,
                         lanes=None, mesh=None) -> np.ndarray:
    """Per-lane global payload columns ``[k, n]`` int32 (absolute values,
    ``PAY_IDENT`` where unreached; no ``base_it`` subtraction)."""
    return LaneGather(pg, state, lanes, mesh, payload=True).rows()
