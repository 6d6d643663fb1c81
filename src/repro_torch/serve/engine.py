"""msBFS serving engine: typed query queue -> lane batches -> results.

One ``BFSServeEngine`` owns a partitioned graph and its static exchange
plan on one device, with the partitions emulated on the stacked leading
axis -- or, given a multi-rank ``mesh`` (a
:class:`~repro_torch.core.comm.dist.PartitionMesh`), one partition per
rank: multi-controller, every rank builds the engine on the same graph and
submits the same queries in the same order, and every rank returns every
answer. Host decisions read only replicated values (the lane word after
its all-reduce), so all ranks take the same ones. ``submit`` answers
typed :class:`~repro_torch.serve.queries.Query`
descriptors -- full levels, reachability masks, distance-limited levels,
multi-target depths -- and ``query`` stays as the classic full-levels
sugar. Cache hits and already-mapped components are answered without a
traversal; misses are traversed, unpacked per kind and cached under
``(graph_id, kind, params, source)`` keys that equal the reference
package's.

Two scheduling modes, picked at construction:

* ``refill=False`` packs misses into W-lane batches and runs each to
  convergence (:func:`repro_torch.core.msbfs.run_msbfs_emulated`).
* ``refill=True`` runs the continuously-fed pipeline: converged lanes are
  retired (attributed through the
  :class:`~repro_torch.serve.batcher.LaneScheduler` generations) and
  reseeded on the device from the pending queue at the next sweep
  boundary, so a deep straggler never idles the other W-1 lanes.
  ``overlap=True`` drives those sessions through fused ``sweep_block``-
  sweep blocks that stop exactly at lane-retirement boundaries, with a
  speculative successor in flight while the host unpacks -- the same
  schedule and counters as the per-sweep driver, fewer host round trips.
  ``submit_stream`` / ``poll`` / ``drain_stream`` feed and drain the same
  lane word incrementally.

A batch or session that is homogeneously ``REACHABILITY`` runs the
levels-free variant (``track_levels=False``); one without a
``MULTI_TARGET`` lane drops the target scan (``enable_targets=False``);
one with a ``WEIGHTED_SSSP`` or ``COMPONENTS`` lane carries the payload
plane (``payload=True``, with ``PAYLOAD_ITERS_FACTOR`` times the sweep
budget). A ``COMPONENTS`` answer is the whole graph's label map: once one
is served, later ``COMPONENTS`` and ``REACHABILITY`` queries are answered
from it without a traversal (``reuse_components``).
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field, fields as _dc_fields, \
    replace as _dc_replace
from typing import Any

import numpy as np
import torch

from repro_torch.core import bfs as B, comm as C, engine as E, msbfs as M
from repro_torch.core.partition import partition_graph
from repro_torch.core.types import COOGraph, PartitionLayout, PartitionedGraph

from .batcher import LaneScheduler
from .cache import LRUCache
from .queries import (MAX_TARGETS, PAYLOAD_KINDS, Query, QueryKind, as_query,
                      dedupe, unpack_result)

# max_iters stretch factor for payload sessions: weighted distances run up
# to SSSP_WMAX x the hop depth, and delta-stepping revisits a vertex once
# per improving bucket, so the sweep budget scales past the bit diameter
PAYLOAD_ITERS_FACTOR = 6


def default_graph_id(pg: PartitionedGraph) -> str:
    """Content-derived cache namespace for a partitioned graph: a digest of
    the adjacency of all four subgraphs (offsets, column ids, per-partition
    edge counts) plus the delegate id map, over the same bytes as the
    reference package's, so ids and cache keys are equal across packages."""
    h = hashlib.sha256()
    for csr in (pg.nn, pg.nd, pg.dn, pg.dd):
        for arr in (csr.offsets, csr.cols, csr.m):
            a = np.ascontiguousarray(np.asarray(arr))
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    dv = np.ascontiguousarray(np.asarray(pg.delegate_vids))
    h.update(dv.tobytes())
    m = int(np.asarray(pg.nn.m).sum() + np.asarray(pg.dd.m).sum())
    return (f"pg-n{pg.n}-p{pg.p}-d{pg.d}-th{pg.th}-m{m}"
            f"-{h.hexdigest()[:12]}")


@dataclass
class ServeStats:
    """Serving counters (the reference's fields, so ``as_dict`` compares
    whole).

    * ``lanes_used`` counts lane occupancies: every traversed query once.
    * Batch mode accounts a full lane word per batch:
      ``lanes_used + lanes_padded == batches * n_queries``.
    * Refill mode: a drain session of k queries accounts ``max(n_queries,
      k)`` lane slots; ``refills`` counts mid-flight reseeds, ``sweeps``
      the session sweeps, and ``lane_sweeps_busy / lane_sweeps_total`` is
      the pipeline's lane utilization.
    * ``sweep_blocks`` counts fused block boundaries (``overlap=True`` and
      the stream API): ``sweeps / sweep_blocks`` is the fusion factor.
    * ``dedup_hits`` counts exact duplicates dropped by the refill and
      stream entry points.
    * ``wire_pay_delegate_bytes`` / ``wire_pay_nn_bytes`` are the payload
      plane's combine and exchange bytes: 0 outside payload sessions."""

    queries: int = 0
    batches: int = 0
    cache_hits: int = 0
    lanes_used: int = 0
    lanes_padded: int = 0
    refills: int = 0
    sweeps: int = 0
    lane_sweeps_busy: int = 0
    lane_sweeps_total: int = 0
    early_stops: int = 0
    reach_fast_batches: int = 0
    component_hits: int = 0
    dedup_hits: int = 0
    sweep_blocks: int = 0
    kind_counts: dict = field(default_factory=dict)
    early_stops_by_kind: dict = field(default_factory=dict)
    wire_delegate_bytes: int = 0
    wire_nn_bytes: int = 0
    wire_pay_delegate_bytes: int = 0
    wire_pay_nn_bytes: int = 0
    nn_sparse_sweeps: int = 0
    nn_overflow: int = 0

    @property
    def lane_utilization(self) -> float:
        return self.lane_sweeps_busy / max(self.lane_sweeps_total, 1)

    @property
    def wire_bytes_total(self) -> int:
        return (self.wire_delegate_bytes + self.wire_nn_bytes
                + self.wire_pay_delegate_bytes + self.wire_pay_nn_bytes)

    def note_kind(self, kind: QueryKind) -> None:
        self.kind_counts[kind.value] = self.kind_counts.get(kind.value, 0) + 1

    def note_early_stop(self, kind: QueryKind) -> None:
        self.early_stops += 1
        self.early_stops_by_kind[kind.value] = (
            self.early_stops_by_kind.get(kind.value, 0) + 1)

    def note_traversal(self, state, mesh=None) -> None:
        """Fold one finished traversal state's comm counters in (a sharded
        state's per-rank sums are all-gathered: cluster totals)."""
        # overflow is per-device send-side drops: sum every partition; the
        # format flag is partition 0's row (replicated under adaptive; under
        # compressed each partition's own stream choice)
        sums = torch.stack([state.wire_delegate.sum(), state.wire_nn.sum(),
                            state.wire_pay_delegate.sum(),
                            state.wire_pay_nn.sum(),
                            state.nn_overflow.sum(), state.nn_sparse[0].sum()])
        if mesh is not None:
            ranks = C.dist.all_gather(mesh, sums)    # partition order
            sums = torch.cat([ranks[:, :5].sum(0), ranks[0, 5:]])
        wd, wn, wpd, wpn, ovf, sparse = (int(v) for v in sums.tolist())
        self.wire_delegate_bytes += wd
        self.wire_nn_bytes += wn
        self.wire_pay_delegate_bytes += wpd
        self.wire_pay_nn_bytes += wpn
        self.nn_sparse_sweeps += sparse
        self.nn_overflow += ovf

    def as_dict(self) -> dict:
        """Every counter field plus the derived ``wire_bytes_total``."""
        out = {f.name: (dict(v) if isinstance(v := getattr(self, f.name),
                                              dict) else v)
               for f in _dc_fields(self)}
        out["wire_bytes_total"] = self.wire_bytes_total
        return out


@dataclass
class _Session:
    """Host-side bookkeeping for one refill drain / stream session.

    Shared by the per-sweep driver, the overlapped pipelined driver and the
    streaming API: retirement-boundary processing
    (:meth:`BFSServeEngine._process_boundary`) is one code path, which is
    what keeps the pipelined schedule -- and so every ``ServeStats``
    counter -- identical to the per-sweep driver's.
    """

    cfg: M.MSBFSConfig
    reach_fast: bool
    sched: LaneScheduler
    state: Any                       # device MSBFSState (latest processed)
    block: Any = None                # fused k-sweep block (pipelined)
    stream: bool = False
    results: dict = field(default_factory=dict)
    expected: dict = field(default_factory=dict)  # item -> (lane, generation)
    seen: set = field(default_factory=set)        # stream dedup identity
    undelivered: deque = field(default_factory=deque)  # stream delivery queue
    cached: set = field(default_factory=set)      # already in (or exempt
                                                  # from) the engine LRU
    cur: Any = None         # pipelined: in-flight block to process next
    head: Any = None        # pipelined: speculative successor block
    has_reach: bool = False  # session saw a REACHABILITY query (gates defer)
    busy_at_dispatch: int = 0
    it_prev: int = 0        # device `it` at the last processed boundary
    sweeps: int = 0         # session sweep count (guard)
    n_queries_seen: int = 0  # guard scaling (grows with stream submits)
    lanes_seeded: int = 0   # stream padding accounting at close

    @property
    def guard(self) -> int:
        return (self.cfg.max_iters * max(1, self.n_queries_seen)
                + self.sched.width)

    def complete(self, q, res, skip_cache: bool = False) -> None:
        """Record a finished result. Stream sessions also queue it for the
        next delivery; ``skip_cache`` marks results resolved from an
        existing memo at submit time, which are never re-put in the LRU."""
        self.results[q] = res
        if self.stream:
            self.undelivered.append(q)
            if skip_cache:
                self.cached.add(q)


class BFSServeEngine:
    """Serve typed traversal queries from batched msBFS sweeps.

    Parameters
    ----------
    graph / pg : the raw ``COOGraph`` (partitioned here with ``th`` /
        ``p_rank`` / ``p_gpu``) or an already-partitioned host graph.
    cfg : msBFS config; ``cfg.n_queries`` is the lane width W. A cfg with
        ``telemetry=True`` carries the ``tm_*`` sweep leaves through every
        traversal, block and reseed (same answers and counters); the
        engine does not harvest them yet (``last_telemetry``: ROADMAP
        item A11).
    comm : communication strategies (sugar for a cfg with ``comm=`` set).
    cache_capacity / cache_ttl : LRU entries (0 disables) and default
        per-entry time-to-live in seconds (None = never expires).
    graph_id : cache key namespace; defaults to :func:`default_graph_id`.
    refill : serve misses through the continuously-fed lane-refill
        pipeline instead of batch-at-a-time traversals.
    overlap : drive refill sessions through fused ``sweep_block``-sweep
        blocks (:func:`repro_torch.core.msbfs.make_msbfs_block_emulated`)
        that stop exactly at lane-retirement boundaries, with a
        speculative successor block in flight while the host processes
        the boundary; the schedule and every counter but ``sweep_blocks``
        equal the per-sweep driver's. No effect unless ``refill=True``.
        On a card each block's sweeps are CUDA graph replays over static
        state buffers, captured on first use (``warmup`` does it).
    sweep_block : sweeps fused per block (the convergence-poll cadence).
    edge_chunk : when > 0, every push and nn slot fold runs over blocks of
        this many edge slots (sugar for a cfg with ``edge_chunk`` set, as
        every derived per-batch variant inherits it): the per-edge
        temporaries shrink from ``[p * E, W]`` to ``[p * edge_chunk, W]``;
        answers, schedule and every counter stay those of the monolithic
        sweep. 0 = monolithic.
    specialize_reachability : run homogeneous REACHABILITY batches on the
        levels-free variant.
    reuse_components : memoize reachability answers per connected
        component (valid on undirected graphs, which every RMAT graph
        here is); later REACHABILITY queries from a mapped component are
        answered without a traversal (``stats.component_hits``).
    device : where the partition lives and the sweeps run (default
        ``"cuda"``; raises without a card -- pass ``"cpu"`` for the plain
        PyTorch path).
    mesh / partition_axes : a
        :class:`~repro_torch.core.comm.dist.PartitionMesh` to run sweeps
        on, one partition per rank (``partition_axes`` must be the mesh's
        axes; their sizes' product must equal ``pg.p``, or ``ValueError``).
        ``None`` -- or a mesh of one rank -- keeps the emulated path. Each
        rank holds its partition's views, plan rows and state rows only;
        ``pg`` may be the whole graph or, with ``plan``, this rank's
        :func:`~repro_torch.core.bfs.local_partition` alone.
    plan : the host :class:`~repro_torch.core.engine.ExchangePlan` of
        ``pg`` (built here where None; needed for a one-partition ``pg``).

    State reuse: the reference donates a block's input buffers; here every
    traversal state is a new set of tensors, except inside a fused block
    on a card, whose sweeps write a ring of static buffers. A state read
    after a later block was dispatched (the deferred gathers of a
    boundary) is copied out on the stream before that dispatch.
    """

    def __init__(
        self,
        graph: COOGraph | None = None,
        *,
        pg: PartitionedGraph | None = None,
        th: int = 64,
        p_rank: int = 1,
        p_gpu: int = 2,
        cfg: M.MSBFSConfig | None = None,
        comm: C.CommConfig | None = None,
        cache_capacity: int = 256,
        cache_ttl: float | None = None,
        graph_id: str | None = None,
        refill: bool = False,
        overlap: bool = False,
        sweep_block: int = 8,
        edge_chunk: int = 0,
        specialize_reachability: bool = True,
        reuse_components: bool = True,
        device="cuda",
        mesh=None,
        partition_axes=None,
        plan=None,
    ):
        self.device = B.resolve_device(device)
        if pg is None:
            if graph is None:
                raise ValueError("need graph= or pg=")
            pg = partition_graph(graph, th=th, p_rank=p_rank, p_gpu=p_gpu)
        self.pg = pg
        self.cfg = cfg or M.MSBFSConfig()
        if comm is not None:
            self.cfg = _dc_replace(self.cfg, comm=comm)
        if int(edge_chunk):
            self.cfg = _dc_replace(self.cfg, edge_chunk=int(edge_chunk))
        if not self.cfg.track_levels or not self.cfg.enable_targets:
            raise ValueError(
                "pass a track_levels=True, enable_targets=True cfg; the "
                "engine derives the specialized per-batch variants itself")
        self.refill = bool(refill)
        self.overlap = bool(overlap)
        if int(sweep_block) < 1:
            raise ValueError(f"sweep_block must be >= 1, got {sweep_block}")
        self.sweep_block = int(sweep_block)
        self._stream: _Session | None = None
        self.specialize_reachability = bool(specialize_reachability)
        self.reuse_components = bool(reuse_components)
        self._comp_id = np.full(pg.n, -1, dtype=np.int32)
        self._comp_masks: dict[int, np.ndarray] = {}
        # the whole graph's component label map ([n] int32, min vertex id),
        # once a COMPONENTS traversal finished
        self._comp_labels: np.ndarray | None = None
        self._gids = None        # payload seed id planes, on the device
        #: the mesh the sweeps run over (None: emulated)
        self.mesh = None
        self.sharded = False
        one_part = pg.p > 1 and np.asarray(pg.normal_valid).shape[0] == 1
        if plan is None:
            if one_part:
                raise ValueError("a one-partition pg needs its plan=")
            plan = E.build_exchange_plan(pg)
        pg_view = pg
        if mesh is not None:
            mesh.check_axes(partition_axes)
            if mesh.world > 1:
                if mesh.world != pg.p:
                    raise ValueError(
                        f"mesh axes {mesh.axes} span {mesh.world} ranks but "
                        f"the graph has p={pg.p} partitions")
                self.mesh, self.sharded = mesh, True
                if not one_part:
                    pg_view = B.local_partition(pg, mesh.rank)
                    plan = E.local_plan(plan, mesh.rank)
        if one_part and not self.sharded:
            raise ValueError("a one-partition pg runs only on a mesh")
        self.pgv = B.device_view(pg_view, self.device)
        self.plan = E.device_plan(plan, self.device)
        self.graph_id = graph_id if graph_id is not None else default_graph_id(pg)
        self.cache = LRUCache(cache_capacity, ttl=cache_ttl)
        self.stats = ServeStats()
        #: sweeps of every batch-mode traversal (batch mode keeps
        #: ``stats.sweeps`` at 0, as the reference does)
        self.traversal_sweeps = 0
        self._layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
        self._dvids = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]
        #: fused blocks by (msBFS variant, stream session): a stream
        #: session and a refill drain never share one block's buffers
        self.blocks: dict = {}
        self._graph_pool = None

    # -- per-batch variants -------------------------------------------------
    def _reach_fast(self, queries) -> bool:
        return (self.specialize_reachability
                and all(q.kind is QueryKind.REACHABILITY for q in queries))

    def _payload_cfg(self, cfg: M.MSBFSConfig) -> M.MSBFSConfig:
        """The ``payload=True`` sibling of ``cfg``, with the sweep budget
        stretched (weighted distances and bucket revisits outrun the bit
        diameter bound)."""
        return _dc_replace(cfg, payload=True,
                           max_iters=cfg.max_iters * PAYLOAD_ITERS_FACTOR)

    def _session_cfg(self, queries) -> M.MSBFSConfig:
        """The msBFS variant this batch or session runs."""
        if self._reach_fast(queries):
            return _dc_replace(self.cfg, track_levels=False,
                               enable_targets=False)
        cfg = self.cfg
        if not any(q.kind is QueryKind.MULTI_TARGET for q in queries):
            cfg = _dc_replace(cfg, enable_targets=False)
        if any(q.kind in PAYLOAD_KINDS for q in queries):
            cfg = self._payload_cfg(cfg)
        return cfg

    def _run(self, cfg: M.MSBFSConfig, st):
        """A traversal to convergence (the sharded runner on a mesh)."""
        if self.sharded:
            return M.make_sharded_msbfs(self.mesh, None, cfg)(
                self.pgv, self.plan, st)
        return M.run_msbfs_emulated(self.pgv, self.plan, st, cfg)

    def _step(self, cfg: M.MSBFSConfig, st):
        """One sweep (the sharded step on a mesh)."""
        if self.sharded:
            return M.make_sharded_msbfs_step(self.mesh, None, cfg)(
                self.pgv, self.plan, st)
        return M.msbfs_step_emulated(self.pgv, self.plan, st, cfg)

    def _init(self, sources, cfg: M.MSBFSConfig, **kw):
        if cfg.payload:
            kw["gids"] = self._pay_gids()
        return M.init_multi_state(self.pg, sources, cfg, device=self.device,
                                  mesh=self.mesh, **kw)

    def _pay_gids(self) -> tuple:
        """The payload seed id planes (:func:`msbfs.gid_planes`), uploaded
        to the device once per engine."""
        if self._gids is None:
            self._gids = tuple(torch.from_numpy(a).to(self.device)
                               for a in M.gid_planes(self.pg))
        return self._gids

    def _gather(self, cfg: M.MSBFSConfig, state, lanes,
                items) -> "_KindGather":
        """The result rows of ``lanes`` (serving ``items``), on their way
        to the host."""
        return _KindGather(self.pg, state, lanes, [
            cfg.payload and as_query(it).kind in PAYLOAD_KINDS
            for it in items], self.mesh)

    def _block(self, cfg: M.MSBFSConfig, stream: bool) -> M.SweepBlock:
        """The fused ``sweep_block``-sweep block of ``cfg`` (one per
        variant and session kind; all of an engine's captured sweeps share
        one graph memory pool, as they replay on one stream)."""
        key = (cfg, stream)
        blk = self.blocks.get(key)
        if blk is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            if self.sharded:
                blk = M.make_sharded_msbfs_block(
                    self.mesh, None, cfg, self.sweep_block,
                    pool=self._graph_pool)
            else:
                blk = M.make_msbfs_block_emulated(
                    cfg, self.sweep_block, pool=self._graph_pool)
            self.blocks[key] = blk
        return blk

    def _validate_queries(self, queries) -> None:
        """Range-check every source and target before any lane is
        seeded."""
        ids = [q.source for q in queries]
        for q in queries:
            ids.extend(q.targets or ())
        M.validate_sources(self.pg, ids)

    # -- per-component reuse (reachability masks + COMPONENTS labels) -------
    def _component_of(self, q: Query):
        """The memoized component answer covering ``q``, or None:
        REACHABILITY, the source's reachable mask (registered, or made and
        registered from the label map); COMPONENTS, the label map itself
        once any traversal computed it."""
        if not self.reuse_components:
            return None
        if q.kind is QueryKind.COMPONENTS:
            return self._comp_labels
        if q.kind is not QueryKind.REACHABILITY:
            return None
        cid = self._comp_id[q.source]
        if cid >= 0:
            return self._comp_masks[cid]
        if self._comp_labels is not None:
            mask = self._comp_labels == self._comp_labels[q.source]
            cid = len(self._comp_masks)
            self._comp_masks[cid] = mask
            self._comp_id[mask] = cid
            return mask
        return None

    def _register_component(self, q: Query, result) -> None:
        """Record a served reachability mask as its source's component, or
        a served COMPONENTS label map as the whole graph's."""
        if not self.reuse_components:
            return
        if q.kind is QueryKind.COMPONENTS:
            if self._comp_labels is None:
                self._comp_labels = np.array(result)
        elif (q.kind is QueryKind.REACHABILITY
                and self._comp_id[q.source] < 0):
            cid = len(self._comp_masks)
            self._comp_masks[cid] = np.array(result)
            self._comp_id[result] = cid

    # -- core batch path ----------------------------------------------------
    def run_batch(self, sources: np.ndarray) -> np.ndarray:
        """Traverse one full-levels lane batch (classic API): [k, n]."""
        qs = [as_query(int(s)) for s in sources]
        res = self.run_batch_queries(qs)
        return np.stack([res[q] for q in qs]) if qs else np.zeros(
            (0, self.pg.n), dtype=np.int32)

    def run_batch_queries(self, queries) -> dict:
        """Traverse one (possibly mixed-kind) lane batch of typed queries:
        {query: per-kind result}."""
        w = self.cfg.n_queries
        if len(queries) > w:
            raise ValueError(f"{len(queries)} queries > n_queries={w}")
        if not queries:
            return {}
        self._validate_queries(queries)
        reach_fast = self._reach_fast(queries)
        cfg = self._session_cfg(queries)
        st = self._init([q.source for q in queries], cfg,
                        depth_caps=[q.depth_cap for q in queries],
                        targets=[q.targets for q in queries],
                        payload_modes=[q.payload_mode for q in queries])
        out = self._run(cfg, st)
        rows = self._gather(cfg, out, np.arange(len(queries)),
                            queries).rows()
        self.traversal_sweeps += int(out.it[0])
        if reach_fast:
            self.stats.reach_fast_batches += 1
        stops = out.lane_stop[0].cpu().numpy()
        self.stats.batches += 1
        self.stats.lanes_used += len(queries)
        self.stats.lanes_padded += w - len(queries)
        self.stats.note_traversal(out, self.mesh)
        for i, q in enumerate(queries):
            if stops[i]:
                self.stats.note_early_stop(q.kind)
        return {q: unpack_result(q, rows[i], packed_reach=reach_fast)
                for i, q in enumerate(queries)}

    # -- refill path --------------------------------------------------------
    def _seed_descriptors(self, assignments, payload: bool = False) -> tuple:
        """Host-side lane seed coordinates + typed-query parameters for
        ``msbfs.reseed_lanes`` (targets padded to ``MAX_TARGETS``);
        ``payload=True`` (payload sessions) appends the payload lane
        parameters and the engine's device id planes."""
        qs = [as_query(a.item if a.item is not None else a.source)
              for a in assignments]
        w, lanes = self.cfg.n_queries, [a.lane for a in assignments]
        desc = M.lane_descriptors(
            self.pg, w, lanes, [a.source for a in assignments],
            depth_caps=[q.depth_cap for q in qs],
            targets=[q.targets for q in qs], n_targets=MAX_TARGETS,
            layout=self._layout, dvids=self._dvids)
        if not payload:
            return desc
        return (desc + M.payload_descriptors(w, lanes,
                                             [q.payload_mode for q in qs])
                + self._pay_gids())

    def run_refill(self, sources: np.ndarray) -> dict:
        """Classic full-levels drain: dedups ``sources`` (counted in
        ``stats.dedup_hits``) and returns {source: levels [n] int32}."""
        sources = M.validate_sources(self.pg, sources)
        qs = [as_query(int(s)) for s in sources.tolist()]
        return {q.source: lev
                for q, lev in self.run_refill_queries(qs).items()}

    def run_refill_queries(self, queries) -> dict:
        """Drain typed ``queries`` through the continuously-fed lane
        pipeline: {query: per-kind result}.

        Exact duplicate descriptors are dropped up front (counted in
        ``stats.dedup_hits``). Lanes are retired the sweep their early exit
        latches or their frontier empties and reseeded from the pending
        queue at the next sweep boundary; results are attributed through
        the scheduler's (lane, generation) bookkeeping. ``overlap=True``
        engines drain through the pipelined driver (same schedule, same
        counters, fewer host round trips)."""
        queries, dups = dedupe([as_query(q) for q in queries])
        self.stats.dedup_hits += dups
        if not queries:
            return {}
        self._validate_queries(queries)
        sess = self._open_session(queries)
        if self.overlap:
            while sess.sched.n_busy:
                self._pipeline_advance(sess)
        else:
            self._drain_sync(sess)
        self._close_session(sess)
        return sess.results

    # -- session machinery (shared by sync / pipelined / streaming) ---------
    def _open_session(self, queries, stream: bool = False) -> _Session:
        """Pick the msBFS variant from the opening query set, seed the
        initial lane fill and account the session-open stats. A stream
        session opens with an empty lane word and, unless its opening set
        is homogeneously REACHABILITY, the fully-general variant, so later
        MULTI_TARGET submissions can be seeded."""
        w = self.cfg.n_queries
        reach_fast = self._reach_fast(queries)
        if stream and not reach_fast:
            # open-ended feed: the fully general variant, so later
            # MULTI_TARGET submissions can be seeded; the payload plane
            # only if the opening set asks for it (later payload
            # submissions to a bit-only stream raise)
            cfg = self.cfg
            if any(q.kind in PAYLOAD_KINDS for q in queries):
                cfg = self._payload_cfg(cfg)
        else:
            cfg = self._session_cfg(queries)
        sess = _Session(
            cfg=cfg, reach_fast=reach_fast,
            sched=LaneScheduler(w, pending=() if stream else queries),
            state=self._init([], cfg),
            stream=stream, n_queries_seen=0 if stream else len(queries),
            has_reach=any(q.kind is QueryKind.REACHABILITY for q in queries))
        if self.overlap or stream:
            sess.block = self._block(cfg, stream)
        if reach_fast:
            self.stats.reach_fast_batches += 1
        self._fill(sess, initial=True)
        self.stats.batches += 1
        if not stream:
            self.stats.lanes_padded += max(0, w - len(queries))
        return sess

    def _reseed(self, sess: _Session, assignments):
        return M.reseed_lanes(sess.state, *self._seed_descriptors(
            assignments, payload=sess.cfg.payload), mesh=self.mesh)

    def _fill(self, sess: _Session, initial: bool = False) -> list:
        """Assign pending queries to idle lanes and reseed them on the
        device; ``initial`` fills count toward ``lanes_used`` only, later
        ones are mid-flight ``refills``."""
        fresh = sess.sched.fill_idle()
        if fresh:
            sess.state = self._reseed(sess, fresh)
            self.stats.lanes_used += len(fresh)
            sess.lanes_seeded += len(fresh)
            if not initial:
                self.stats.refills += len(fresh)
            for a in fresh:
                sess.expected[a.item] = (a.lane, a.generation)
        return fresh

    def _process_boundary(self, sess: _Session, active: np.ndarray,
                          stops: np.ndarray | None = None,
                          defer: bool = False):
        """Retirement-boundary processing on ``sess.state`` (whose
        ``lane_active`` / ``lane_stop`` rows are ``active`` / ``stops``;
        ``stops`` None reads them when a lane retired): retire every newly
        converged lane, attribute results through the (lane, generation)
        bookkeeping, apply per-component reachability reuse, and refill
        idle lanes from the pending queue. Returns ``(changed,
        deferred)``: ``changed`` is True iff the scheduler changed;
        ``deferred`` carries the retired lanes' gather (already enqueued
        on the device, so a later dispatch cannot overwrite it) when
        ``defer=True`` -- finish it with :meth:`_finish_boundary`.

        Deferral is only requested when per-component reuse cannot observe
        this boundary (``reuse_components`` off, or no REACHABILITY query
        in the session): reuse must register the freshly gathered mask
        before the cut/pending/refill decisions."""
        sched, results = sess.sched, sess.results
        finished = sched.busy & ~active
        if not finished.any():
            return False, None
        fin_lanes = np.nonzero(finished)[0]
        fin_items = [sched.lane_item[int(q)] for q in fin_lanes]
        # the retired lanes' rows (hop distances, reachability masks on a
        # reach-only state, payload columns of payload lanes), assembled on
        # the device and on their way
        gather = self._gather(sess.cfg, sess.state, fin_lanes, fin_items)
        if stops is None:
            stops = sess.state.lane_stop[0].cpu().numpy()
        if not defer:
            rows = gather.rows()
        fins = []
        for i, q in enumerate(fin_lanes):
            item, gen = sched.retire(int(q))
            if sess.expected.pop(item) != (int(q), gen):
                raise RuntimeError("lane generation bookkeeping out of sync")
            fins.append(item)
            if not defer:
                sess.complete(item, unpack_result(
                    item, rows[i], packed_reach=sess.reach_fast))
                self._register_component(item, results[item])
            if stops[q]:
                self.stats.note_early_stop(item.kind)
        if self.reuse_components:
            # a freshly mapped component may cover other reachability
            # queries: answer pending ones without a lane, and cut active
            # lanes short -- their result is already known
            for lane in np.nonzero(sched.busy)[0]:
                mask = self._component_of(as_query(sched.lane_item[lane]))
                if mask is not None:
                    item, _ = sched.retire(int(lane))
                    sess.expected.pop(item)
                    sess.complete(item, np.array(mask))
                    self.stats.component_hits += 1
            if sched.pending:
                keep = []
                for item in sched.pending:
                    mask = self._component_of(as_query(item))
                    if mask is None:
                        keep.append(item)
                    else:
                        sess.complete(item, np.array(mask))
                        self.stats.component_hits += 1
                sched.pending.clear()
                sched.pending.extend(keep)
        self._fill(sess)
        return True, ((gather, fins) if defer else None)

    def _finish_boundary(self, sess: _Session, deferred) -> None:
        """The deferred half of a retirement boundary: the retired lanes'
        columns (copied from the pre-reseed state before the next block
        was dispatched) unpacked per kind -- run while that block's sweeps
        are on the device."""
        gather, fins = deferred
        rows = gather.rows()
        for i, item in enumerate(fins):
            sess.complete(item, unpack_result(
                item, rows[i], packed_reach=sess.reach_fast))
            self._register_component(item, sess.results[item])

    def _close_session(self, sess: _Session) -> None:
        if sess.block is not None and sess.block.runner is not None:
            sess.block.runner.drain()
        self.stats.note_traversal(sess.state, self.mesh)
        if sess.stream:
            self.stats.lanes_padded += max(
                0, self.cfg.n_queries - sess.lanes_seeded)

    # -- synchronous per-sweep driver ---------------------------------------
    def _drain_sync(self, sess: _Session) -> None:
        """One host round trip per sweep: step, read ``lane_active``,
        process retirements (the ground-truth schedule the overlapped
        driver must reproduce)."""
        sched = sess.sched
        w = self.cfg.n_queries
        while sched.n_busy:
            busy_now = sched.n_busy
            sess.state = self._step(sess.cfg, sess.state)
            sess.sweeps += 1
            self.stats.sweeps += 1
            self.stats.lane_sweeps_busy += busy_now
            self.stats.lane_sweeps_total += w
            if sess.sweeps > sess.guard:
                raise RuntimeError(
                    f"refill pipeline exceeded {sess.guard} sweeps with "
                    f"{sched.n_busy} lanes still busy")
            active = sess.state.lane_active[0].cpu().numpy()
            self._process_boundary(sess, active)

    # -- overlapped pipelined driver ----------------------------------------
    def _dispatch(self, sess: _Session, src) -> M.BlockRun:
        """A block from ``src`` (a state, or the block to chain behind)
        watching the busy lanes."""
        return sess.block(self.pgv, self.plan, src, sess.sched.busy.copy())

    def _pipeline_advance(self, sess: _Session, wait: bool = True) -> bool:
        """Advance the overlapped pipeline by one block boundary.

        Dispatches a fused ``sweep_block``-sweep block (plus a speculative
        successor chained behind it), then waits on the *lagging* block
        only, never the head. While the host unpacks retired lanes and
        builds reseed descriptors, the successor keeps the device busy. A
        block stops at the exact sweep any watched lane converges, and a
        successor dispatched across a retirement boundary is frozen (and
        dropped), so the schedule equals :meth:`_drain_sync`'s.

        Returns False without processing when ``wait=False`` and the
        lagging block is not done yet (the ``poll(wait=False)`` path);
        True after a boundary was processed.
        """
        sched = sess.sched
        w = self.cfg.n_queries
        if sess.cur is None:
            if not sched.n_busy:
                if not sched.pending:
                    return False
                self._fill(sess, initial=sess.sweeps == 0)
            sess.cur = self._dispatch(sess, sess.state)
            # no speculation on a fresh dispatch: it follows a scheduler
            # change, where a head is likely to be frozen; the quiet
            # boundaries below speculate
            sess.head = None
            sess.busy_at_dispatch = sched.n_busy
        if not wait and not sess.cur.ready():
            return False
        cur = sess.cur
        probe = cur.wait()
        ran = probe.it - sess.it_prev
        busy_now = sess.busy_at_dispatch
        sess.it_prev = probe.it
        sess.sweeps += ran
        self.stats.sweeps += ran
        self.stats.lane_sweeps_busy += busy_now * ran
        self.stats.lane_sweeps_total += w * ran
        self.stats.sweep_blocks += 1
        if sess.sweeps > sess.guard:
            raise RuntimeError(
                f"refill pipeline exceeded {sess.guard} sweeps with "
                f"{sched.n_busy} lanes still busy")
        sess.state = cur.out
        defer = not (self.reuse_components and sess.has_reach)
        changed, deferred = self._process_boundary(sess, probe.active,
                                                   probe.stop, defer=defer)
        if (not changed and sess.stream and sched.pending
                and sched.n_busy < w):
            # a stream session fed mid-flight while lanes sat idle: seed
            # them at this quiet boundary instead of letting new queries
            # starve behind a deep straggler
            changed = bool(self._fill(sess))
        if changed:
            # the head (if any) saw a converged watched lane at entry and
            # froze: drop it and redispatch from the post-reseed state
            # before unpacking the retired lanes, so the host-side unpack
            # runs under the next block's sweeps
            if sess.head is not None:
                sess.head.cancel()
            sess.cur = sess.head = None
            if sched.n_busy:
                sess.cur = self._dispatch(sess, sess.state)
                sess.busy_at_dispatch = sched.n_busy
            if deferred is not None:
                self._finish_boundary(sess, deferred)
        else:
            if ran == 0:
                raise RuntimeError(
                    "overlapped pipeline made no progress (no sweeps ran "
                    "and no lane retired)")
            # no retirement: the head (when speculated) is the true
            # continuation; chain the next speculative block behind it
            nxt = sess.head if sess.head is not None else self._dispatch(
                sess, cur)
            sess.cur = nxt
            sess.head = self._dispatch(sess, nxt)
            sess.busy_at_dispatch = sched.n_busy
        return True

    # -- streaming API ------------------------------------------------------
    def submit_stream(self, queries, *, front: bool = False) -> int:
        """Feed typed queries into the continuously-fed serving stream.

        Opens a stream session on first use (its msBFS variant is picked
        from this first submission's kinds; a later submission needing
        another variant raises -- ``drain_stream`` first). Cache, component
        and in-session duplicate hits are resolved at once without a lane
        (counted in ``cache_hits`` / ``component_hits`` / ``dedup_hits``)
        and delivered by the next :meth:`poll`. Returns the number of
        queries enqueued for traversal. ``front=True`` enqueues this
        submission's misses ahead of the pending queue (their own order
        kept). Never blocks on a traversal: :meth:`poll` and
        :meth:`drain_stream` seed lanes and dispatch sweeps."""
        qs = [as_query(q) for q in queries]
        if not qs:
            return 0
        self._validate_queries(qs)
        if self._stream is not None:
            sess = self._stream
            if sess.reach_fast and any(q.kind is not QueryKind.REACHABILITY
                                       for q in qs):
                raise ValueError(
                    "stream session is specialized to levels-free "
                    "REACHABILITY; drain_stream() before submitting other "
                    "kinds")
            if not sess.cfg.enable_targets and any(
                    q.kind is QueryKind.MULTI_TARGET for q in qs):
                raise ValueError(
                    "stream session was opened without target support; "
                    "drain_stream() before submitting MULTI_TARGET queries")
            if not sess.cfg.payload and any(q.kind in PAYLOAD_KINDS
                                            for q in qs):
                raise ValueError(
                    "stream session was opened without the payload plane; "
                    "drain_stream() before submitting WEIGHTED_SSSP or "
                    "COMPONENTS queries")
        else:
            self._stream = self._open_session(qs, stream=True)
            sess = self._stream
        self.stats.queries += len(qs)
        for q in qs:
            self.stats.note_kind(q.kind)
        # traversal misses are enqueued in one scheduler call, so a
        # front=True submission lands as one contiguous run
        to_seed: list = []
        seeding: set = set()
        for q in qs:
            if q in sess.seen:
                # duplicate within the session: completed-but-undelivered
                # and in-flight/pending twins deliver once on their own; a
                # result already handed out is re-answered from the LRU,
                # or re-enqueued when nothing holds it anymore
                self.stats.dedup_hits += 1
                if q in sess.results:
                    sess.undelivered.append(q)
                elif (q in sess.expected or q in sess.sched.pending
                      or q in seeding):
                    pass
                else:
                    hit = self.cache.get(q.key(self.graph_id))
                    if hit is not None:
                        self.stats.cache_hits += 1
                        sess.complete(q, hit, skip_cache=True)
                    else:
                        sess.cached.discard(q)   # fresh traversal recaches
                        to_seed.append(q)
                        seeding.add(q)
                        sess.n_queries_seen += 1
                continue
            sess.seen.add(q)
            hit = self.cache.get(q.key(self.graph_id))
            if hit is not None:
                self.stats.cache_hits += 1
                sess.complete(q, hit, skip_cache=True)
                continue
            mask = self._component_of(q)
            if mask is not None:
                self.stats.component_hits += 1
                sess.complete(q, np.array(mask), skip_cache=True)
                continue
            if q.kind is QueryKind.REACHABILITY:
                sess.has_reach = True
            to_seed.append(q)
            seeding.add(q)
            sess.n_queries_seen += 1
        if to_seed:
            sess.sched.submit_stream(to_seed, front=front)
        return len(to_seed)

    def stream_status(self) -> dict:
        """Host-side snapshot of the stream session (all zeros when none is
        open): ``busy`` lanes, ``pending`` queries, ``undelivered``
        results waiting for the next :meth:`poll`."""
        sess = self._stream
        if sess is None:
            return {"open": False, "busy": 0, "pending": 0, "undelivered": 0}
        return {"open": True, "busy": int(sess.sched.n_busy),
                "pending": len(sess.sched.pending),
                "undelivered": len(sess.undelivered)}

    def poll(self, wait: bool = True) -> dict:
        """Advance the stream by at most one pipeline boundary and return
        the newly completed results: {query: per-kind result}.
        ``wait=False`` never blocks: if the lagging block is not done, only
        already-completed results are returned. Returned arrays are owned
        copies; completed results are cached under the engine's LRU keys."""
        sess = self._stream
        if sess is None:
            return {}
        if sess.sched.n_busy or sess.sched.pending:
            self._pipeline_advance(sess, wait=wait)
        return self._deliver(sess)

    def drain_stream(self) -> dict:
        """Run the stream to completion, close the session, and return
        every result not yet handed out by :meth:`poll`."""
        sess = self._stream
        if sess is None:
            return {}
        while sess.sched.n_busy or sess.sched.pending:
            self._pipeline_advance(sess)
        self._stream = None
        self._close_session(sess)
        return self._deliver(sess)

    def _deliver(self, sess: _Session) -> dict:
        """Drain the undelivered queue: each session-computed result is
        written to the LRU exactly once, then released from the session
        (a long-lived stream stays O(in-flight) in host memory)."""
        own = lambda r: dict(r) if isinstance(r, dict) else np.array(r)
        out = {}
        while sess.undelivered:
            q = sess.undelivered.popleft()
            if q in out:
                continue
            res = sess.results.pop(q, None)
            if res is None:
                continue            # stale queue entry: delivered earlier
            if q not in sess.cached:
                self.cache.put(q.key(self.graph_id), res)
                sess.cached.add(q)
            out[q] = own(res)
        return out

    # -- public API ---------------------------------------------------------
    def submit_many(self, queries) -> list:
        """Per-kind results for each query (raw ints coerce to LEVELS).
        Duplicate and cached queries cost nothing extra; only unique misses
        occupy lanes."""
        qs = [as_query(q) for q in queries]
        if not qs:
            return []
        self._validate_queries(qs)
        self.stats.queries += len(qs)
        for q in qs:
            self.stats.note_kind(q.kind)
        results: dict = {}
        misses: list = []
        for q in dict.fromkeys(qs):  # dedup, keep order
            hit = self.cache.get(q.key(self.graph_id))
            if hit is not None:
                self.stats.cache_hits += 1
                results[q] = hit
                continue
            memo = self._component_of(q)
            if memo is not None:
                self.stats.component_hits += 1
                results[q] = np.array(memo)
                continue
            misses.append(q)
        if self.refill:
            served = self.run_refill_queries(misses)
        else:
            served = {}
            remaining = list(misses)
            while remaining:
                if self.reuse_components:
                    # components mapped by earlier batches answer later
                    # reachability misses without a lane
                    still = []
                    for q in remaining:
                        mask = self._component_of(q)
                        if mask is None:
                            still.append(q)
                        else:
                            served[q] = np.array(mask)
                            self.stats.component_hits += 1
                    remaining = still
                    if not remaining:
                        break
                batch = remaining[: self.cfg.n_queries]
                remaining = remaining[self.cfg.n_queries:]
                batch_res = self.run_batch_queries(batch)
                for q, res in batch_res.items():
                    self._register_component(q, res)
                served.update(batch_res)
        for q, res in served.items():
            results[q] = res
            self.cache.put(q.key(self.graph_id), res)
        # hand out copies: the cached object is shared by duplicates
        own = lambda r: dict(r) if isinstance(r, dict) else np.array(r)
        return [own(results[q]) for q in qs]

    def submit(self, query):
        """One typed query -> its per-kind result."""
        return self.submit_many([query])[0]

    def query(self, sources) -> np.ndarray:
        """Full levels for each source: [len(sources), n] int32."""
        sources = np.asarray(sources, dtype=np.int64).reshape(-1)
        if sources.size == 0:
            return np.zeros((0, self.pg.n), dtype=np.int32)
        return np.stack(self.submit_many([int(s) for s in sources]))

    def query_one(self, source: int) -> np.ndarray:
        return self.query([source])[0]

    def sample_khop(self, source: int, k: int, sampler):
        """Serve a ``KHOP_SAMPLE`` query and feed its node pool to a
        :class:`~repro_torch.graphs.sampler.NeighborSampler`: the traversal
        finds the k-hop seed pool (cached under its typed key like any
        query), the sampler draws the fanout-capped minibatch. Returns
        ``sampler.sample(pool)``: ``(GraphBatch, node_ids)``."""
        pool = self.submit(Query(int(source), kind=QueryKind.KHOP_SAMPLE,
                                 max_depth=int(k)))
        return sampler.sample(pool)

    def warmup(self, reachability: bool = False, targets: bool = False,
               payload: bool = False) -> None:
        """Run each variant once from vertex 0 (builds the kernels on first
        use; nothing lands in the cache or the stats). By default the
        target-free levels variant; ``targets=True`` adds the multi-target
        variant, ``reachability=True`` the levels-free one, ``payload=True``
        the payload one (WEIGHTED_SSSP / COMPONENTS; with ``targets`` also
        the mixed variant carrying both). Refill engines run one sweep and
        one reseed; overlap engines also run one block of each variant's
        refill drains -- on a card that captures its sweep graphs (the
        all-ones watch with only lane 0 seeded freezes the block at
        entry)."""
        cfgs = [_dc_replace(self.cfg, enable_targets=False)]
        if targets:
            cfgs.append(self.cfg)
        if reachability and self.specialize_reachability:
            cfgs.append(_dc_replace(self.cfg, track_levels=False,
                                    enable_targets=False))
        if payload:
            cfgs.append(self._payload_cfg(_dc_replace(self.cfg,
                                                      enable_targets=False)))
            if targets:
                cfgs.append(self._payload_cfg(self.cfg))
        for cfg in cfgs:
            st = self._init([0], cfg)
            if self.refill:
                self._step(cfg, st)
                M.reseed_lanes(st, *self._seed_descriptors(
                    [], payload=cfg.payload), mesh=self.mesh)
                if self.overlap:
                    self._block(cfg, False)(
                        self.pgv, self.plan, st,
                        np.ones(self.cfg.n_queries, dtype=bool)).wait()
            else:
                self._run(cfg, st)


class _KindGather:
    """The result rows of some lanes on their way to the host, by kind:
    payload lanes (``pay[i]``) from the payload plane, the others from the
    level (or reach-only) plane -- one :class:`~repro_torch.core.msbfs.
    LaneGather` per plane in use. :meth:`rows` waits and returns the rows
    in the lanes' order."""

    def __init__(self, pg, state, lanes, pay, mesh):
        lanes, self.pay = np.asarray(lanes), np.asarray(pay, dtype=bool)
        self.bits = (M.LaneGather(pg, state, lanes[~self.pay], mesh)
                     if (~self.pay).any() else None)
        self.vals = (M.LaneGather(pg, state, lanes[self.pay], mesh,
                                  payload=True) if self.pay.any() else None)

    def rows(self) -> list:
        bits = iter(self.bits.rows() if self.bits is not None else ())
        vals = iter(self.vals.rows() if self.vals is not None else ())
        return [next(vals) if p else next(bits) for p in self.pay]
