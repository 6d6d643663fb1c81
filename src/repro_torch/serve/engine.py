"""msBFS serving engine, batch mode: typed query queue -> lane batches ->
results.

One ``BFSServeEngine`` owns a partitioned graph and its static exchange
plan on one device, with the partitions emulated on the stacked leading
axis. ``submit`` answers typed :class:`~repro_torch.serve.queries.Query`
descriptors -- full levels, reachability masks, distance-limited levels,
multi-target depths -- and ``query`` stays as the classic full-levels
sugar. Cache hits and already-mapped components are answered without a
traversal; misses are packed into W-lane batches (kinds mix freely),
traversed by :func:`repro_torch.core.msbfs.run_msbfs_emulated`, unpacked
per kind and cached under ``(graph_id, kind, params, source)`` keys that
equal the reference package's.

A batch that is homogeneously ``REACHABILITY`` runs the levels-free
variant (``track_levels=False``); a batch without a ``MULTI_TARGET`` lane
drops the target scan (``enable_targets=False``).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, fields as _dc_fields, \
    replace as _dc_replace

import numpy as np

from repro_torch.core import bfs as B, comm as C, engine as E, msbfs as M
from repro_torch.core.partition import partition_graph
from repro_torch.core.types import COOGraph, PartitionLayout, PartitionedGraph

from .cache import LRUCache
from .queries import DEFERRED_KINDS, Query, QueryKind, as_query, unpack_result


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
    whole). In batch mode each batch accounts a full lane word:
    ``lanes_used + lanes_padded == batches * n_queries``; the refill,
    pipeline and payload counters stay 0 in this slice."""

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

    def note_traversal(self, state) -> None:
        """Fold one finished traversal state's comm counters in."""
        self.wire_delegate_bytes += int(state.wire_delegate.sum())
        self.wire_nn_bytes += int(state.wire_nn.sum())
        self.wire_pay_delegate_bytes += int(state.wire_pay_delegate.sum())
        self.wire_pay_nn_bytes += int(state.wire_pay_nn.sum())
        # the format flag is a global decision (replicated): row 0 only;
        # overflow is per-device send-side drops: sum every partition
        self.nn_sparse_sweeps += int(state.nn_sparse[0].sum())
        self.nn_overflow += int(state.nn_overflow.sum())

    def as_dict(self) -> dict:
        """Every counter field plus the derived ``wire_bytes_total``."""
        out = {f.name: (dict(v) if isinstance(v := getattr(self, f.name),
                                              dict) else v)
               for f in _dc_fields(self)}
        out["wire_bytes_total"] = self.wire_bytes_total
        return out


class BFSServeEngine:
    """Serve typed traversal queries from batched msBFS sweeps.

    Parameters
    ----------
    graph / pg : the raw ``COOGraph`` (partitioned here with ``th`` /
        ``p_rank`` / ``p_gpu``) or an already-partitioned host graph.
    cfg : msBFS config; ``cfg.n_queries`` is the lane width W.
    comm : communication strategies (sugar for a cfg with ``comm=`` set).
    cache_capacity / cache_ttl : LRU entries (0 disables) and default
        per-entry time-to-live in seconds (None = never expires).
    graph_id : cache key namespace; defaults to :func:`default_graph_id`.
    specialize_reachability : run homogeneous REACHABILITY batches on the
        levels-free variant.
    reuse_components : memoize reachability answers per connected
        component (valid on undirected graphs, which every RMAT graph
        here is); later REACHABILITY queries from a mapped component are
        answered without a traversal (``stats.component_hits``).
    device : where the partition lives and the sweeps run (default
        ``"cuda"``; raises without a card -- pass ``"cpu"`` for the plain
        PyTorch path).
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
        specialize_reachability: bool = True,
        reuse_components: bool = True,
        device="cuda",
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
        if not self.cfg.track_levels or not self.cfg.enable_targets:
            raise ValueError(
                "pass a track_levels=True, enable_targets=True cfg; the "
                "engine derives the specialized per-batch variants itself")
        self.specialize_reachability = bool(specialize_reachability)
        self.reuse_components = bool(reuse_components)
        self._comp_id = np.full(pg.n, -1, dtype=np.int32)
        self._comp_masks: dict[int, np.ndarray] = {}
        self.pgv = B.device_view(pg, self.device)
        self.plan = E.device_plan(E.build_exchange_plan(pg), self.device)
        self.graph_id = graph_id if graph_id is not None else default_graph_id(pg)
        self.cache = LRUCache(cache_capacity, ttl=cache_ttl)
        self.stats = ServeStats()
        #: sweeps of every traversal run (batch mode keeps ``stats.sweeps``
        #: at 0, as the reference does)
        self.traversal_sweeps = 0
        self._layout = PartitionLayout(pg.n, pg.p_rank, pg.p_gpu)
        self._dvids = np.asarray(pg.delegate_vids).reshape(-1)[: pg.d]

    # -- per-batch variants -------------------------------------------------
    def _reach_fast(self, queries) -> bool:
        return (self.specialize_reachability
                and all(q.kind is QueryKind.REACHABILITY for q in queries))

    def _batch_cfg(self, queries) -> M.MSBFSConfig:
        """The msBFS variant this batch runs."""
        if self._reach_fast(queries):
            return _dc_replace(self.cfg, track_levels=False,
                               enable_targets=False)
        if any(q.kind is QueryKind.MULTI_TARGET for q in queries):
            return self.cfg
        return _dc_replace(self.cfg, enable_targets=False)

    def _gather_rows(self, reach_fast: bool, state, lanes) -> np.ndarray:
        if reach_fast:
            return M.gather_reachable_multi(self.pg, state, lanes=lanes)
        return M.gather_levels_multi(self.pg, state, lanes=lanes)

    def _validate_queries(self, queries) -> None:
        """Reject deferred kinds and range-check every source and target
        before any lane is seeded."""
        for q in queries:
            if q.kind in DEFERRED_KINDS:
                raise NotImplementedError(
                    f"{q.kind.value} queries are not ported yet: ROADMAP.md "
                    "queue A, item A9 (payload plane and KHOP_SAMPLE)")
        ids = [q.source for q in queries]
        for q in queries:
            ids.extend(q.targets or ())
        M.validate_sources(self.pg, ids)

    # -- per-component reuse (reachability masks) ---------------------------
    def _component_of(self, q: Query):
        """The memoized reachable mask covering ``q``'s source, or None."""
        if not self.reuse_components or q.kind is not QueryKind.REACHABILITY:
            return None
        cid = self._comp_id[q.source]
        return self._comp_masks[cid] if cid >= 0 else None

    def _register_component(self, q: Query, result) -> None:
        """Record a served reachability mask as its source's component."""
        if (self.reuse_components and q.kind is QueryKind.REACHABILITY
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
        cfg = self._batch_cfg(queries)
        st = M.init_multi_state(
            self.pg, [q.source for q in queries], cfg,
            depth_caps=[q.depth_cap for q in queries],
            targets=[q.targets for q in queries], device=self.device)
        out = M.run_msbfs_emulated(self.pgv, self.plan, st, cfg)
        rows = self._gather_rows(reach_fast, out, np.arange(len(queries)))
        self.traversal_sweeps += int(out.it[0])
        if reach_fast:
            self.stats.reach_fast_batches += 1
        stops = out.lane_stop[0].cpu().numpy()
        self.stats.batches += 1
        self.stats.lanes_used += len(queries)
        self.stats.lanes_padded += w - len(queries)
        self.stats.note_traversal(out)
        for i, q in enumerate(queries):
            if stops[i]:
                self.stats.note_early_stop(q.kind)
        return {q: unpack_result(q, rows[i], packed_reach=reach_fast)
                for i, q in enumerate(queries)}

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

    def warmup(self, reachability: bool = False, targets: bool = False) -> None:
        """Run each batch variant once from vertex 0 (builds the kernels on
        first use; nothing lands in the cache or the stats). By default the
        target-free levels variant; ``targets=True`` adds the multi-target
        variant, ``reachability=True`` the levels-free one."""
        cfgs = [_dc_replace(self.cfg, enable_targets=False)]
        if targets:
            cfgs.append(self.cfg)
        if reachability and self.specialize_reachability:
            cfgs.append(_dc_replace(self.cfg, track_levels=False,
                                    enable_targets=False))
        for cfg in cfgs:
            st = M.init_multi_state(self.pg, [0], cfg, device=self.device)
            M.run_msbfs_emulated(self.pgv, self.plan, st, cfg)
