"""Pure-numpy BFS oracle used to validate the device implementation.

Frontier expansion is vectorized (one ``np.repeat`` range gather per
level), so it stays usable on graphs of millions of vertices; callers
checking many sources on one graph pass the CSR from :func:`csr_from_coo`
once instead of rebuilding it per query. The payload kinds' oracles
(:func:`dijkstra_levels`, :func:`component_labels`) follow the reference's
semantics: Dijkstra over the synthetic edge weights of
:mod:`~repro_torch.core.weights`, and each component labelled with its
minimum vertex id; ``INF_LEVEL`` where a vertex is unreached.
"""
from __future__ import annotations

import numpy as np

from .types import COOGraph, INF_LEVEL
from .weights import edge_weights


def csr_from_coo(g: COOGraph):
    order = np.argsort(g.src, kind="stable")
    dst = g.dst[order]
    offsets = np.zeros(g.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(g.src, minlength=g.n), out=offsets[1:])
    return offsets, dst


def bfs_levels(g: COOGraph, source: int, csr=None) -> np.ndarray:
    """Frontier BFS over CSR; returns hop distances (INF_LEVEL = unreached)."""
    offsets, dst = csr if csr is not None else csr_from_coo(g)
    levels = np.full(g.n, INF_LEVEL, dtype=np.int32)
    levels[source] = 0
    frontier = np.array([source], dtype=np.int64)
    depth = 0
    while frontier.size:
        starts = offsets[frontier]
        counts = offsets[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            break
        # every frontier vertex's adjacency range, concatenated
        run_base = np.repeat(starts - (np.cumsum(counts) - counts), counts)
        out = dst[run_base + np.arange(total, dtype=np.int64)]
        cand = np.unique(out)
        new = cand[levels[cand] == INF_LEVEL]
        depth += 1
        levels[new] = depth
        frontier = new
    return levels


def reachable_mask(g: COOGraph, source: int, csr=None) -> np.ndarray:
    """Reachability reference: bool [n], True where BFS from ``source``
    arrives (the REACHABILITY query kind's oracle)."""
    return bfs_levels(g, source, csr) != INF_LEVEL


def bfs_levels_limited(g: COOGraph, source: int, max_depth: int,
                       csr=None) -> np.ndarray:
    """Distance-limited reference: hop distances up to ``max_depth``,
    INF_LEVEL beyond (the DISTANCE_LIMITED query kind's oracle)."""
    levels = bfs_levels(g, source, csr)
    return np.where(levels <= max_depth, levels, INF_LEVEL).astype(np.int32)


def target_depths(g: COOGraph, source: int, targets, csr=None) -> dict:
    """Multi-target reference: {target: hop depth} with INF_LEVEL for
    unreached targets (the MULTI_TARGET query kind's oracle)."""
    levels = bfs_levels(g, source, csr)
    return {int(t): int(levels[int(t)]) for t in targets}


def traversed_edges(g: COOGraph, levels: np.ndarray) -> int:
    """Edges in the connected component of the source (for TEPS, counted on
    the undirected graph as m_component / 2)."""
    reached = levels[g.src] != INF_LEVEL
    return int(reached.sum()) // 2


def dijkstra_levels(g: COOGraph, source: int, csr=None) -> np.ndarray:
    """Weighted-SSSP reference: Dijkstra over the synthetic symmetric edge
    weights; int32 distances, INF_LEVEL where unreached (the
    WEIGHTED_SSSP oracle)."""
    import heapq

    offsets, dst = csr if csr is not None else csr_from_coo(g)
    src_ids = np.repeat(np.arange(g.n, dtype=np.int64), np.diff(offsets))
    wts = edge_weights(src_ids, dst)
    dist = np.full(g.n, INF_LEVEL, dtype=np.int32)
    dist[source] = 0
    heap = [(0, int(source))]
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist[v]:
            continue
        for e in range(offsets[v], offsets[v + 1]):
            u, nd = int(dst[e]), d + int(wts[e])
            if nd < dist[u]:
                dist[u] = nd
                heapq.heappush(heap, (nd, u))
    return dist


def component_labels(g: COOGraph) -> np.ndarray:
    """Connected components: int32 ``[n]``, each vertex labelled with the
    minimum vertex id of its component (the label min-label propagation
    converges to; the COMPONENTS oracle). Vectorized min-label
    propagation with pointer jumping: every round takes each vertex's
    minimum over its edges, then follows labels to their fixed point."""
    label = np.arange(g.n, dtype=np.int64)
    src, dst = np.asarray(g.src, np.int64), np.asarray(g.dst, np.int64)
    while True:
        nxt = label.copy()
        np.minimum.at(nxt, src, label[dst])
        np.minimum.at(nxt, dst, label[src])
        while True:                          # jump: label[v] -> label[label[v]]
            jumped = nxt[nxt]
            if np.array_equal(jumped, nxt):
                break
            nxt = jumped
        if np.array_equal(nxt, label):
            return label.astype(np.int32)
        label = nxt


def component_mask(g: COOGraph, source: int) -> np.ndarray:
    """Bool ``[n]``: the source's connected component."""
    labels = component_labels(g)
    return labels == labels[int(source)]


def khop_nodes(g: COOGraph, source: int, k: int, csr=None) -> np.ndarray:
    """Sorted node ids within ``k`` hops of ``source`` (the KHOP_SAMPLE
    oracle; the set the neighbor sampler's seed batch is drawn from)."""
    levels = bfs_levels(g, source, csr)
    return np.nonzero(levels <= min(int(k), int(INF_LEVEL) - 1))[0].astype(
        np.int64)
