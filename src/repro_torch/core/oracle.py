"""Pure-numpy BFS oracle used to validate the device implementation.

Frontier expansion is vectorized (one ``np.repeat`` range gather per
level), so it stays usable on graphs of millions of vertices; callers
checking many sources on one graph pass the CSR from :func:`csr_from_coo`
once instead of rebuilding it per query.
"""
from __future__ import annotations

import numpy as np

from .types import COOGraph, INF_LEVEL


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
