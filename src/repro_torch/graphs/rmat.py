"""Graph500-conforming RMAT generator (paper Section VI-A3).

Parameters A,B,C,D = 0.57, 0.19, 0.19, 0.05, edge factor 16; vertex ids are
randomized with a deterministic permutation after edge generation; the graph
is made undirected by edge doubling. The same seeds give the same edges as
the reference package's generator, bit for bit (numpy's ``default_rng``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import COOGraph

RMAT_A, RMAT_B, RMAT_C, RMAT_D = 0.57, 0.19, 0.19, 0.05
EDGE_FACTOR = 16


def rmat_edges(
    scale: int,
    edge_factor: int = EDGE_FACTOR,
    seed: int = 0,
    a: float = RMAT_A,
    b: float = RMAT_B,
    c: float = RMAT_C,
    d: float = RMAT_D,
) -> COOGraph:
    """Directed RMAT edge list with 2**scale vertices, hashed vertex ids."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    p_src1 = c + d                      # P(src bit = 1)
    p_dst1_s0 = b / (a + b)             # P(dst bit = 1 | src bit = 0)
    p_dst1_s1 = d / (c + d)             # P(dst bit = 1 | src bit = 1)
    for level in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        sbit = (r1 < p_src1).astype(np.int64)
        pd = np.where(sbit == 1, p_dst1_s1, p_dst1_s0)
        dbit = (r2 < pd).astype(np.int64)
        src |= sbit << level
        dst |= dbit << level
    # deterministic vertex randomization (the paper hashes vertex numbers)
    perm = np.random.default_rng(seed ^ 0x5EED5EED).permutation(n).astype(np.int64)
    return COOGraph(n, perm[src], perm[dst])


def rmat_graph(scale: int, edge_factor: int = EDGE_FACTOR, seed: int = 0) -> COOGraph:
    """Undirected (edge-doubled), self-loop-free RMAT graph."""
    g = rmat_edges(scale, edge_factor, seed)
    return g.without_self_loops().symmetrized()


def pick_sources(g: COOGraph, count: int, seed: int = 1) -> np.ndarray:
    """Random non-isolated source vertices (Graph500 sampling rule)."""
    deg = g.out_degrees()
    candidates = np.nonzero(deg > 0)[0]
    rng = np.random.default_rng(seed)
    return rng.choice(candidates, size=min(count, candidates.size), replace=False)
