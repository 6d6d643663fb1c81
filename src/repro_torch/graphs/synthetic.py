"""Synthetic graphs for the serving paths: skewed-depth graphs with tails.

The reference module (``src/repro/graphs/synthetic.py``) also builds the
GNN architectures' data (citation graphs, meshes, molecule batches),
which wait for the GNN port; this module keeps its own copy of
:func:`with_tails`, the graph the lane-refill serving path is built for.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import COOGraph


def with_tails(g: COOGraph, n_tails=4, length=64, seed=0):
    """Attach undirected path chains ("tails") to random non-isolated
    vertices of ``g``.

    The result has ``g.n + n_tails * length`` vertices; a BFS from a tail's
    far end needs ~``length`` extra supersteps, while core sources converge
    in O(log n) -- the skewed depth distribution the lane-refill serving
    path is built for. Returns ``(graph, tips)`` where ``tips`` are the far
    endpoints of the tails. The same seed gives the same edges, tips and
    edge order as the reference package's generator.
    """
    rng = np.random.default_rng(seed)
    deg = g.out_degrees()
    anchors = rng.choice(np.nonzero(deg > 0)[0], size=n_tails, replace=False)
    src, dst, tips = [], [], []
    nv = g.n
    for a in anchors:
        prev = int(a)
        for _ in range(length):
            v = nv
            nv += 1
            src += [prev, v]
            dst += [v, prev]
            prev = v
        tips.append(prev)
    merged = COOGraph(nv, np.concatenate([g.src, np.asarray(src, np.int64)]),
                      np.concatenate([g.dst, np.asarray(dst, np.int64)]))
    return merged, np.asarray(tips, np.int64)
