"""Synthetic graphs and data: skewed-depth graphs with tails for the
serving paths, and the GNN architectures' data (cora-like citation graphs,
triangulated meshes with multimesh hub levels).

Host numpy generators: the same seed gives the same arrays, bit for bit,
as the reference package's (``src/repro/graphs/synthetic.py``), the
equivariant model's molecule batches included.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import COOGraph
from repro_torch.models.gnn import GraphBatch


def cora_like(n=512, avg_deg=4, d_feat=64, n_classes=7, seed=0):
    """Power-law-ish citation graph + bag-of-words features + labels."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg
    # preferential-attachment-flavored edge endpoints
    pop = (rng.pareto(1.5, n) + 1)
    pop /= pop.sum()
    src = rng.choice(n, m, p=pop)
    dst = rng.integers(0, n, m)
    g = COOGraph(n, src.astype(np.int64),
                 dst.astype(np.int64)).without_self_loops().symmetrized().deduped()
    feats = (rng.random((n, d_feat)) < 0.05).astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    train_mask = rng.random(n) < 0.5
    return g, feats, labels, train_mask


def with_tails(g: COOGraph, n_tails=4, length=64, seed=0):
    """Attach undirected path chains ("tails") to random non-isolated
    vertices of ``g``.

    The result has ``g.n + n_tails * length`` vertices; a BFS from a tail's
    far end needs ~``length`` extra supersteps, while core sources converge
    in O(log n) -- the skewed depth distribution the lane-refill serving
    path is built for. Returns ``(graph, tips)`` where ``tips`` are the far
    endpoints of the tails.
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


def grid_mesh(rows=16, cols=16, multimesh_levels=0, seed=0):
    """Triangulated 2D grid mesh; multimesh_levels > 0 adds coarse skip edges
    (GraphCast-style hierarchy -- the coarse hubs become delegates)."""
    idx = lambda r, c: r * cols + c
    edges = []
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                edges.append((idx(r, c), idx(r, c + 1)))
            if r + 1 < rows:
                edges.append((idx(r, c), idx(r + 1, c)))
            if r + 1 < rows and c + 1 < cols:
                edges.append((idx(r, c), idx(r + 1, c + 1)))
    for lvl in range(1, multimesh_levels + 1):
        step = 2 ** lvl
        for r in range(0, rows, step):
            for c in range(0, cols, step):
                if c + step < cols:
                    edges.append((idx(r, c), idx(r, c + step)))
                if r + step < rows:
                    edges.append((idx(r, c), idx(r + step, c)))
    e = np.array(edges, np.int64)
    g = COOGraph(rows * cols, e[:, 0], e[:, 1]).symmetrized().deduped()
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    pos = np.stack([rr.reshape(-1) / rows, cc.reshape(-1) / cols],
                   -1).astype(np.float32)
    return g, pos


def mesh_batch(rows, cols, d_node_in, d_edge_in, multimesh_levels=0,
               seed=0) -> GraphBatch:
    """A :func:`grid_mesh` as a :class:`GraphBatch` of numpy arrays: random
    node features, edge features ``[rel_pos (2), |rel_pos|, noise...]``
    cut to ``d_edge_in``."""
    g, pos = grid_mesh(rows, cols, multimesh_levels, seed)
    rng = np.random.default_rng(seed)
    n, e = g.n, g.m
    rel = pos[g.dst] - pos[g.src]
    dist = np.linalg.norm(rel, axis=1, keepdims=True)
    ef = np.concatenate([rel, dist, rng.normal(size=(e, max(d_edge_in - 3, 0)))],
                        1)[:, :d_edge_in]
    return GraphBatch(
        nodes=rng.normal(size=(n, d_node_in)).astype(np.float32),
        senders=g.src.astype(np.int32), receivers=g.dst.astype(np.int32),
        edge_feats=ef.astype(np.float32),
        node_mask=np.ones(n, bool), edge_mask=np.ones(e, bool),
    )


def molecule_batch(n_mol=8, n_atoms=30, n_edges_per=64, n_species=10,
                   seed=0) -> tuple:
    """Batched random-geometric molecules: ``(GraphBatch, energies
    [n_mol])``. Atoms closer than 3.0 are bonded both ways, at most
    ``n_edges_per`` bonds a molecule (drawn); edges are padded to
    ``n_mol * n_edges_per`` with sender and receiver ``N``."""
    rng = np.random.default_rng(seed)
    N = n_mol * n_atoms
    pos = np.zeros((N, 3), np.float32)
    senders, receivers, gids = [], [], []
    for g_i in range(n_mol):
        base = g_i * n_atoms
        p = rng.normal(size=(n_atoms, 3)).astype(np.float32) * 2.0
        pos[base: base + n_atoms] = p
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        cand = np.argwhere(d < 3.0)
        if cand.shape[0] > n_edges_per:
            cand = cand[rng.choice(cand.shape[0], n_edges_per, replace=False)]
        senders.append(cand[:, 0] + base)
        receivers.append(cand[:, 1] + base)
        gids.extend([g_i] * n_atoms)
    s = np.concatenate(senders).astype(np.int32)
    r = np.concatenate(receivers).astype(np.int32)
    e_max = n_mol * n_edges_per
    pad = e_max - s.shape[0]
    s = np.concatenate([s, np.full(pad, N, np.int32)])
    r = np.concatenate([r, np.full(pad, N, np.int32)])
    species = rng.integers(0, n_species, N).astype(np.int32)
    batch = GraphBatch(
        nodes=np.zeros((N, 1), np.float32),
        senders=s, receivers=r,
        node_mask=np.ones(N, bool), edge_mask=s < N,
        graph_ids=np.array(gids, np.int32), n_graphs=n_mol,
        positions=pos, species=species,
    )
    energies = rng.normal(size=(n_mol,)).astype(np.float32)
    return batch, energies
