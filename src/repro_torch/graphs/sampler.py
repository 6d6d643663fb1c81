"""Neighbor sampler for sampled-minibatch GNN training (GraphSAGE-style).

Host-side numpy: k-hop uniform sampling with per-hop fanouts over a CSR
graph, renumbering the union into a static-capacity ``GraphBatch``. The
fanout caps bound the per-vertex work of the hot (high-degree) vertices,
as the degree threshold TH does in the traversal. The random draws are
the reference sampler's, call for call, so one seed gives one batch.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.oracle import csr_from_coo
from repro_torch.core.types import COOGraph
from repro_torch.models.gnn import GraphBatch


class NeighborSampler:
    def __init__(self, g: COOGraph, fanouts=(15, 10), seed: int = 0):
        self.g = g
        self.offsets, self.cols = csr_from_coo(g)
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def capacities(self, batch_nodes: int):
        """``(node_cap, edge_cap)`` of a batch grown from ``batch_nodes``
        seeds: every hop at its full fanout."""
        n_cap, e_cap = batch_nodes, 0
        layer = batch_nodes
        for f in self.fanouts:
            e_cap += layer * f
            layer = layer * f
            n_cap += layer
        return n_cap, e_cap

    def sample(self, seeds: np.ndarray, features: np.ndarray | None = None):
        """Sample the fanout-capped k-hop neighborhood of ``seeds``:
        ``(GraphBatch, node_ids)``, node ``i`` of the batch being vertex
        ``node_ids[i]`` (the seeds first, in order); message edges point
        from the sampled neighbor to the vertex that drew it."""
        node_cap, edge_cap = self.capacities(len(seeds))
        frontier = np.asarray(seeds, np.int64)
        nodes = list(frontier)
        node_pos = {int(v): i for i, v in enumerate(frontier)}
        s_out, r_out = [], []
        for f in self.fanouts:
            nxt = []
            for v in frontier:
                deg = self.offsets[v + 1] - self.offsets[v]
                if deg == 0:
                    continue
                take = min(f, int(deg))
                sel = self.rng.choice(int(deg), take, replace=False)
                for u in self.cols[self.offsets[v] + sel]:
                    ui = int(u)
                    if ui not in node_pos:
                        node_pos[ui] = len(nodes)
                        nodes.append(ui)
                        nxt.append(ui)
                    s_out.append(node_pos[ui])
                    r_out.append(node_pos[int(v)])
            frontier = np.array(nxt, np.int64)
        n, e = len(nodes), len(s_out)
        if n > node_cap or e > edge_cap:
            raise RuntimeError(f"sample outgrew its capacity: {n} > "
                               f"{node_cap} nodes or {e} > {edge_cap} edges")
        senders = np.full(edge_cap, node_cap, np.int32)
        receivers = np.full(edge_cap, node_cap, np.int32)
        senders[:e] = s_out
        receivers[:e] = r_out
        node_ids = np.array(nodes, np.int64)
        if features is not None:
            feats = np.zeros((node_cap, features.shape[1]), features.dtype)
            feats[:n] = features[node_ids]
        else:
            feats = np.zeros((node_cap, 1), np.float32)
        node_mask = np.zeros(node_cap, bool)
        node_mask[:n] = True
        return GraphBatch(nodes=feats, senders=senders, receivers=receivers,
                          node_mask=node_mask,
                          edge_mask=senders < node_cap), node_ids
