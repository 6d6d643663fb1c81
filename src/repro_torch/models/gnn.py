"""The graph minibatch container of the GNN stack.

Only :class:`GraphBatch` is here so far: the static-shape batch the
neighbor sampler (:mod:`repro_torch.graphs.sampler`) fills. Its fields are
plain numpy arrays, as the sampler makes them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class GraphBatch:
    """Static-shape graph container (padded)."""

    nodes: Any            # [N, F] f32
    senders: Any          # [E] int32 (padding = N)
    receivers: Any        # [E] int32 (padding = N)
    edge_feats: Any = None   # [E, Fe] f32 or None
    node_mask: Any = None    # [N] bool
    edge_mask: Any = None    # [E] bool
    graph_ids: Any = None    # [N] int32 for batched small graphs
    n_graphs: int = 1
    positions: Any = None    # [N, 3] for geometric models
    species: Any = None      # [N] int32 for atomic models
