"""Host-side builders: global graph data -> partitioned per-shard batches
(numpy, the reference package's arrays), and their device views."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine as E
from repro_torch.core.bfs import resolve_device
from repro_torch.core.partition import partition_edge_values
from repro_torch.core.types import PartitionedGraph
from repro_torch.tree import tree_map


def _masks(pg: PartitionedGraph, global_mask: np.ndarray | None):
    dvids = np.asarray(pg.delegate_vids).reshape(-1)[: max(pg.d, 1)]
    if global_mask is None:
        mask_n = np.asarray(pg.normal_valid).copy()
        mask_d = np.ones((dvids.shape[0],), bool) if pg.d else np.zeros((1,), bool)
    else:
        m2 = global_mask[:, None].astype(np.float32)
        mn, md = E.scatter_features(pg, m2)
        mask_n = (mn[..., 0] > 0) & np.asarray(pg.normal_valid)
        mask_d = (md[..., 0] > 0) if pg.d else np.zeros((1,), bool)
    if pg.d:
        # delegate slots are rows of normal_valid == False; keep only real ones
        mask_d = mask_d[: max(pg.d, 1)]
    return mask_n, np.broadcast_to(mask_d, (pg.p,) + mask_d.shape).copy()


def _tiled(x: np.ndarray, p: int) -> np.ndarray:
    return np.broadcast_to(x, (p,) + x.shape).copy()


def gcn_batch(pg: PartitionedGraph, feats, labels, train_mask) -> dict:
    """Node classification: ``x_n [p, nl, F]``, ``x_d`` tiled to ``[p, d,
    F]`` (every partition holds the replicated delegates), labels and
    train masks likewise."""
    x_n, x_d = E.scatter_features(pg, feats)
    y_n, y_d = E.scatter_features(pg, labels[:, None].astype(np.int32))
    mask_n, mask_d = _masks(pg, train_mask)
    p = pg.p
    return {
        "x_n": x_n, "x_d": _tiled(x_d, p),
        "y_n": y_n[..., 0], "y_d": _tiled(y_d[..., 0], p),
        "mask_n": mask_n, "mask_d": mask_d,
    }


def mgn_batch(pg: PartitionedGraph, node_feats, edge_feats, targets,
              residual=False) -> dict:
    """Node regression with edge features: as :func:`gcn_batch`, plus
    ``ef`` (per subgraph ``[p, E_max, Fe]``, padding edges zero)."""
    x_n, x_d = E.scatter_features(pg, node_feats)
    y_n, y_d = E.scatter_features(pg, targets)
    ef = partition_edge_values(pg, edge_feats)
    mask_n, mask_d = _masks(pg, None)
    p = pg.p
    return {
        "x_n": x_n, "x_d": _tiled(x_d, p),
        "y_n": y_n, "y_d": _tiled(y_d, p),
        "ef": ef, "mask_n": mask_n, "mask_d": mask_d,
    }


def mace_batch(pg: PartitionedGraph, positions, species,
               target_energy: float) -> dict:
    """Atoms over the partition: positions ``pos_n [p, nl, 3]`` / ``pos_d``
    tiled to ``[p, d, 3]``, species likewise, the node masks, and the
    total energy target ``[p]`` (the same on every partition)."""
    pos_n, pos_d = E.scatter_features(pg, positions)
    spec_n, spec_d = E.scatter_features(pg, species[:, None].astype(np.int32))
    mask_n, mask_d = _masks(pg, None)
    p = pg.p
    return {
        "pos_n": pos_n, "pos_d": _tiled(pos_d, p),
        "spec_n": spec_n[..., 0], "spec_d": _tiled(spec_d[..., 0], p),
        "mask_n": mask_n, "mask_d": mask_d,
        "target_energy": np.full((p,), target_energy, np.float32),
    }


def batch_to_device(batch: dict, device, part: int | None = None) -> dict:
    """Every array of a batch as a tensor on ``device``; ``part`` keeps
    only that partition's row (what one rank of a mesh holds)."""
    device = resolve_device(device)
    pick = (lambda a: a) if part is None else (lambda a: a[part:part + 1])
    return tree_map(lambda a: torch.as_tensor(pick(np.asarray(a))).to(device),
                    batch)
