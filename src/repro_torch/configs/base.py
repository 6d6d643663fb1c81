"""Architecture registry: every ported architecture is an ``ArchSpec``
with a full-scale model config (or a factory of one per shape), a reduced
smoke config, its shape set, its sharding-rule overrides and its
optimizer -- the port's copy of ``repro.configs.base``. A rule override
names the mesh axes a logical axis is sharded over, as the reference's
does (``xdeepfm``: ``{"table_rows": ("data", "model")}``); the port
shards the recsys cold rows over every rank of its mesh
(:mod:`repro_torch.train.recsys`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


# canonical shape sets ---------------------------------------------------
LM_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(kind="dist_full", n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(kind="minibatch", n_parent_nodes=232965,
                         n_parent_edges=114615892, batch_nodes=1024,
                         fanouts=(15, 10)),
    "ogb_products": dict(kind="dist_full", n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": dict(kind="batched_small", n_nodes=30, n_edges=64, batch=128),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1000000),
}

BFS_SHAPES = {
    # weak-scaling flagship: ~scale-26 RMAT per device (paper Fig. 9)
    "rmat_weak": dict(kind="bfs", scale_per_device=25),
    "rmat_s30": dict(kind="bfs", scale=30),
}


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                     # lm | gnn | recsys | bfs
    model: Any                      # full-scale model config (or factory)
    smoke: Any                      # reduced config for CPU smoke tests
    shapes: dict
    skip: dict = field(default_factory=dict)   # shape -> reason
    rules_override: dict = field(default_factory=dict)
    optimizer: str = "adamw"
    grad_accum: dict = field(default_factory=dict)  # shape -> accum factor
    notes: str = ""


_REGISTRY: dict = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    _load_all()
    return _REGISTRY[name]


def all_archs() -> list:
    _load_all()
    return sorted(_REGISTRY)


def _load_all():
    """Register every config module (imports are idempotent, so a config
    imported on its own first does not hide the others)."""
    from repro_torch.configs import (  # noqa: F401
        bfs_rmat, gcn_cora, gemma3_1b, granite_34b, graphcast, kimi_k2_1t_a32b,
        mace, meshgraphnet, qwen2_5_14b, qwen2_moe_a2_7b, xdeepfm,
    )
