"""Shape synthesis for the dry run's graph cells -- the port of
``repro.launch.synth``: one rank's blocks of a partitioned graph, its
exchange plan, edge weights, GNN batch and BFS state, with the static
sizes the reference derives from ``(n, e, p)`` and the paper's measured
fractions (Fig. 5 at the suggested TH): delegates ~2% of n (capped by the
4n/p rule), nn edges ~10%, nd = dn ~28% each, dd ~34%, an allowance of 5%
for imbalance.

Where the reference makes ``ShapeDtypeStruct``s stacked ``[p, ...]`` and
sharded over the partition axes, this makes the rank's ``[1, ...]`` block
of each leaf in the port's device-view layout (``core.bfs.device_view``,
``core.engine.device_plan``) with ``torch.zeros``: called under
``FakeTensorMode`` (``launch.dryrun``) nothing is allocated, which is the
point -- a scale-33 graph does not fit a host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bfs import BFSConfig, BFSState
from repro_torch.core.engine import EdgeWeights, ExchangePlan
from repro_torch.core.types import CSR, PartitionedGraph


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def synth_sizes(n: int, e: int, p: int, d_frac: float = 0.02,
                nn_frac: float = 0.10, imbalance: float = 1.05) -> dict:
    """The static sizes of one rank's partition: delegates ``d``, normal
    slots ``n_local``, edge slots ``e_nn``, ``e_nd`` (= ``e_dn``),
    ``e_dd``, and the exchange plan's ``cap_total`` / ``cap_peer``."""
    d = max(int(n * d_frac), 8)
    d = min(d, 4 * _ceil_div(n, p) if p > 1 else d)   # paper's 4n/p rule
    e_nn = max(int(e * nn_frac / p * imbalance), 8)
    cap_peer = max(_ceil_div(e_nn, p) * 2, 8)
    return {"d": d, "n_local": _ceil_div(n, p), "e_nn": e_nn,
            "e_nd": max(int(e * 0.28 / p * imbalance), 8),
            "e_dd": max(int(e * 0.34 / p * imbalance), 8),
            "cap_total": e_nn,               # worst case: every nn dst unique
            "cap_peer": _ceil_div(cap_peer, 32) * 32}


def synth_partitioned_graph(n: int, e: int, p: int, device="cpu",
                            d_frac: float = 0.02, nn_frac: float = 0.10,
                            imbalance: float = 1.05) -> tuple:
    """``(pg, plan, weights)``: a rank's device views of a partitioned
    graph of ``n`` vertices and ``e`` directed edges over ``p`` ranks,
    zeros of the right shapes."""
    z = _zeros(device)
    sz = synth_sizes(n, e, p, d_frac, nn_frac, imbalance)
    d, nl = sz["d"], sz["n_local"]

    def csr(n_rows: int, e_max: int) -> CSR:
        return CSR(offsets=z((1, n_rows + 1), torch.int32),
                   cols=z((1, e_max), torch.int32),
                   rowids=z((1, e_max), torch.int32), m=z((1,), torch.int32),
                   eidx=None, n_rows=n_rows, e_max=e_max,
                   flat_rows=z((e_max,), torch.int64),
                   flat_cols=z((e_max,), torch.int64))

    pg = PartitionedGraph(
        n=n, p=p, p_rank=p, p_gpu=1, d=d, n_local=nl, th=64,
        nn=csr(nl, sz["e_nn"]), nn_owner=z((1, sz["e_nn"]), torch.int32),
        nd=csr(nl, sz["e_nd"]), dn=csr(d, sz["e_nd"]), dd=csr(d, sz["e_dd"]),
        delegate_vids=z((1, d), torch.int32),
        normal_valid=z((1, nl), torch.bool),
        nd_src_mask=z((1, nl), torch.bool),
        dn_src_mask=z((1, d), torch.bool), dd_src_mask=z((1, d), torch.bool))
    ct, cp = sz["cap_total"], sz["cap_peer"]
    plan = ExchangePlan(
        perm=z((1, sz["e_nn"]), torch.int32),
        seg_ids=z((1, sz["e_nn"]), torch.int32),
        seg_owner=z((1, ct), torch.int32), seg_pos=z((1, ct), torch.int32),
        seg_local=z((1, ct), torch.int32),
        recv_local=z((1, p, cp), torch.int32), cap_peer=cp, cap_total=ct,
        flat_seg=z((sz["e_nn"],), torch.int64))
    weights = EdgeWeights(nn=z((1, sz["e_nn"]), torch.float32),
                          nd=z((1, sz["e_nd"]), torch.float32),
                          dn=z((1, sz["e_nd"]), torch.float32),
                          dd=z((1, sz["e_dd"]), torch.float32))
    return pg, plan, weights


def synth_bfs_state(pg: PartitionedGraph, cfg: BFSConfig,
                    device="cpu") -> BFSState:
    """A rank's BFS state leaves for ``pg`` (``core.bfs.init_state``'s
    shapes and dtypes)."""
    z = _zeros(device)
    mi = cfg.max_iters
    tmi = mi if cfg.telemetry else 0
    i32 = lambda *s: z((1,) + s, torch.int32)
    # the sweep loop's step and flag from numpy: real in the dry run, so
    # its first check reads them (one sweep runs; launch.dryrun)
    real = lambda a: torch.from_numpy(a).to(device)
    return BFSState(
        level_n=i32(pg.n_local), level_d=i32(max(pg.d, 1)),
        backward=z((1, 3), torch.bool), it=real(np.zeros(1, np.int32)),
        done=real(np.zeros(1, np.bool_)),
        work_fwd=i32(mi), work_bwd=i32(mi), nn_sent=i32(mi),
        nn_overflow=i32(mi), delegate_round=i32(mi), wire_delegate=i32(mi),
        wire_nn=i32(mi), nn_sparse=i32(mi), tm_frontier_n=i32(tmi),
        tm_frontier_d=i32(tmi), tm_backward=i32(tmi))


def synth_gnn_batch(model: str, cfg, pg: PartitionedGraph, d_feat: int,
                    device="cpu") -> dict:
    """A rank's batch of a ``dist_full`` GNN cell (``train.gnn_batches``'
    leaves): ``model`` is ``"gcn"``, ``"mgn"`` (``cfg`` an MGN or
    GraphCast config) or ``"mace"``."""
    z = _zeros(device)
    nl, d = pg.n_local, max(pg.d, 1)
    masks = {"mask_n": z((1, nl), torch.bool), "mask_d": z((1, d), torch.bool)}
    f32, i32 = torch.float32, torch.int32
    if model == "gcn":
        return {"x_n": z((1, nl, d_feat), f32), "x_d": z((1, d, d_feat), f32),
                "y_n": z((1, nl), i32), "y_d": z((1, d), i32), **masks}
    if model == "mgn":
        d_in = getattr(cfg, "n_vars", None) or cfg.d_node_in
        d_out = getattr(cfg, "n_vars", None) or cfg.d_out
        ef = {k: z((1, pg.subgraph(k).e_max, cfg.d_edge_in), f32)
              for k in ("nn", "nd", "dn", "dd")}
        return {"x_n": z((1, nl, d_in), f32), "x_d": z((1, d, d_in), f32),
                "y_n": z((1, nl, d_out), f32), "y_d": z((1, d, d_out), f32),
                "ef": ef, **masks}
    if model == "mace":
        return {"pos_n": z((1, nl, 3), f32), "pos_d": z((1, d, 3), f32),
                "spec_n": z((1, nl), i32), "spec_d": z((1, d), i32),
                "target_energy": z((1,), f32), **masks}
    raise ValueError(model)


def _zeros(device):
    return lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
