"""GNN architectures over segment-sum message passing.

Local (one-device) message passing is an ``index_add`` over an edge-index
-> node scatter. The distributed full-graph path runs the same layers with
the aggregation swapped for the degree-separated engine
(:func:`repro_torch.core.engine.propagate`) -- see
:mod:`repro_torch.train.gnn_dist`. Parameter trees keep the reference
package's names, shapes and layouts (MeshGraphNet's processor layers
stacked on a leading ``n_layers`` axis under ``"layers"``).

Archs:
* GCN        (Kipf & Welling)            -- sym-normalized SpMM
* MeshGraphNet (Pfaff et al.)            -- edge+node MLP blocks, sum agg
* GraphCast  (Lam et al., processor)     -- encode-process-decode, 16 layers
(the equivariant MACE waits for its own port).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .common import ParamSpec, layer_norm
from repro_torch.core.bfs import resolve_device
from repro_torch.tree import tree_map


@dataclass
class GraphBatch:
    """Static-shape graph container (padded): numpy arrays as the
    generators and the neighbor sampler make them, tensors after
    :func:`batch_to`."""

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


def batch_to(g: GraphBatch, device) -> GraphBatch:
    """``g`` with every array field a tensor on ``device``."""
    device = resolve_device(device)
    put = lambda a: None if a is None else torch.as_tensor(np.asarray(a)).to(device)
    return dataclasses.replace(g, **{
        f.name: put(getattr(g, f.name)) for f in dataclasses.fields(g)
        if f.name != "n_graphs"})


def aggregate(messages: torch.Tensor, receivers: torch.Tensor,
              n_nodes: int) -> torch.Tensor:
    """scatter-sum of per-edge messages onto receiver nodes (padding edges
    carry receiver == n_nodes and fall off the end)."""
    out = messages.new_zeros((n_nodes + 1,) + messages.shape[1:])
    return out.index_add(0, receivers.long(), messages)[:-1]


def sym_norm_coeffs(senders, receivers, n_nodes) -> torch.Tensor:
    """GCN 1/sqrt(d_u d_v) per edge, computed from the batch itself."""
    ones = torch.ones(senders.shape[0], dtype=torch.float32,
                      device=senders.device)
    deg = aggregate(ones, receivers, n_nodes).clamp(min=1.0)
    inv_ext = torch.cat([torch.rsqrt(deg), deg.new_zeros(1)])
    s = senders.long().clamp(max=n_nodes)
    r = receivers.long().clamp(max=n_nodes)
    return inv_ext[s] * inv_ext[r]


# ----------------------------------------------------------------------- GCN
@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"          # paper config: sym normalization, mean agg alt
    dtype: Any = torch.float32


def gcn_param_specs(cfg: GCNConfig) -> dict:
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {
        f"w{i}": ParamSpec((dims[i], dims[i + 1]), cfg.dtype,
                           ("gnn_in" if i == 0 else "", ""), "scaled")
        for i in range(cfg.n_layers)
    } | {
        f"b{i}": ParamSpec((dims[i + 1],), cfg.dtype, ("",), "zeros")
        for i in range(cfg.n_layers)
    }


def gcn_forward(cfg: GCNConfig, params: dict, g: GraphBatch) -> torch.Tensor:
    """Logits ``[N, n_classes]`` of a tensor batch (:func:`batch_to`)."""
    n = g.nodes.shape[0]
    x = g.nodes.to(cfg.dtype)
    coeff = (sym_norm_coeffs(g.senders, g.receivers, n)
             if cfg.norm == "sym" else None)
    s = g.senders.long().clamp(max=n)
    for i in range(cfg.n_layers):
        x = x @ params[f"w{i}"]
        msgs = torch.cat([x, x.new_zeros((1, x.shape[1]))]).index_select(0, s)
        if coeff is not None:
            msgs = msgs * coeff[:, None]
        if g.edge_mask is not None:
            msgs = msgs * g.edge_mask[:, None].to(msgs.dtype)
        x = aggregate(msgs, g.receivers, n) + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x


def gcn_loss(cfg: GCNConfig, params: dict, g: GraphBatch, labels,
             label_mask) -> torch.Tensor:
    logits = gcn_forward(cfg, params, g)
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    m = label_mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)


# -------------------------------------------------------------- MeshGraphNet
@dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 12
    d_edge_in: int = 4
    d_out: int = 3
    dtype: Any = torch.float32


def _mlp_specs(d_in, d_hidden, d_out, n_layers, dt, ln=True):
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
    s = {}
    for i in range(n_layers):
        s[f"w{i}"] = ParamSpec((dims[i], dims[i + 1]), dt, ("", ""), "scaled")
        s[f"b{i}"] = ParamSpec((dims[i + 1],), dt, ("",), "zeros")
    if ln:
        s["ln_w"] = ParamSpec((d_out,), dt, ("",), "ones")
        s["ln_b"] = ParamSpec((d_out,), dt, ("",), "zeros")
    return s


def mlp(params, x, n_layers, ln=True):
    """The MGN-family MLP: ``n_layers`` affine maps with relu between,
    then a layer norm (``ln``)."""
    for i in range(n_layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    if ln:
        x = layer_norm(x, params["ln_w"], params["ln_b"])
    return x


def mgn_param_specs(cfg: MGNConfig) -> dict:
    dt, h, ml = cfg.dtype, cfg.d_hidden, cfg.mlp_layers
    layer = {
        "edge_mlp": _mlp_specs(3 * h, h, h, ml, dt),
        "node_mlp": _mlp_specs(2 * h, h, h, ml, dt),
    }
    # stack processor layers
    stack = lambda spec: ParamSpec((cfg.n_layers,) + spec.shape, spec.dtype,
                                   ("layers",) + spec.axes, spec.init)
    return {
        "enc_node": _mlp_specs(cfg.d_node_in, h, h, ml, dt),
        "enc_edge": _mlp_specs(cfg.d_edge_in, h, h, ml, dt),
        "dec": _mlp_specs(h, h, cfg.d_out, ml, dt, ln=False),
        "layers": tree_map(stack, layer, is_leaf=lambda x: isinstance(x, ParamSpec)),
    }


def layer_params(layers: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``"layers"`` tree."""
    return tree_map(lambda a: a[i], layers)


def mgn_forward(cfg: MGNConfig, params: dict, g: GraphBatch) -> torch.Tensor:
    n = g.nodes.shape[0]
    ml = cfg.mlp_layers
    x = mlp(params["enc_node"], g.nodes.to(cfg.dtype), ml)
    e = mlp(params["enc_edge"], g.edge_feats.to(cfg.dtype), ml)
    s = g.senders.long().clamp(max=n)
    r = g.receivers.long().clamp(max=n)
    emask = (g.edge_mask if g.edge_mask is not None
             else (g.senders < n)).to(cfg.dtype)[:, None]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        xs = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        e2 = mlp(lp["edge_mlp"], torch.cat(
            [e, xs.index_select(0, s), xs.index_select(0, r)], -1), ml) * emask
        e = e + e2
        agg = aggregate(e, g.receivers, n)
        x = x + mlp(lp["node_mlp"], torch.cat([x, agg], -1), ml)
    return mlp(params["dec"], x, ml, ln=False)


def mgn_loss(cfg: MGNConfig, params: dict, g: GraphBatch, targets) -> torch.Tensor:
    pred = mgn_forward(cfg, params, g)
    mask = (g.node_mask if g.node_mask is not None
            else torch.ones(pred.shape[0], dtype=torch.bool,
                            device=pred.device)).float()[:, None]
    return (((pred - targets) ** 2) * mask).sum() / (mask.sum() * cfg.d_out).clamp(min=1.0)


# ----------------------------------------------------------------- GraphCast
@dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    d_edge_in: int = 4
    dtype: Any = torch.float32


def graphcast_mgn(cfg: GraphCastConfig) -> MGNConfig:
    """The MGN-style processor a GraphCast config runs: encoder (vars ->
    hidden), ``n_layers`` mesh blocks, decoder (hidden -> vars)."""
    return MGNConfig(n_layers=cfg.n_layers, d_hidden=cfg.d_hidden,
                     mlp_layers=2, d_node_in=cfg.n_vars,
                     d_edge_in=cfg.d_edge_in, d_out=cfg.n_vars,
                     dtype=cfg.dtype)


def graphcast_param_specs(cfg: GraphCastConfig) -> dict:
    """Multimesh coarse-level hub nodes are exactly where the delegate
    machinery engages in the distributed path."""
    return mgn_param_specs(graphcast_mgn(cfg))


def graphcast_forward(cfg: GraphCastConfig, params: dict,
                      g: GraphBatch) -> torch.Tensor:
    # GraphCast predicts residual increments of the state variables
    return g.nodes + mgn_forward(graphcast_mgn(cfg), params, g)


def graphcast_loss(cfg: GraphCastConfig, params: dict, g: GraphBatch,
                   targets) -> torch.Tensor:
    pred = graphcast_forward(cfg, params, g)
    mask = (g.node_mask if g.node_mask is not None
            else torch.ones(pred.shape[0], dtype=torch.bool,
                            device=pred.device)).float()[:, None]
    return (((pred - targets) ** 2) * mask).sum() / (mask.sum() * cfg.n_vars).clamp(min=1.0)
