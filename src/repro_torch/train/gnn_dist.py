"""Distributed full-graph GNN training on the degree-separated engine.

The paper's computation/communication model carried to GNN training:
node states live partitioned (normals) + replicated (delegates); every
message-passing round aggregates delegate-bound messages with one global
sum (the bitmask reduction generalized to d x F features) and nn-bound
messages with a pre-aggregated all_to_all. Edge-MLP models additionally
fetch remote nn destination features with the reverse exchange
(:func:`repro_torch.core.engine.fetch_nn_dst`).

Every function takes the stacked ``[rows, ...]`` views: all ``p``
partitions on one device (``mesh=None``, emulated), or this rank's one
partition of a :class:`~repro_torch.core.comm.dist.PartitionMesh`. A loss
ends in a global sum over the partitions and returns the global loss (a
scalar, the same on every rank). Emulated, autograd of that one scalar is
the true gradient. On a mesh each rank's ``backward()`` runs through the
differentiable collectives (the delegate sum's backward is the same sum,
the payload all_to_all's the reverse one), as JAX transposes ``psum`` and
``all_to_all``: every rank's effective loss is ``p`` times the global one,
and :func:`make_dist_train_step` averages the gradients over the ranks
(the reference's ``pmean``), so every rank applies the true gradient.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import comm, engine as E
from repro_torch.models.gnn import layer_params, mlp
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import tree_map

SUBGRAPHS = ("nn", "nd", "dn", "dd")


def _global_sum(x: torch.Tensor, pgl, mesh) -> torch.Tensor:
    """Sum of one value per partition ``x [rows]`` over all partitions."""
    return comm.delegate_allreduce_sum(x, pgl.p if mesh is None else mesh)[0]


# -------------------------------------------------------------- GCN (SpMM)
def dist_gcn_forward(cfg, params, pgl, plan, w, x_n, x_d, mesh=None):
    """Per-partition GCN forward; returns (logits_n [rows, nl, C],
    logits_d [rows, d, C])."""
    h_n, h_d = x_n.to(cfg.dtype), x_d.to(cfg.dtype)
    for i in range(cfg.n_layers):
        h_n = h_n @ params[f"w{i}"]
        h_d = h_d @ params[f"w{i}"]
        h_n, h_d = E.propagate(pgl, plan, w, h_n, h_d, mesh=mesh)
        h_n = h_n + params[f"b{i}"]
        h_d = h_d + params[f"b{i}"]
        if i < cfg.n_layers - 1:
            h_n, h_d = torch.relu(h_n), torch.relu(h_d)
    return h_n, h_d


def _nll(logits, labels, mask):
    """Per-partition masked NLL sum and mask count (``[rows]`` each)."""
    logp = torch.log_softmax(logits.float(), -1)
    pick = logp.gather(-1, labels.long()[..., None])[..., 0]
    m = mask.float()
    return -(pick * m).sum(-1), m.sum(-1)


def dist_gcn_loss(cfg, params, pgl, plan, w, batch, mesh=None):
    """Masked node-classification CE over the full partitioned graph."""
    logits_n, logits_d = dist_gcn_forward(
        cfg, params, pgl, plan, w, batch["x_n"], batch["x_d"], mesh)
    p = pgl.p
    ln, cn = _nll(logits_n, batch["y_n"], batch["mask_n"])
    ld, cd = _nll(logits_d, batch["y_d"], batch["mask_d"])
    # delegates are replicated: each partition holds the same copy -> /p
    total = _global_sum(ln + ld / p, pgl, mesh)
    count = _global_sum(cn + cd / p, pgl, mesh)
    return total / torch.clamp(count, min=1.0)


# ------------------------------------------- edge-MLP models (MGN-family)
def _mgn_layer(cfg, pgl, plan, valid, mesh, x_n, x_d, e, lp):
    """One processor block: edge update from (edge, src, dst), two-class
    aggregation, residual node update. Returns ``(x_n, x_d, e)``."""
    ml = cfg.mlp_layers
    ep = E.edge_endpoints(pgl, plan, x_n, x_d, mesh)
    new_e = {}
    for k in SUBGRAPHS:
        src, dst = ep[k]
        upd = mlp(lp["edge_mlp"], torch.cat([e[k], src, dst], -1), ml)
        new_e[k] = e[k] + upd * valid[k][..., None].to(upd.dtype)
    agg_n, agg_d = E.aggregate_messages(pgl, plan, new_e, mesh=mesh)
    x_n2 = x_n + mlp(lp["node_mlp"], torch.cat([x_n, agg_n], -1), ml)
    x_d2 = x_d + mlp(lp["node_mlp"], torch.cat([x_d, agg_d], -1), ml)
    return x_n2, x_d2, new_e


def dist_mgn_forward(cfg, params, pgl, plan, batch, mesh=None):
    """MeshGraphNet/GraphCast processor over the partitioned graph.

    batch: x_n [rows, nl, Fin], x_d [rows, d, Fin], edge features per
    subgraph ``ef`` {kind: [rows, E, Fe]}. Returns decoded (out_n, out_d).
    Under autograd each block is recomputed in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    does, so the full-width configs keep one block's activations."""
    ml = cfg.mlp_layers
    x_n = mlp(params["enc_node"], batch["x_n"].to(cfg.dtype), ml)
    x_d = mlp(params["enc_node"], batch["x_d"].to(cfg.dtype), ml)
    valid = E.edge_valid_masks(pgl)
    # padding slots carry 0: enc_edge(0) is not 0 once the biases move, and
    # the aggregation scatters padding into column 0 (the reference keeps
    # it there, src/repro/train/gnn_dist.py:81; the port masks it, so the
    # distributed model stays the local one at any parameters)
    e = {k: mlp(params["enc_edge"], batch["ef"][k].to(cfg.dtype), ml)
         * valid[k][..., None].to(cfg.dtype) for k in SUBGRAPHS}
    for i in range(cfg.n_layers):
        args = (cfg, pgl, plan, valid, mesh, x_n, x_d, e,
                layer_params(params["layers"], i))
        if torch.is_grad_enabled():
            x_n, x_d, e = checkpoint(_mgn_layer, *args, use_reentrant=False)
        else:
            x_n, x_d, e = _mgn_layer(*args)
    return (mlp(params["dec"], x_n, ml, ln=False),
            mlp(params["dec"], x_d, ml, ln=False))


def dist_mgn_loss(cfg, params, pgl, plan, batch, mesh=None, residual=False):
    """Masked mean squared error of the node outputs (GraphCast:
    ``residual=True``, the outputs are increments of the inputs)."""
    out_n, out_d = dist_mgn_forward(cfg, params, pgl, plan, batch, mesh)
    if residual:  # GraphCast predicts increments
        out_n = out_n + batch["x_n"].to(out_n.dtype)
        out_d = out_d + batch["x_d"].to(out_d.dtype)
    p = pgl.p
    mn = batch["mask_n"].float()[..., None]
    md = batch["mask_d"].float()[..., None]
    se = (((out_n - batch["y_n"]) ** 2 * mn).sum((1, 2))
          + ((out_d - batch["y_d"]) ** 2 * md).sum((1, 2)) / p)
    cnt = mn.sum((1, 2)) + md.sum((1, 2)) / p
    total = _global_sum(se, pgl, mesh)
    count = _global_sum(cnt, pgl, mesh) * out_n.shape[-1]
    return total / torch.clamp(count, min=1.0)


# ------------------------------------------------------------ step builders
def make_dist_train_step(loss_local: Callable, optimizer, mesh=None):
    """``step(params, opt_state, *args) -> (params, opt_state, loss)`` for
    ``loss_local(params, *args)``, a distributed loss above (the global
    loss on every rank). Emulated (``mesh=None``) the gradient of that one
    loss is the true gradient; on a mesh every rank's gradient is averaged
    over the ranks (one ``all_reduce`` a leaf: the reference's ``pmean``),
    so every rank applies the same, true, gradient -- held against the
    single-device model in the tests."""

    def step(params, opt_state, *args):
        loss, grads = value_and_grad(loss_local, params, *args)
        if mesh is not None:
            grads = tree_map(lambda g: comm.dist.all_reduce(mesh, g, "sum")
                             / mesh.p, grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, loss

    return step
