"""xDeepFM training: the port of the ``train`` branch of the reference's
``launch/cells.py::build_recsys_cell`` (without its JAX launcher).

``make_recsys_train_step(cfg, optimizer)`` is :func:`repro_torch.train.
trainer.make_train_step` over :func:`repro_torch.models.recsys.
xdeepfm_loss`: ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` on a parameter dict with the reference's names and layouts and
a ``ClickStream`` batch (``hot_idx``, ``cold_idx``, ``labels``) as tensors
(:func:`batch_to`). On a card each CIN layer of a step launches the
``cin_fused`` forward kernel and its two backward kernels once each. The
optimizer is the one the config's spec names (``spec.optimizer``: AdamW
for ``xdeepfm``, from :func:`repro_torch.train.optim.get_optimizer`).
Every leaf trains, the embedding tables included (dense gradients, as the
reference's ``jax.grad`` gives them).

``make_sharded_recsys_train_step(cfg, optimizer, mesh)`` is the same step
over the ranks of a :class:`~repro_torch.core.comm.dist.PartitionMesh`,
as the reference runs it under GSPMD: every rank holds its cold shards
(:func:`repro_torch.core.convert.xdeepfm_shard_params`, over the mesh
axes the spec's ``rules_override`` names for ``table_rows``) and the
replicated leaves, takes its rows of the batch (:func:`shard_batch`) and
looks its cold rows up point-to-point (:func:`repro_torch.models.recsys.
route_cold`); its loss is its rows' BCE sum over the global batch size.
The replicated leaves' gradients are summed over the mesh in one
all-reduce (the delegate all-reduce of the paper); a cold shard takes
only the row gradients its lookups brought back. The optimizer then runs
on each rank's own leaves: AdamW and SGD are elementwise, and AdamW's
global-norm clip reads the world's norm (the replicated leaves' squares
plus every shard's, carried in the same all-reduce), so the sharded step
equals the one-card step up to float32 reordering.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.comm import dist as D, plan_for
from repro_torch.models.recsys import (COLD_LEAVES, XDeepFMConfig,
                                       route_cold, table_axes, xdeepfm_loss)
from repro_torch.train.optim import (SGD, AdamW, clip_by_global_norm,
                                     global_norm)
from repro_torch.train.trainer import make_train_step, value_and_grad


def make_recsys_train_step(cfg: XDeepFMConfig, optimizer) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss":
    ...})`` for ``cfg``."""
    return make_train_step(lambda p, bt: (xdeepfm_loss(cfg, p, bt), {}),
                           optimizer)


def batch_to(batch: dict, device) -> dict:
    """A ``ClickStream`` batch (numpy) as tensors on ``device``: the indices
    int32, the labels as given."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def shard_batch(batch: dict, rank: int, p: int) -> dict:
    """Rank ``rank``'s rows ``[r * B // p, (r + 1) * B // p)`` of a batch
    (every leaf split on its leading axis, as the reference's batch spec
    splits the batch axis over the data axes)."""
    b = len(batch["labels"])
    lo, hi = rank * b // p, (rank + 1) * b // p
    return {k: v[lo:hi] for k, v in batch.items()}


def sharded_value_and_grad(cfg: XDeepFMConfig, params: dict, batch: dict,
                           mesh, cin_op: Callable | None = None,
                           axes: tuple | None = None) -> tuple:
    """The global loss and gradient on this rank of ``mesh``, whose cold
    tables are sharded over ``axes`` (:func:`~repro_torch.models.recsys.
    table_axes`; None: every axis): ``(loss, grads, cold_sq, route)``.
    ``loss`` is the global mean (the same on every rank); ``grads`` holds
    the replicated leaves' global gradients (summed over the world in one
    all-reduce) and this rank's cold shards' (the row gradients its
    lookups brought back, summed over the shard's replicas on the other
    axes); ``cold_sq`` is the global sum of the cold gradients' squares
    (each shard counted once, in the same all-reduce); ``route`` the
    batch's :class:`~repro_torch.models.recsys.ColdRoute`."""
    route = route_cold(mesh, batch["cold_idx"], axes)
    loss, grads = value_and_grad(
        lambda prm: xdeepfm_loss(cfg, prm, batch, cin_op, route), params)
    rest = tuple(a for a in mesh.axes if a not in route.axes)
    if rest:
        for k in COLD_LEAVES:
            grads[k] = D.all_reduce(mesh, grads[k], "sum", rest)
        route.sent["cold_allreduce"] = plan_for(
            None, {a: mesh.size(a) for a in rest}).delegate_bytes(
                sum(grads[k].numel() for k in COLD_LEAVES), 4, "sum")
    first = not rest or mesh.index(rest) == 0
    cold_sq = sum(grads[k].float().square().sum() for k in COLD_LEAVES)
    shared = sorted(k for k in grads if k not in COLD_LEAVES)
    flat = torch.cat([grads[k].reshape(-1).float() for k in shared]
                     + [loss.reshape(1).float(),
                        (cold_sq if first else cold_sq * 0).reshape(1)])
    flat = D.all_reduce(mesh, flat, "sum")
    o = 0
    for k in shared:
        n = grads[k].numel()
        grads[k] = flat[o:o + n].reshape(grads[k].shape).to(grads[k].dtype)
        o += n
    route.sent["allreduce"] = plan_for(None, mesh).delegate_bytes(
        flat.numel(), 4, "sum")
    return flat[-2], grads, flat[-1], route


def make_sharded_recsys_train_step(cfg: XDeepFMConfig, optimizer, mesh,
                                   cin_op: Callable | None = None,
                                   rules: dict | None = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on this rank of ``mesh``: ``params`` holds its cold shards and the
    replicated leaves, ``opt_state`` the optimizer's state of those,
    ``batch`` its rows (:func:`shard_batch`). The cold tables are sharded
    over the axes that ``rules["table_rows"]`` names (by default the
    registered ``xdeepfm`` spec's ``rules_override``: ``("data",
    "model")``; :func:`~repro_torch.models.recsys.table_axes`), in ``q``
    shards, and replicated over the other axes; rank ``r``'s shard is
    :func:`repro_torch.core.convert.xdeepfm_shard_params` ``(params, s,
    q)`` with ``s`` its position over those axes. A mesh without them is
    refused. ``metrics``: ``"loss"`` (the global mean, the same on every
    rank), ``"grad_norm"`` (the world's gradient norm, which AdamW's clip
    reads), ``"route"`` (the step's
    :class:`~repro_torch.models.recsys.ColdRoute`) and ``"wire"``, the
    bytes this rank put on the wire: the route's exchanges as the
    collectives counted them (``"counts"``, ``"ids"``, ``"rows"``,
    ``"grads"``), ``"allreduce"``, the replicated leaves' sum, and, where
    the shards have replicas, ``"cold_allreduce"``, their row gradients'
    sum (the ring model of :mod:`repro_torch.core.comm.base`). The
    optimizer must be elementwise: :class:`AdamW` (its clip made global)
    or :class:`SGD`."""
    if not isinstance(optimizer, (AdamW, SGD)):
        raise ValueError(f"{type(optimizer).__name__} is not elementwise: "
                         "its statistics span a whole leaf, which a cold "
                         "shard does not hold")
    if rules is None:
        rules = get_arch("xdeepfm").rules_override
    axes = table_axes(mesh, rules)
    clip = getattr(optimizer, "clip_norm", 0.0)
    local = dataclasses.replace(optimizer, clip_norm=0.0) if clip else optimizer

    def step(params, opt_state, batch):
        loss, grads, cold_sq, route = sharded_value_and_grad(
            cfg, params, batch, mesh, cin_op, axes)
        shared = [g for k, g in grads.items() if k not in COLD_LEAVES]
        norm = torch.sqrt(global_norm(shared) ** 2 + cold_sq)
        if clip:
            grads, _ = clip_by_global_norm(grads, clip, norm)
        new_params, new_state = local.update(grads, opt_state, params)
        return new_params, new_state, {"loss": loss, "grad_norm": norm,
                                       "wire": dict(route.sent),
                                       "route": route}

    return step
