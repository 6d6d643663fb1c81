"""Generic train-step builder: gradient accumulation and metric plumbing
over parameter trees of tensors (autograd on detached copies of the
parameters; the optimizer returns new trees), on one device
(:func:`make_train_step`) or on one rank of a mesh
(:func:`make_mesh_train_step`: a rank's blocks of the parameters and its
rows of the batch)."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like


def value_and_grad(loss_fn: Callable, params, *args, has_aux: bool = False):
    """``(loss_fn(params, *args), grads)``: ``loss_fn``'s output (with
    ``has_aux``, a ``(loss, aux)`` pair), detached, and the gradient tree
    of its loss with respect to ``params`` (zeros where it does not
    depend on a leaf)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    out = loss_fn(unflatten_like(params, flat), *args)
    loss = out[0] if has_aux else out
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    out = tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, out)
    return out, unflatten_like(params, grads)


def accumulated_value_and_grad(loss_fn: Callable, params, batch,
                               grad_accum: int = 1) -> tuple:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch) -> (loss,
    metrics)``; with ``grad_accum > 1`` the leading batch axis of every
    batch leaf is cut into that many microbatches, whose gradients are
    averaged in f32 (and their metrics averaged)."""
    if grad_accum == 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                has_aux=True)
        return loss, metrics, grads
    micro = tree_map(lambda x: x.reshape(
        (grad_accum, x.shape[0] // grad_accum) + tuple(x.shape[1:])), batch)
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    metrics = None
    for i in range(grad_accum):
        (l, m), g = value_and_grad(
            loss_fn, params, tree_map(lambda x: x[i], micro), has_aux=True)
        grads = tree_map(lambda a, b: a + b.float() / grad_accum, grads, g)
        now = {"loss": l, **m}
        metrics = (tree_map(lambda b: b / grad_accum, now)
                   if metrics is None else
                   tree_map(lambda a, b: a + b / grad_accum, metrics, now))
    loss = metrics.pop("loss")
    return loss, metrics, grads


def make_train_step(loss_fn: Callable, optimizer, grad_accum: int = 1):
    """loss_fn(params, batch) -> (loss, metrics dict of scalars).

    Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With grad_accum > 1, the leading batch axis of every batch
    leaf must be divisible by grad_accum; microbatch gradients are averaged
    in f32 before one optimizer step (bounds activation peaks).
    """
    def train_step(params, opt_state, batch):
        loss, metrics, grads = accumulated_value_and_grad(loss_fn, params,
                                                          batch, grad_accum)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss, **{k: v for k, v in metrics.items() if k != "loss"}}
        return new_params, new_opt, metrics

    return train_step


def make_eval_step(loss_fn: Callable):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}
    return eval_step


# ------------------------------------------------------------------ on a mesh
def shard_rows(batch, index: int, count: int, grad_accum: int = 1):
    """Data rank ``index`` of ``count``'s rows of a global batch (every leaf
    split on its leading axis): its slice of each microbatch of the
    one-device step. Microbatch ``i`` is the global rows ``[i B / a, (i + 1)
    B / a)``, split over the data ranks; the rank's rows come microbatch by
    microbatch, so :func:`make_mesh_train_step` cuts them into its
    microbatches as :func:`make_train_step` cuts the global batch (and
    routing and capacity see the one-device step's token sets)."""
    def cut(x):
        b = x.shape[0]
        if b % (grad_accum * count):
            raise ValueError(f"a batch of {b} rows does not split into "
                             f"{grad_accum} microbatches over {count} data "
                             "ranks")
        per = b // (grad_accum * count)
        rows = x.reshape((grad_accum, count, per) + tuple(x.shape[1:]))[:, index]
        return rows.reshape((grad_accum * per,) + tuple(x.shape[1:]))
    return tree_map(cut, batch)


def mesh_value_and_grad(loss_fn: Callable, params, batch, par, shardings,
                        grad_accum: int = 1) -> tuple:
    """``(loss, metrics, grads)`` of the step on one rank of a mesh:
    ``loss_fn(params, batch)`` the global ``(loss, metrics)`` from this
    rank's shards and rows (the model's collectives inside, e.g.
    ``LM.loss_fn(cfg, p, b, par)``), ``par`` the
    :class:`~repro_torch.models.common.Parallel` it runs under,
    ``shardings`` a :class:`~repro_torch.launch.sharding.LeafSharding` per
    parameter, ``batch`` this rank's rows (:func:`shard_rows`), cut into
    ``grad_accum`` microbatches as :func:`make_train_step` cuts the global
    batch. The gradient each leaf needs:

    * split over ``model`` (or replicated over it): nothing more. The
      model enters and leaves its tensor-parallel regions through
      ``Parallel.copy`` / ``Parallel.reduce``, so a block's gradient is
      its own, and a replicated leaf's is the whole one on every model
      rank.
    * replicated over a data axis: summed over those axes (the loss is
      split over the data ranks' rows there), in one all-reduce a dtype.
    * split over a data axis (FSDP's ``moe_embed``): nothing more; its
      gather's backward reduce-scattered the sum.

    ``grads`` is then this rank's block of the one-device step's
    gradient."""
    loss, metrics, grads = accumulated_value_and_grad(loss_fn, params, batch,
                                                      grad_accum)
    flat = leaves(grads)
    buckets: dict = {}
    for i, (g, sh) in enumerate(zip(flat, leaves(shardings))):
        axes = tuple(a for a in par.data if a not in sh.sharded)
        if par.size(axes) > 1:
            buckets.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in buckets.items():
        whole = par.all_reduce(torch.cat([flat[i].reshape(-1) for i in idx]),
                               axes, "sum", "grad_sum")
        o = 0
        for i in idx:
            n = flat[i].numel()
            flat[i] = whole[o:o + n].reshape(flat[i].shape)
            o += n
    return loss, metrics, unflatten_like(grads, flat)


def world_norm(grads, par, shardings) -> torch.Tensor:
    """The global norm of a gradient of which this rank holds blocks: each
    leaf's squares summed over the axes it is split over (each block
    counted once, however many ranks hold it)."""
    groups: dict = {}
    for g, sh in zip(leaves(grads), leaves(shardings)):
        sq = torch.sum(torch.square(g.float()))
        groups[sh.sharded] = groups[sh.sharded] + sq if sh.sharded in groups \
            else sq
    return torch.sqrt(sum(par.all_reduce(sq, axes, "sum", "optimizer")
                          for axes, sq in sorted(groups.items())))


def mesh_update(optimizer, grads, opt_state, params, par, shardings) -> tuple:
    """``(new_params, new_state, norm)``: the optimizer on this rank's
    blocks of a mesh gradient (:func:`mesh_value_and_grad`). AdamW's clip
    reads the world's norm (:func:`world_norm`), Adafactor's whole-leaf
    means run over the whole leaf
    (:class:`~repro_torch.train.optim.ShardedLeaf`)."""
    from repro_torch.train.optim import Adafactor, AdamW, ShardedLeaf

    norm = world_norm(grads, par, shardings)
    if isinstance(optimizer, AdamW):
        new_params, new_opt = optimizer.update(
            grads, opt_state, params, norm=norm if optimizer.clip_norm else None)
    elif isinstance(optimizer, Adafactor):
        psum = lambda x, axes: par.all_reduce(x, tuple(axes), "sum",
                                              "optimizer")
        new_params, new_opt = optimizer.update(
            grads, opt_state, params, shards=tree_map(
                lambda sh: ShardedLeaf(sh.dims, sh.shape, psum), shardings))
    else:
        new_params, new_opt = optimizer.update(grads, opt_state, params)
    return new_params, new_opt, norm


def make_mesh_train_step(loss_fn: Callable, optimizer, par, shardings,
                         grad_accum: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on one rank of a mesh: :func:`mesh_value_and_grad`, then
    :func:`mesh_update`. ``metrics`` adds ``"grad_norm"`` (the world's)
    and ``"wire"``, the bytes this rank's collectives sent in the step, by
    kind."""
    def train_step(params, opt_state, batch):
        before = dict(par.tally)
        loss, metrics, grads = mesh_value_and_grad(
            loss_fn, params, batch, par, shardings, grad_accum)
        new_params, new_opt, norm = mesh_update(optimizer, grads, opt_state,
                                                params, par, shardings)
        metrics = {"loss": loss, **{k: v for k, v in metrics.items()
                                    if k != "loss"},
                   "grad_norm": norm, "wire": wire_since(par, before)}
        return new_params, new_opt, metrics

    return train_step


def wire_since(par, before: dict) -> dict:
    """The bytes ``par``'s collectives counted since ``before`` (a copy of
    its tally), by kind."""
    return {k: v - before.get(k, 0) for k, v in par.tally.items()
            if v != before.get(k, 0)}
