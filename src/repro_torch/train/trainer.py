"""Generic train-step builder: gradient accumulation and metric plumbing
over parameter trees of tensors (autograd on detached copies of the
parameters; the optimizer returns new trees)."""
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


def make_train_step(loss_fn: Callable, optimizer, grad_accum: int = 1):
    """loss_fn(params, batch) -> (loss, metrics dict of scalars).

    Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With grad_accum > 1, the leading batch axis of every batch
    leaf must be divisible by grad_accum; microbatch gradients are averaged
    in f32 before one optimizer step (bounds activation peaks).
    """
    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch,
                                                    has_aux=True)
        else:
            micro = tree_map(lambda x: x.reshape(
                (grad_accum, x.shape[0] // grad_accum) + tuple(x.shape[1:])),
                batch)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            metrics = None
            for i in range(grad_accum):
                (l, m), g = value_and_grad(
                    loss_fn, params, tree_map(lambda x: x[i], micro),
                    has_aux=True)
                grads = tree_map(lambda a, b: a + b.float() / grad_accum,
                                 grads, g)
                now = {"loss": l, **m}
                metrics = (tree_map(lambda b: b / grad_accum, now)
                           if metrics is None else
                           tree_map(lambda a, b: a + b / grad_accum, metrics, now))
            loss = metrics.pop("loss")
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
