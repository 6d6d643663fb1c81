"""Hand-rolled optimizers: AdamW, Adafactor, SGD, with the reference
package's state layout and update arithmetic (``torch.optim`` computes
other things: AdamW's ``b2 = 0.95``, the global-norm clip inside
``update`` and the weight decay added to the update are the reference's).

Functional API over parameter trees of tensors: ``init(params) ->
state``, ``update(grads, state, params) -> (new_params, new_state)``;
nothing is updated in place. Moments are float32 whatever the parameter
dtype; ``step`` is an int32 scalar.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.tree import leaves, leaves_up_to, tree_map, unflatten_like


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """``tree`` scaled by ``min(1, max_norm / norm)``, and ``norm``: its
    own :func:`global_norm` unless given (a sharded tree's norm is the
    world's)."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up over ``warmup`` steps, then a cosine to 0 at
    ``total``; ``lr(step)`` is a float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm,
                           base_lr * 0.5 * (1 + torch.cos(math.pi * t)))
    return lr


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    dev = next(iter(leaves(params))).device
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclass(frozen=True)
class ShardedLeaf:
    """A rank's block of a parameter split over mesh axes, for the
    optimizers' whole-leaf statistics: ``dims[i]`` the mesh axes dimension
    ``i`` is split over (``()``: whole), ``shape`` the whole leaf's shape,
    ``psum(x, axes)`` the sum of ``x`` over the ranks along ``axes``."""
    dims: tuple
    shape: tuple
    psum: Callable

    def mean(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The mean over dimension ``dim`` of the whole leaf of which ``x``
        is this rank's block (``x``'s dimension ``dim`` lines up with the
        leaf's from the right)."""
        s = x.sum(dim)
        axes = self.dims[dim]
        if axes:
            s = self.psum(s, axes)
        return s / self.shape[dim]

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        s = x.sum()
        axes = tuple(a for d in self.dims for a in d)
        if axes:
            s = self.psum(s, axes)
        return s / math.prod(self.shape)


@dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params):
        return {"step": _step0(params), "m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(self, grads, state, params, norm=None):
        """``norm``: the gradient's global norm where ``grads`` is a shard
        of it (the world's, each leaf counted once); the clip reads it."""
        step = state["step"] + 1
        if self.clip_norm:
            grads, _ = clip_by_global_norm(grads, self.clip_norm, norm)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), {"step": step, "m": m, "v": v}


@dataclass(frozen=True)
class Adafactor:
    """Factored second-moment optimizer (Shazeer & Stern). Momentum-free;
    state is O(rows + cols) per matrix instead of O(rows * cols)."""
    lr: Callable | float = 1e-2
    decay: float = 0.8          # t^-decay running-average exponent
    eps: float = 1e-30
    clip_threshold: float = 1.0
    min_dim_factored: int = 2

    def _factored(self, shape) -> bool:
        return len(shape) >= self.min_dim_factored

    def init(self, params):
        def one(p):
            if self._factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32, device=p.device)}
            return {"v": _zeros_f32(p)}
        return {"step": _step0(params), "stats": tree_map(one, params)}

    @torch.no_grad()
    def update(self, grads, state, params, shards=None):
        """``shards``: where the leaves are blocks of sharded parameters, a
        :class:`ShardedLeaf` per leaf; the factored means, the
        denominator's mean and the update's RMS then run over the whole
        leaf (summed over the axes its reduced dimensions are split
        over)."""
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t ** (-self.decay)
        lr = self.lr(step) if callable(self.lr) else self.lr

        def one(p, g, s, sh):
            g = g.float()
            g2 = torch.square(g) + self.eps
            mean = torch.mean if sh is None else sh.mean
            if self._factored(p.shape):
                vr = beta * s["vr"] + (1 - beta) * mean(g2, -1)
                vc = beta * s["vc"] + (1 - beta) * mean(g2, -2)
                # vr's last dimension is the leaf's second to last
                denom = torch.clamp(
                    vr.mean(-1, keepdim=True) if sh is None
                    else sh.mean(vr[..., None], -2), min=self.eps)
                u = g / torch.sqrt(vr[..., None] / denom[..., None]
                                   * vc[..., None, :] + self.eps)
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / torch.sqrt(v + self.eps)
                new_s = {"v": v}
            # update clipping (RMS <= clip_threshold)
            ms = torch.mean(torch.square(u)) if sh is None else \
                sh.mean_all(torch.square(u))
            rms = torch.sqrt(ms + 1e-30)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            return (p.float() - lr * u).to(p.dtype), new_s

        shards = [None] * len(leaves(params)) if shards is None \
            else leaves(shards)
        out = [one(p, g, s, sh) for p, g, s, sh in zip(
            leaves(params), leaves(grads), leaves_up_to(params, state["stats"]),
            shards)]
        return (unflatten_like(params, [o[0] for o in out]),
                {"step": step,
                 "stats": unflatten_like(params, [o[1] for o in out])})


@dataclass(frozen=True)
class SGD:
    lr: Callable | float = 1e-2
    momentum: float = 0.9

    def init(self, params):
        return {"step": _step0(params), "m": tree_map(_zeros_f32, params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        m = tree_map(lambda m, g: self.momentum * m + g.float(), state["m"], grads)
        new_params = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype),
                              params, m)
        return new_params, {"step": step, "m": m}


def get_optimizer(name: str, lr, **kw):
    return {"adamw": AdamW, "adafactor": Adafactor, "sgd": SGD}[name](lr=lr, **kw)
