"""Parameter-spec system and shared layers (functional, plain tensors).

Every model declares its parameters as a nested dict of ``ParamSpec``s, as
the reference package does (same names, shapes and layouts), and
:func:`materialize` makes tensors of them. Random initial values come from
a ``torch.Generator`` and cannot equal the reference's ``jax.random``
ones: to give both packages the same weights, carry the reference's
arrays across (:func:`repro_torch.core.convert.tree_from_numpy`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.bfs import resolve_device
from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: Any = torch.bfloat16
    axes: tuple = ()          # logical axis name per dim ("" = replicated)
    init: str = "normal"      # normal | zeros | ones | scaled(fan_in)
    scale: float = 0.02


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(f: Callable[[ParamSpec], Any], specs):
    return tree_map(f, specs, is_leaf=is_spec)


def shape_tree(specs):
    """Shape-only tensors (``meta`` device) of the specs, allocating
    nothing."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def materialize(specs, seed: int = 0, device="cuda"):
    """Parameters of the specs on ``device``: zeros, ones, normal / sqrt
    (fan_in) ("scaled") or ``scale`` * normal, drawn in flatten order from
    one CPU ``torch.Generator`` seeded with ``seed`` (the same values on
    every device)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for spec in leaves(specs, is_spec):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=spec.dtype)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=spec.dtype)
        elif spec.init == "scaled":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            t = (torch.randn(spec.shape, generator=gen)
                 / np.sqrt(fan_in)).to(spec.dtype)
        else:
            t = (torch.randn(spec.shape, generator=gen)
                 * spec.scale).to(spec.dtype)
        out.append(t.to(dev))
    return unflatten_like(specs, out, is_spec)


# ----------------------------------------------------------------- layers
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with gemma's ``1 + w`` scale: normalised in float32, cast
    to ``x``'s dtype, then scaled in that dtype (the reference's casts, in
    its order: in bfloat16 the order is the result)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * (1 + w.to(x.dtype))


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SiLU of ``gate`` in float32, cast to ``gate``'s dtype, times ``up``."""
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu_mlp_specs(d_in: int, d_hidden: int, layers: int,
                   prefix_axes=("",)) -> dict:
    """Plain MLP spec helper used by GNN/recsys models."""
    specs = {}
    dims = [d_in] + [d_hidden] * layers
    for i in range(layers):
        specs[f"w{i}"] = ParamSpec((dims[i], dims[i + 1]), torch.float32,
                                   ("", ""), "scaled")
        specs[f"b{i}"] = ParamSpec((dims[i + 1],), torch.float32, ("",),
                                   "zeros")
    return specs


def mlp_apply(params: dict, x: torch.Tensor, layers: int, act=gelu,
              final_act: bool = True) -> torch.Tensor:
    for i in range(layers):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < layers - 1 or final_act:
            x = act(x)
    return x


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean CE; logits upcast to f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
