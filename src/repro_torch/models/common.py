"""Parameter-spec system and shared layers (functional, plain tensors).

Every model declares its parameters as a nested dict of ``ParamSpec``s, as
the reference package does (same names, shapes and layouts), and
:func:`materialize` makes tensors of them. Random initial values come from
a ``torch.Generator`` and cannot equal the reference's ``jax.random``
ones: to give both packages the same weights, carry the reference's
arrays across (:func:`repro_torch.core.convert.tree_from_numpy`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

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


def init_values(spec: ParamSpec, shape: tuple, gen: torch.Generator,
                device="cpu") -> torch.Tensor:
    """Initial values of ``spec``, or of a block of it (``shape``), on
    ``device`` from ``gen`` (a generator of that device): zeros, ones,
    normal / sqrt(fan_in) of the whole spec ("scaled") or ``scale`` *
    normal."""
    if spec.init in ("zeros", "ones"):
        fill = torch.zeros if spec.init == "zeros" else torch.ones
        return fill(shape, dtype=spec.dtype, device=device)
    t = torch.randn(shape, generator=gen, device=device)
    if spec.init == "scaled":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        t /= math.sqrt(fan_in)
    else:
        t *= spec.scale
    return t.to(spec.dtype)


def materialize(specs, seed: int = 0, device="cuda"):
    """Parameters of the specs on ``device`` (:func:`init_values`), drawn in
    flatten order from one CPU ``torch.Generator`` seeded with ``seed``
    (the same values on every device)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    out = [init_values(spec, spec.shape, gen).to(dev)
           for spec in leaves(specs, is_spec)]
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


class Parallel:
    """The parallel context a model runs under on one rank of a mesh: the
    mesh (a :class:`~repro_torch.core.comm.dist.PartitionMesh`) and the
    logical-axis rules (``repro_torch.launch.sharding.rules_for``). Its
    collectives add the bytes they send to ``tally``.

    A logical axis bound to mesh axes splits the dimensions it names over
    the ranks along them (``torch.tensor_split``'s blocks, :meth:`span`);
    the model's tensor-parallel regions are entered by :meth:`copy`
    (identity forward, all-reduce backward) and left by :meth:`reduce`
    (all-reduce forward, identity backward), so that a tensor every rank
    of a group holds whole also holds its whole gradient on each. The
    batch is split over the data axes (``rules["batch"]``)."""

    def __init__(self, mesh, rules: dict):
        self.mesh, self.rules = mesh, rules
        self.tally: dict = {}
        self.data = self.axes("batch")

    def axes(self, logical: str) -> tuple:
        """The mesh axes of a logical axis (``()``: not split)."""
        from repro_torch.launch.sharding import mesh_axes

        return mesh_axes(self.rules.get(logical))

    def size(self, axes: tuple) -> int:
        return self.mesh.size(axes) if axes else 1

    def index(self, axes: tuple) -> int:
        return self.mesh.index(axes) if axes else 0

    def span(self, logical: str, n: int) -> tuple:
        """``[lo, hi)`` of this rank's block of ``n`` (heads, experts, ids)
        along ``logical``."""
        from repro_torch.launch.sharding import dim_span

        axes = self.axes(logical)
        return dim_span(n, self.size(axes), self.index(axes))

    def copy(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        from repro_torch.core.comm.dist import CopyToGroup

        if self.size(axes) == 1:
            return x
        return CopyToGroup.apply(x, self.mesh, axes, self.tally, "copy")

    def reduce(self, x: torch.Tensor, axes: tuple,
               key: str = "reduce") -> torch.Tensor:
        from repro_torch.core.comm.dist import ReduceFromGroup

        if self.size(axes) == 1:
            return x
        return ReduceFromGroup.apply(x, self.mesh, axes, self.tally, key)

    def gather(self, x: torch.Tensor, dim: int, n: int,
               axes: tuple) -> torch.Tensor:
        """The whole of a leaf split along ``dim`` (of ``n``) over ``axes``;
        its gradient is reduce-scattered back (FSDP)."""
        from repro_torch.core.comm.dist import GatherFromGroup

        if self.size(axes) == 1:
            return x
        return GatherFromGroup.apply(x, self.mesh, dim, n, axes, self.tally)

    def all_reduce(self, x: torch.Tensor, axes: tuple, op: str = "sum",
                   key: str = "reduce") -> torch.Tensor:
        """A value (no gradient) reduced over ``axes``."""
        from repro_torch.core.comm import dist as D

        if self.size(axes) == 1:
            return x
        D.tally_bytes(self.tally, key, D.ring_allreduce_bytes(
            x.numel(), x.element_size(), self.size(axes)))
        return D.all_reduce(self.mesh, x.detach(), op, axes)

    def all_gather(self, x: torch.Tensor, axes: tuple,
                   key: str = "gather") -> torch.Tensor:
        """``[k, *x.shape]``: every member's ``x`` over ``axes`` (no
        gradient)."""
        from repro_torch.core.comm import dist as D

        k = self.size(axes)
        if k == 1:
            return x[None]
        D.tally_bytes(self.tally, key, D.ring_gather_bytes(
            x.numel(), x.element_size(), k))
        return D.all_gather(self.mesh, x.detach(), axes)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       par: Parallel | None = None,
                       vocab: int = 0) -> torch.Tensor:
    """Token-mean CE; logits upcast to f32. With ``par``: ``logits`` are
    this rank's rows of the batch and its block of the ``vocab`` ids
    (``par.span("vocab", vocab)``); the max and the sum of exponentials
    are reduced over the vocabulary's axes, the gold logit comes from the
    block that holds the label, and the mean is the global sum over the
    global count of (unmasked) tokens, both summed over the data axes
    (not a mean of the ranks' means)."""
    if par is not None:
        return _sharded_cross_entropy(logits, labels, mask, par, vocab)
    logits = logits.float()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _sharded_cross_entropy(logits, labels, mask, par: Parallel, n: int):
    vocab = par.axes("vocab")
    logits = logits.float()
    lo, hi = par.span("vocab", n)
    v_loc = hi - lo
    # the max only shifts the exponentials: no gradient through it
    mx = par.all_reduce(logits.detach().amax(-1), vocab, "max", "ce")
    sumexp = torch.exp(logits - mx[..., None]).sum(-1)
    logz = torch.log(par.reduce(sumexp, vocab, "ce")) + mx
    local = labels.long() - lo
    inside = (local >= 0) & (local < v_loc)
    gold = logits.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    gold = par.reduce(torch.where(inside, gold, torch.zeros_like(gold)),
                      vocab, "ce")
    nll = logz - gold
    if mask is None:
        total = nll.sum()
        count = torch.tensor(float(nll.numel()), device=nll.device)
    else:
        mask = mask.float()
        total = (nll * mask).sum()
        count = mask.sum()
    total = par.reduce(total, par.data, "ce")
    count = par.all_reduce(count, par.data, "sum", "ce")
    return total / count.clamp(min=1.0)

