"""Logical-axis -> mesh-axis rules and the shards they cut -- the port of
``repro.launch.sharding``.

Models name each parameter dimension with a logical axis
(``ParamSpec.axes``); :func:`rules_for` binds the logical axes to the
mesh's axes as the reference does (DP over pod+data, TP / EP over model,
with each arch's overrides). Where the reference attaches a
``NamedSharding`` and lets GSPMD place the blocks, the port cuts them: a
dimension bound to mesh axes ``A`` is split over the ranks along ``A`` as
``torch.tensor_split`` splits it (ragged where it does not divide, such as
40 heads over 16; GSPMD pads instead, and the math is the same), block
``i`` on the ranks whose row-major index over ``A`` is ``i``.

* :class:`LeafSharding` -- one leaf's mesh axes per dimension;
  :func:`param_shardings` and :func:`opt_state_shardings` (the layout of
  the reference's ``opt_state_struct``: AdamW's moments like their
  parameter, Adafactor's ``vr`` / ``vc`` with the parameter's axes less
  the one they reduce).
* :class:`MeshLayout` -- a rank's coordinates without a live mesh, so a
  host can cut or join every rank's shards (:func:`shard_tree`,
  :func:`gather_tree`).
* :func:`cache_shardings` -- the KV cache's decode layout (the
  reference's ``_lm_cache_struct``): batch over the data axes and kv heads
  over ``model`` where they divide it, else the sequence split
  (flash-decoding's split-KV).
* :func:`draw_tree` -- a config's initial parameters drawn block by block,
  each block from a generator seeded by the seed, the leaf and the
  block's coordinates along the leaf's sharded axes (never by the rank):
  ranks that hold the same block draw the same values, and the whole tree
  is the blocks put together.
"""
from __future__ import annotations

import hashlib
import itertools
import math
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.models.common import (ParamSpec, init_values, is_spec,
                                       tree_map_specs)
from repro_torch.tree import leaves, tree_map, unflatten_like

from .mesh import all_axes, data_axes


def _canon(value, mesh):
    """Expand the 'data' shorthand in rule tuples to (pod, data) when the
    mesh is multi-pod."""
    da = data_axes(mesh)
    if value == "data":
        return da if len(da) > 1 else "data"
    if isinstance(value, tuple):
        out = []
        for v in value:
            if v == "data":
                out.extend(da)
            else:
                out.append(v)
        return tuple(out)
    return value


def rules_for(mesh, overrides: dict | None = None) -> dict:
    """The reference's rules on ``mesh`` (anything with ``axes``, such as a
    :class:`~repro_torch.core.comm.dist.PartitionMesh`)."""
    rules = {
        "batch": data_axes(mesh),
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "mlp_ff": "model",
        "experts": "model",
        "moe_embed": None,   # large MoEs override to 'data' (EP x FSDP)
        "embed": None,
        "layers": None,
        "gnn_in": None,
        "table_rows": all_axes(mesh),
        "": None,
    }
    for k, v in (overrides or {}).items():
        rules[k] = _canon(v, mesh)
    return rules


def mesh_axes(rule) -> tuple:
    """A rule's value as a tuple of mesh axes (``None``: ``()``)."""
    if rule is None:
        return ()
    return (rule,) if isinstance(rule, str) else tuple(rule)


@dataclass(frozen=True)
class LeafSharding:
    """The mesh axes each dimension of a leaf is split over (``()``:
    whole on every rank), the leaf's whole shape, and the unit each
    dimension is split in (a flattened ``heads * d_head`` dimension splits
    whole heads: unit ``d_head``)."""
    dims: tuple
    shape: tuple
    units: tuple = ()

    def unit(self, dim: int) -> int:
        return self.units[dim] if self.units else 1

    @property
    def sharded(self) -> tuple:
        """Every mesh axis the leaf is split over, in dimension order."""
        return tuple(a for d in self.dims for a in d)

    def reduced(self, dim: int) -> "LeafSharding":
        """The sharding of a reduction over ``dim`` (Adafactor's
        statistics)."""
        dim %= len(self.dims)
        cut = lambda t: t[:dim] + t[dim + 1:] if t else t
        return LeafSharding(cut(self.dims), cut(self.shape), cut(self.units))


def leaf_sharding(spec: ParamSpec, rules: dict,
                  units: dict | None = None) -> LeafSharding:
    """``units``: the split unit of a logical axis (default 1)."""
    axes = spec.axes if spec.axes else ("",) * len(spec.shape)
    dims = tuple(mesh_axes(rules.get(a)) for a in axes)
    flat = [a for d in dims for a in d]
    if len(set(flat)) != len(flat):
        raise ValueError(f"{spec} splits one mesh axis twice ({dims})")
    return LeafSharding(dims, tuple(spec.shape),
                        tuple((units or {}).get(a, 1) for a in axes))


def param_shardings(specs, rules: dict, units: dict | None = None):
    """A :class:`LeafSharding` per parameter spec."""
    return tree_map_specs(lambda s: leaf_sharding(s, rules, units), specs)


def opt_state_shardings(optimizer, specs, rules: dict,
                        units: dict | None = None):
    """A :class:`LeafSharding` per leaf of ``optimizer.init(params)`` (the
    step: whole), in the layout of the reference's ``opt_state_struct``."""
    from repro_torch.train.optim import SGD, AdamW, Adafactor

    params = param_shardings(specs, rules, units)
    step = LeafSharding((), ())
    if isinstance(optimizer, (AdamW, SGD)):
        out = {"step": step, "m": params}
        if isinstance(optimizer, AdamW):
            out["v"] = params
        return out
    if isinstance(optimizer, Adafactor):
        def stats(sh: LeafSharding):
            if optimizer._factored(sh.shape):
                return {"vr": sh.reduced(-1), "vc": sh.reduced(-2)}
            return {"v": sh}
        return {"step": step, "stats": tree_map(stats, params)}
    raise TypeError(type(optimizer))


@dataclass(frozen=True)
class MeshLayout:
    """A rank's place on a mesh: the mesh's ``axes`` and ``sizes`` and the
    rank's ``coords`` (what a ``PartitionMesh`` holds, without a process
    group)."""
    axes: tuple
    sizes: tuple
    coords: tuple

    @classmethod
    def of(cls, axes: Sequence[str], sizes: Sequence[int], rank: int):
        coords, r = [], rank
        for s in reversed(sizes):
            coords.append(r % s)
            r //= s
        return cls(tuple(axes), tuple(sizes), tuple(reversed(coords)))

    def block(self, axes: tuple) -> tuple:
        """``(index, count)``: this rank's row-major index over ``axes`` (in
        the order given) and the number of ranks along them."""
        i, k = 0, 1
        for a in axes:
            j = self.axes.index(a)
            i, k = i * self.sizes[j] + self.coords[j], k * self.sizes[j]
        return i, k


def layout_of(mesh) -> MeshLayout:
    return MeshLayout(tuple(mesh.axes), tuple(mesh.sizes), tuple(mesh.coords))


def dim_span(n: int, k: int, i: int, unit: int = 1) -> tuple:
    """``[lo, hi)`` of block ``i`` when ``n`` (``n / unit`` units) is split
    over ``k`` as ``torch.tensor_split`` splits the units."""
    if n % unit:
        raise ValueError(f"{n} is not a whole number of units of {unit}")
    q, r = divmod(n // unit, k)
    lo = i * q + min(i, r)
    return lo * unit, (lo + q + (i < r)) * unit


def leaf_slices(sh: LeafSharding, layout: MeshLayout, shape=None) -> tuple:
    """The slices of a whole leaf (``shape``, default the sharding's) that
    a rank at ``layout`` holds."""
    shape = sh.shape if shape is None else shape
    out = []
    for j, (n, axes) in enumerate(zip(shape, sh.dims)):
        if axes:
            i, k = layout.block(axes)
            out.append(slice(*dim_span(n, k, i, sh.unit(j))))
        else:
            out.append(slice(None))
    return tuple(out)


def shard_leaf(x, sh: LeafSharding, layout: MeshLayout):
    """A rank's block of a whole leaf (a numpy array or a tensor)."""
    part = x[leaf_slices(sh, layout, tuple(x.shape))]
    if torch.is_tensor(part):
        return part.contiguous()
    return np.ascontiguousarray(part)


def shard_tree(tree, shardings, layout: MeshLayout):
    """A rank's blocks of every leaf of a whole tree (``shardings``: a
    :class:`LeafSharding` per leaf, e.g. :func:`param_shardings`)."""
    return tree_map(lambda x, sh: shard_leaf(x, sh, layout), tree, shardings)


def gather_tree(shards: list, shardings, axes: Sequence[str],
                sizes: Sequence[int]):
    """Inverse of :func:`shard_tree`: every rank's tree, in rank order, put
    together (a replicated leaf from rank 0)."""
    layouts = [MeshLayout.of(axes, sizes, r) for r in range(len(shards))]
    cols = [leaves(s) for s in shards]

    def whole(j, sh: LeafSharding):
        parts = [c[j] for c in cols]
        if not sh.sharded:
            return parts[0]
        full = parts[0].new_empty(sh.shape) if torch.is_tensor(parts[0]) \
            else np.empty(sh.shape, parts[0].dtype)
        for lay, x in zip(layouts, parts):
            full[leaf_slices(sh, lay)] = x
        return full

    return unflatten_like(shards[0], [whole(j, sh) for j, sh in
                                      enumerate(leaves(shardings))])


def _block_seed(seed: int, leaf: int, block: tuple) -> int:
    key = f"{seed}/{leaf}/{','.join(map(str, block))}".encode()
    return int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                          "little") & (2**63 - 1)


def draw_tree(specs, seed: int, rules: dict, axes: Sequence[str],
              sizes: Sequence[int], layout: MeshLayout | None = None,
              device="cuda", units: dict | None = None) -> Any:
    """Initial values of ``specs`` (``common.init_values``) cut into the
    blocks that ``rules`` make on a mesh of ``axes`` / ``sizes``, each block
    drawn on ``device`` from its own generator (:func:`_block_seed`): ``layout``
    given, a rank's blocks; otherwise the whole tree, every block in its
    place (the same values as the ranks draw)."""
    sh = [leaf_sharding(spec, rules, units) for spec in leaves(specs, is_spec)]
    out = draw_blocks(leaves(specs, is_spec), sh, seed, axes, sizes, layout,
                      device)
    return unflatten_like(specs, out, is_spec)


def draw_blocks(specs: list, shardings: list, seed: int, axes: Sequence[str],
                sizes: Sequence[int], layout: MeshLayout | None = None,
                device="cuda") -> list:
    """:func:`draw_tree` over a list of specs and their
    :class:`LeafSharding` (such as a KV cache's,
    :func:`cache_shardings`)."""
    from repro_torch.core.bfs import resolve_device

    device = resolve_device(device)
    out = []
    for li, (spec, sh) in enumerate(zip(specs, shardings)):
        grid = [math.prod(sizes[list(axes).index(a)] for a in d) if d else 1
                for d in sh.dims]
        if layout is not None:
            blocks = [tuple(layout.block(d)[0] if d else 0 for d in sh.dims)]
        else:
            blocks = list(itertools.product(*(range(g) for g in grid)))
        parts = []
        for blk in blocks:
            sl = tuple(slice(*dim_span(n, g, b, sh.unit(j))) for j, (n, g, b)
                       in enumerate(zip(spec.shape, grid, blk)))
            shape = tuple(s.stop - s.start for s in sl)
            gen = torch.Generator(device=device).manual_seed(
                _block_seed(seed, li, blk))
            parts.append((sl, init_values(spec, shape, gen, device)))
        if layout is not None:
            out.append(parts[0][1])
            continue
        full = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        for sl, t in parts:
            full[sl] = t
        out.append(full)
    return out


# ------------------------------------------------------------ the KV cache
def cache_shardings(cfg, mesh, batch: int, max_seq: int) -> list:
    """A ``{"k", "v"}`` pair of :class:`LeafSharding` per layer of the KV
    cache ``[B, T, n_kv, d_head]`` (``models.lm.init_cache_specs``) on
    ``mesh`` (anything with ``axes`` and ``sizes``), the layout of the
    reference's ``_lm_cache_struct``:

    * the kv heads divide ``model`` (``n_kv % model == 0``, ``n_kv >=
      model``): batch over the data axes, kv heads over ``model``;
    * otherwise with one sequence (``batch == 1``): a global layer's
      slots over the data axes and ``model``, a window layer's ring over
      ``model``;
    * otherwise: batch over the data axes, a global layer's slots over
      ``model``; a window layer's ring whole.

    A batch of one is never split (every data rank holds the sequence:
    the reference's token is replicated then too). Decode attends over a
    split sequence by combining each rank's partial softmax
    (``models.attention.decode_attention``)."""
    axes, sizes = tuple(mesh.axes), tuple(mesh.sizes)
    model = sizes[axes.index("model")] if "model" in axes else 1
    da = data_axes(mesh)
    rows = da if batch > 1 else ()
    out = []
    for i in range(cfg.n_layers):
        is_global = cfg.layer_is_global(i)
        t = max_seq if is_global else min(cfg.window, max_seq)
        m = ("model",) if "model" in axes else ()
        if cfg.n_kv % model == 0 and cfg.n_kv >= model:
            dims = (rows, (), m, ())
        elif batch == 1:
            dims = ((), da + m if t == max_seq else m, (), ())
        else:
            dims = (rows, m if t == max_seq else (), (), ())
        sh = LeafSharding(dims, (batch, t, cfg.n_kv, cfg.d_head))
        out.append({"k": sh, "v": sh})
    return out


def cache_seq_axes(sh: LeafSharding) -> tuple:
    """The mesh axes a cache leaf's slots are split over."""
    return sh.dims[1]
