"""Cell builders: (architecture x input shape x mesh) -> a rank's step --
the port of ``repro.launch.cells``, its LM ``kind == "train"`` cell.

:func:`build_lm_cell` resolves what the reference's ``build_lm_cell``
resolves -- grouped routing's ``moe_groups == -1`` to the product of the
data axes, the rules (``rules_for`` with the arch's ``rules_override``),
the shape's grad accumulation and the optimizer on
``cosine_schedule(3e-4, 100, 10000)`` -- and returns the rank's step on
its mesh (``train.trainer.make_mesh_train_step`` over ``LM.loss_fn`` with
a :class:`~repro_torch.models.common.Parallel`), with what a launcher needs
to feed it: the rank's rows of a global batch, its shards of a whole
tree, its own shards drawn from a seed.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

from .mesh import data_axes
from .sharding import (MeshLayout, draw_tree, layout_of, param_shardings,
                       rules_for, shard_tree)


def lm_optimizer(spec):
    """The spec's optimizer on ``cosine_schedule(3e-4, 100, 10000)``."""
    from repro_torch.train.optim import cosine_schedule, get_optimizer

    return get_optimizer(spec.optimizer, lr=cosine_schedule(3e-4, 100, 10000))


@dataclass
class LMCell:
    """One rank's LM train cell: ``step(params, opt_state, batch) ->
    (params, opt_state, metrics)`` on this rank's shards and rows."""
    step: Callable
    cfg: Any
    shape: tuple            # (global batch, seq_len)
    optimizer: Any
    accum: int
    rules: dict
    par: Any                # models.common.Parallel
    mesh: Any
    shardings: Any          # a LeafSharding per parameter

    @property
    def layout(self) -> MeshLayout:
        return layout_of(self.mesh)

    @property
    def data_index(self) -> tuple:
        """``(index, count)`` of this rank over the data axes."""
        return self.par.index(self.par.data), self.par.size(self.par.data)

    def rows(self, batch: dict) -> dict:
        """This rank's rows of a global batch (``trainer.shard_rows``)."""
        from repro_torch.train.trainer import shard_rows

        return shard_rows(batch, *self.data_index, self.accum)

    def shard_params(self, params):
        """This rank's blocks of a whole parameter tree."""
        return shard_tree(params, self.shardings, self.layout)

    def draw_params(self, seed: int, device="cpu"):
        """This rank's blocks of the initial parameters, drawn on
        ``device`` block by block (``sharding.draw_tree``): the ranks'
        blocks put together are ``draw_tree``'s whole tree."""
        from repro_torch.models.lm import lm_param_specs, lm_units

        return draw_tree(lm_param_specs(self.cfg), seed, self.rules,
                         self.mesh.axes, self.mesh.sizes, self.layout, device,
                         lm_units(self.cfg))


def resolve_config(spec, mesh, smoke: bool = False, layers_override: int = 0):
    """The model config of a cell: grouped routing's ``moe_groups == -1``
    as the product of the data axes' sizes; ``layers_override`` an
    unrolled, shallow copy."""
    cfg = spec.smoke if smoke else spec.model
    if cfg.moe_groups == -1:
        g = math.prod(mesh.size(a) for a in data_axes(mesh))
        cfg = dataclasses.replace(cfg, moe_groups=g)
    if layers_override:
        cfg = dataclasses.replace(cfg, n_layers=layers_override,
                                  scan_layers=False)
    return cfg


def build_lm_cell(spec, shape_name: str, mesh, smoke: bool = False,
                  layers_override: int = 0) -> LMCell:
    """The ``kind == "train"`` cell of an LM arch on this rank of ``mesh``
    (a :class:`~repro_torch.core.comm.dist.PartitionMesh`). ``smoke``:
    the smoke config, the sequence capped at 64, the global batch at 4 and
    no accumulation (as the reference's)."""
    from repro_torch.models import lm as LM
    from repro_torch.models.common import Parallel
    from repro_torch.train.trainer import make_mesh_train_step

    cfg = resolve_config(spec, mesh, smoke, layers_override)
    shape = dict(spec.shapes[shape_name])
    if shape["kind"] != "train":
        raise ValueError(f"{spec.name} {shape_name} is a {shape['kind']} "
                         "shape; the prefill and decode cells are not ported")
    if smoke:
        shape["seq_len"] = min(shape["seq_len"], 64)
        shape["global_batch"] = min(shape["global_batch"], 4)
    rules = rules_for(mesh, spec.rules_override)
    par = Parallel(mesh, rules)
    opt = lm_optimizer(spec)
    accum = (spec.grad_accum.get(shape_name, 1)
             if not (smoke or layers_override) else 1)
    specs = LM.lm_param_specs(cfg)
    units = LM.lm_units(cfg)
    shardings = param_shardings(specs, rules, units)
    step = make_mesh_train_step(lambda p, b: LM.loss_fn(cfg, p, b, par),
                                opt, par, shardings, accum)
    return LMCell(step=step, cfg=cfg,
                  shape=(shape["global_batch"], shape["seq_len"]),
                  optimizer=opt, accum=accum, rules=rules, par=par, mesh=mesh,
                  shardings=shardings)


def lm_wire_bytes(cell: LMCell, rows: int, seq: int) -> dict:
    """The bytes this rank's collectives send in one step of ``cell`` on
    ``rows`` rows of ``seq`` tokens (its rows of the global batch),
    reckoned from the shapes under the ring model of
    ``core.comm.dist`` (an all-reduce of n elements over k ranks sends 2
    (k - 1) ceil(n / k) of them, an all-gather k - 1 chunks), by the
    keys the step's ``metrics["wire"]`` counts them under: ``reduce``
    (forward all-reduces leaving a tensor-parallel region), ``copy``
    (their backward twins entering one), ``ce``, ``routing``, ``gather`` /
    ``scatter`` (FSDP), ``grad_sum`` and ``optimizer``.

    A checkpointed layer's recompute repeats its forward collectives up
    to the last tensor its backward needs (``torch.utils.checkpoint``
    stops there): the attention's all-reduce, global routing's and the
    FSDP gathers run twice; the all-reduce that closes the FFN (dense or
    MoE) and grouped routing's aux sum, once."""
    import torch

    from repro_torch.core.comm.dist import ring_allreduce_bytes as ar
    from repro_torch.core.comm.dist import ring_gather_bytes as ag
    from repro_torch.models.common import is_spec
    from repro_torch.models.lm import lm_param_specs
    from repro_torch.train.optim import Adafactor
    from repro_torch.tree import leaves

    cfg, par = cell.cfg, cell.par
    out: dict = {}

    def add(key, n):
        if n:
            out[key] = out.get(key, 0) + n

    k_of = lambda logical: par.size(par.axes(logical))
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    kv, kh, kf = k_of("vocab"), k_of("heads"), k_of("ff")
    ke, kd, n = k_of("experts"), k_of("moe_embed"), par.size(par.data)
    bm = rows // cell.accum
    t, d = bm * seq, cfg.d_model
    runs = 2 if cfg.remat else 1
    for _ in range(cell.accum):
        add("reduce", ar(t * d, itemsize, kv))                      # embed
        add("copy", ar(t * d, itemsize, kv))                        # head
        add("ce", 3 * ar(t, 4, kv))                 # max, sum of exp, gold
        add("ce", 2 * ar(1, 4, n))                  # the sum, the count
        for _ in range(cfg.n_layers):
            add("reduce", runs * ar(t * d, itemsize, kh))          # wo
            add("copy", ar(t * d, itemsize, kh))                 # q (and kv)
            if kh > 1 and not par.axes("kv_heads"):
                add("copy", 2 * ar(t * cfg.n_kv * cfg.d_head, itemsize, kh))
            if not cfg.is_moe:
                add("reduce", ar(t * d, itemsize, kf))
                add("copy", ar(t * d, itemsize, kf))
            else:
                lo, hi = par.span("experts", cfg.n_experts_pad)
                e_loc = hi - lo
                g = cfg.moe_groups
                if g > 0 and (t * n) % g == 0:   # the groups' aux sum, once
                    add("routing", ar(1, 4, n))
                else:                   # the counts' gather, the probs' sum
                    add("routing", runs * (ag(cfg.n_experts, 4, n)
                                           + ar(cfg.n_experts, 4, n)))
                shared = cfg.n_shared_experts and par.axes("ff") != \
                    par.axes("experts")
                add("reduce", ar(t * d, itemsize, ke) + (
                    ar(t * d, itemsize, kf) if shared else 0))
                add("copy", ar(t * d, itemsize, ke)
                    + ar(t * cfg.top_k, 4, ke)
                    + (ar(t * d, itemsize, kf) if shared else 0))
                if kd > 1:
                    chunk = e_loc * -(-d // kd) * cfg.d_ff_expert
                    add("gather", runs * 3 * ag(chunk, itemsize, kd))
                    add("scatter", 3 * (
                        ag(chunk, itemsize, kd) if par.mesh.backend == "nccl"
                        else ar(e_loc * d * cfg.d_ff_expert, itemsize, kd)))
    # the step: the data-parallel sum, the world's norm, Adafactor's means
    buckets: dict = {}
    norms = set()
    for spec, sh in zip(leaves(lm_param_specs(cfg), is_spec),
                        leaves(cell.shardings)):
        axes = tuple(a for a in par.data if a not in sh.sharded)
        size = 4 if cell.accum > 1 else \
            torch.empty((), dtype=spec.dtype).element_size()
        numel = math.prod(_local_shape(cell, sh))
        if par.size(axes) > 1:
            buckets[(axes, size)] = buckets.get((axes, size), 0) + numel
        norms.add(sh.sharded)
    for (axes, size), numel in buckets.items():
        add("grad_sum", ar(numel, size, par.size(axes)))
    for axes in norms:
        add("optimizer", ar(1, 4, par.size(axes)))
    if isinstance(cell.optimizer, Adafactor):
        for sh in leaves(cell.shardings):
            local = _local_shape(cell, sh)
            if cell.optimizer._factored(sh.shape):
                add("optimizer", ar(math.prod(local[:-1]), 4,
                                    par.size(sh.dims[-1])))
                add("optimizer", ar(math.prod(local[:-2] + local[-1:]), 4,
                                    par.size(sh.dims[-2])))
                add("optimizer", ar(math.prod(local[:-2]), 4,
                                    par.size(sh.dims[-2])))
            add("optimizer", ar(1, 4, par.size(sh.sharded)))
    return out


def _local_shape(cell: LMCell, sh) -> tuple:
    from .sharding import leaf_slices

    return tuple(s.stop - s.start if s.start is not None else n
                 for s, n in zip(leaf_slices(sh, cell.layout), sh.shape))

