"""Cell builders: (architecture x input shape x mesh) -> a rank's step and
the arguments it takes -- the port of ``repro.launch.cells``.

Where the reference returns a jitted function and ``ShapeDtypeStruct``
arguments (so that lowering it is the dry run), a builder here returns one
rank's cell on a :class:`~repro_torch.core.comm.dist.PartitionMesh`: its
``step`` and a way to make its arguments. ``cell.args(seed, device)``
draws this rank's arguments from a seed on a device (the card by
default); ``cell.dry_args(seed, device)`` makes the arguments the dry run
feeds the same step under ``FakeTensorMode`` (``launch.dryrun``), the
graph cells' partitions synthesized from the shape (``launch.synth``)
where a real one would not fit a host.

* LM (:func:`build_lm_cell`): ``train`` (:class:`LMCell`: the rank's step
  on its mesh, ``trainer.make_mesh_train_step`` over ``LM.loss_fn`` with a
  :class:`~repro_torch.models.common.Parallel`), ``prefill`` and
  ``decode`` (:class:`LMServeCell`: ``LM.prefill(last_only=True)`` /
  ``LM.decode_step`` with ``par``, the KV cache in the decode layout of
  ``sharding.cache_shardings``). Grouped routing's ``moe_groups == -1``
  resolves to the product of the data axes, the rules are ``rules_for``
  with the arch's ``rules_override``, the optimizer is the spec's on
  ``cosine_schedule(3e-4, 100, 10000)``.
* GNN (:func:`build_gnn_cell`): ``dist_full`` over
  ``train.gnn_dist.make_dist_train_step`` on the rank's partition;
  ``minibatch`` and ``batched_small``, a data-parallel step whose loss is
  the mean of the per-graph losses (the reference's ``vmap``).
* Recsys (:func:`build_recsys_cell`): ``train`` (the sharded step of
  ``train.recsys``), ``serve`` (its lookup without the backward),
  ``retrieval`` (candidates over the data axes, each rank's top 100
  merged).
* BFS (:func:`build_bfs_cell`): ``core.bfs.make_sharded_bfs``.

:func:`build_cell` dispatches (a skipped shape raises), :func:`all_cells`
enumerates.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.bfs import resolve_device

from .mesh import all_axes, data_axes
from .sharding import (MeshLayout, cache_shardings, dim_span, draw_blocks,
                       draw_tree, layout_of, param_shardings, rules_for,
                       shard_tree)


def lm_optimizer(spec):
    """The spec's optimizer on ``cosine_schedule(3e-4, 100, 10000)`` (every
    family's cell trains with it, as the reference's ``_optimizer``)."""
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

    kind = "train"

    def draw_params(self, seed: int, device="cuda"):
        """This rank's blocks of the initial parameters, drawn on
        ``device`` block by block (``sharding.draw_tree``): the ranks'
        blocks put together are ``draw_tree``'s whole tree."""
        from repro_torch.models.lm import lm_param_specs, lm_units

        return draw_tree(lm_param_specs(self.cfg), seed, self.rules,
                         self.mesh.axes, self.mesh.sizes, self.layout, device,
                         lm_units(self.cfg))

    def args(self, seed: int = 0, device="cuda") -> tuple:
        """``(params, opt_state, batch)`` of this rank: its drawn blocks,
        the optimizer's state of them, its rows of a global batch of
        tokens drawn from ``seed``."""
        params = self.draw_params(seed, device)
        b, s = self.shape
        toks = _randint(seed, (b, s + 1), self.cfg.vocab)
        batch = self.rows({"tokens": toks[:, :-1].contiguous(),
                           "labels": toks[:, 1:].contiguous()})
        dev = resolve_device(device)
        return (params, self.optimizer.init(params),
                {k: v.to(dev) for k, v in batch.items()})

    dry_args = args


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
                  layers_override: int = 0):
    """The cell of an LM arch's shape on this rank of ``mesh`` (a
    :class:`~repro_torch.core.comm.dist.PartitionMesh`): an
    :class:`LMCell` for ``train``, an :class:`LMServeCell` for ``prefill``
    and ``decode``. ``smoke``: the smoke config, the sequence capped at 64,
    the global batch at 4 and no accumulation (as the reference's)."""
    from repro_torch.models import lm as LM
    from repro_torch.models.common import Parallel
    from repro_torch.train.trainer import make_mesh_train_step

    cfg = resolve_config(spec, mesh, smoke, layers_override)
    shape = dict(spec.shapes[shape_name])
    if smoke:
        shape["seq_len"] = min(shape["seq_len"], 64)
        shape["global_batch"] = min(shape["global_batch"], 4)
    rules = rules_for(mesh, spec.rules_override)
    if shape["kind"] != "train":
        return lm_serve_cell(shape, cfg, rules, mesh)
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


def _randint(seed: int, shape: tuple, high: int) -> torch.Tensor:
    """Integers in ``[0, high)`` drawn on the host from ``seed`` (int32):
    the same values whatever the device, every rank drawing the global
    tensor and keeping its rows."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int32)


@dataclass
class LMServeCell:
    """One rank's LM serving cell: ``kind == "prefill"``, ``step(params,
    tokens) -> (logits, cache)`` (``LM.prefill(last_only=True)``, the
    last position's logits of this rank's vocabulary block, its cache
    blocks in the decode layout); ``kind == "decode"``, ``step(params,
    cache, token, pos) -> (logits, cache)`` (``LM.decode_step``, the cache
    written in place). A batch of one is held whole by every rank (no
    data split: the reference replicates its token too)."""
    kind: str
    step: Callable
    cfg: Any
    shape: tuple            # (global batch, seq_len = the cache's max_seq)
    rules: dict
    par: Any
    mesh: Any
    shardings: Any          # a LeafSharding per parameter
    cache_shardings: list   # {"k", "v"} LeafShardings per layer

    @property
    def layout(self) -> MeshLayout:
        return layout_of(self.mesh)

    def row_span(self) -> tuple:
        """``[lo, hi)``: this rank's rows of the global batch."""
        b = self.shape[0]
        data = self.par.data
        return dim_span(b, self.par.size(data), self.par.index(data))

    def rows(self, x):
        lo, hi = self.row_span()
        return x[lo:hi]

    def shard_params(self, params):
        return shard_tree(params, self.shardings, self.layout)

    def shard_cache(self, cache: list) -> list:
        """This rank's blocks of a whole cache."""
        return shard_tree(cache, self.cache_shardings, self.layout)

    def draw_params(self, seed: int, device="cuda"):
        from repro_torch.models.lm import lm_param_specs, lm_units

        return draw_tree(lm_param_specs(self.cfg), seed, self.rules,
                         self.mesh.axes, self.mesh.sizes, self.layout, device,
                         lm_units(self.cfg))

    def draw_cache(self, seed: int, device="cuda", whole: bool = False
                   ) -> list:
        """This rank's cache blocks (``whole``: the whole cache, every
        block in its place), N(0, 1) in the config's dtype, block by block
        (``sharding.draw_blocks``)."""
        from repro_torch.models.common import ParamSpec

        specs, sh = [], []
        for layer in self.cache_shardings:
            for name in ("k", "v"):
                specs.append(ParamSpec(layer[name].shape, self.cfg.dtype,
                                       init="normal", scale=1.0))
                sh.append(layer[name])
        out = draw_blocks(specs, sh, seed, self.mesh.axes, self.mesh.sizes,
                          None if whole else self.layout, device)
        return [{"k": out[2 * i], "v": out[2 * i + 1]}
                for i in range(len(self.cache_shardings))]

    def args(self, seed: int = 0, device="cuda") -> tuple:
        """prefill: ``(params, tokens)``; decode: ``(params, cache, token,
        pos)`` at the cache's last position (every slot valid)."""
        dev = resolve_device(device)
        params = self.draw_params(seed, dev)
        b, s = self.shape
        if self.kind == "prefill":
            return params, self.rows(_randint(seed, (b, s), self.cfg.vocab)
                                     ).to(dev)
        token = self.rows(_randint(seed, (b,), self.cfg.vocab)).to(dev)
        return params, self.draw_cache(seed + 1, dev), token, s - 1

    dry_args = args


def lm_serve_cell(shape: dict, cfg, rules: dict, mesh) -> LMServeCell:
    """The prefill or decode cell (``shape["kind"]``) of ``cfg`` at
    ``shape``'s ``global_batch`` x ``seq_len`` on ``mesh`` under ``rules``
    (:func:`build_lm_cell` resolves them from an arch's spec; a caller may
    give its own shape, as a test or a smaller run does)."""
    from repro_torch.models import lm as LM
    from repro_torch.models.common import Parallel

    b, s = shape["global_batch"], shape["seq_len"]
    if b == 1:                      # one sequence: held whole, not split
        rules = dict(rules, batch=())
    par = Parallel(mesh, rules)
    csh = cache_shardings(cfg, mesh, b, s)
    shardings = param_shardings(LM.lm_param_specs(cfg), rules,
                                LM.lm_units(cfg))
    if shape["kind"] == "prefill":
        def step(params, tokens):
            return LM.prefill(cfg, params, tokens, max_seq=s, last_only=True,
                              par=par, shardings=csh)
    elif shape["kind"] == "decode":
        def step(params, cache, token, pos):
            return LM.decode_step(cfg, params, cache, token, pos, par, csh)
    else:
        raise ValueError(shape["kind"])
    return LMServeCell(kind=shape["kind"], step=step, cfg=cfg, shape=(b, s),
                       rules=rules, par=par, mesh=mesh, shardings=shardings,
                       cache_shardings=csh)


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
    MoE) and grouped routing's aux sum, once.

    Of a serving cell (:class:`LMServeCell`; ``rows`` of ``seq`` tokens a
    prefill, ``seq`` 1 a decode step) the forward's collectives once, and
    ``cache`` (kv heads gathered whole for a cache that is not split on
    them) and ``split_kv`` (a decode step's q heads gathered and its
    partial softmax combined over the ranks that split a layer's
    slots)."""
    if isinstance(cell, LMServeCell):
        return _serve_wire_bytes(cell, rows, seq)
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



def _serve_wire_bytes(cell: LMServeCell, rows: int, seq: int) -> dict:
    from repro_torch.core.comm.dist import ring_allreduce_bytes as ar
    from repro_torch.core.comm.dist import ring_gather_bytes as ag

    cfg, par = cell.cfg, cell.par
    out: dict = {}

    def add(key, n):
        if n:
            out[key] = out.get(key, 0) + n

    k_of = lambda logical: par.size(par.axes(logical))
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    kv, kh, kf = k_of("vocab"), k_of("heads"), k_of("ff")
    kk, ke, kd = k_of("kv_heads"), k_of("experts"), k_of("moe_embed")
    n = par.size(par.data)
    t, d, dh = rows * seq, cfg.d_model, cfg.d_head
    add("reduce", ar(t * d, itemsize, kv))                          # embed
    for i, layer in enumerate(cell.cache_shardings):
        sh = layer["k"]
        if par.size(sh.dims[2]) == 1 and kk > 1:       # kv heads whole
            add("cache", 2 * ag(t * -(-cfg.n_kv // kk) * dh, itemsize, kk))
        ks = par.size(sh.dims[1])
        if cell.kind == "decode" and ks > 1 and par.size(sh.dims[2]) == 1:
            if kh > 1:
                add("split_kv", ag(rows * -(-cfg.n_heads // kh) * dh,
                                   itemsize, kh))
            add("split_kv", ar(rows * cfg.n_heads, 4, ks)
                + ar(rows * cfg.n_heads * (1 + dh), 4, ks))
        add("reduce", ar(t * d, itemsize, kh))                     # wo
        if not cfg.is_moe:
            add("reduce", ar(t * d, itemsize, kf))
            continue
        g = cfg.moe_groups
        if g > 0 and (t * n) % g == 0:
            add("routing", ar(1, 4, n))
        else:
            add("routing", ag(cfg.n_experts, 4, n) + ar(cfg.n_experts, 4, n))
        shared = cfg.n_shared_experts and par.axes("ff") != par.axes("experts")
        add("reduce", ar(t * d, itemsize, ke)
            + (ar(t * d, itemsize, kf) if shared else 0))
        if kd > 1:
            lo, hi = par.span("experts", cfg.n_experts_pad)
            add("gather", 3 * ag((hi - lo) * -(-d // kd) * cfg.d_ff_expert,
                                 itemsize, kd))
    return out


# ---------------------------------------------------------------- the others
@dataclass
class Cell:
    """One rank's cell of a GNN, recsys or BFS arch: ``step`` and its
    arguments, ``args(seed, device)`` (this rank's, drawn from a seed) or
    ``dry_args(seed, device)`` (the dry run's: a graph cell's partition
    synthesized from the shape, ``launch.synth``)."""
    arch: str
    shape: str
    kind: str
    step: Callable
    mesh: Any
    cfg: Any
    make: Callable                  # (seed, device) -> args
    synth: Callable | None = None   # (seed, device) -> the dry run's args
    info: dict = field(default_factory=dict)

    def args(self, seed: int = 0, device="cuda") -> tuple:
        return self.make(seed, resolve_device(device))

    def dry_args(self, seed: int = 0, device="cuda") -> tuple:
        return (self.synth or self.make)(seed, resolve_device(device))


def _sum_over(mesh, axes: tuple, tree):
    """Every leaf of ``tree`` summed over the ranks along ``axes`` (one
    all-reduce of the float32 leaves put end to end)."""
    from repro_torch.core.comm import dist as D
    from repro_torch.tree import leaves, unflatten_like

    if not axes or mesh.size(axes) == 1:
        return tree
    flat = leaves(tree)
    buf = D.all_reduce(mesh, torch.cat([x.float().reshape(-1) for x in flat]),
                       "sum", axes)
    out, o = [], 0
    for x in flat:
        out.append(buf[o:o + x.numel()].reshape(x.shape).to(x.dtype))
        o += x.numel()
    return unflatten_like(tree, out)


# ---------------------------------------------------------------------- GNN
def _base_name(spec) -> str:
    return spec.name.replace("-opt2", "").replace("-opt", "")


def _gnn_model_cfg(spec, shape: dict, smoke: bool, layers_override: int):
    cfg = spec.smoke if smoke else (spec.model(shape) if callable(spec.model)
                                    else spec.model)
    if layers_override and hasattr(cfg, "n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=layers_override)
    return cfg


def _gnn_param_specs(spec, cfg):
    from repro_torch.models import equivariant as EQ, gnn as G

    name = _base_name(spec)
    if name == "gcn-cora":
        return G.gcn_param_specs(cfg)
    if name == "meshgraphnet":
        return G.mgn_param_specs(cfg)
    if name == "graphcast":
        return G.graphcast_param_specs(cfg)
    if name == "mace":
        return EQ.mace_param_specs(cfg)
    raise ValueError(spec.name)


def _draw(specs, seed: int, device):
    """A parameter tree of ``specs`` (``common.materialize``'s values)."""
    from repro_torch.models.common import materialize

    return materialize(specs, seed, device)


def build_gnn_cell(spec, shape_name: str, mesh, smoke: bool = False,
                   layers_override: int = 0) -> Cell:
    """``dist_full``: the degree-separated engine's train step on this
    rank's partition (``p`` = the world, rank ``r`` partition ``r``):
    ``step(params, opt_state, pg, plan[, weights], batch)`` (weights: GCN),
    ``(params, opt_state, loss)``; ``minibatch`` (one sampled subgraph a
    rank) and ``batched_small`` (graphs over the data axes):
    ``step(params, opt_state, batch)``, ``(params, opt_state, {"loss"})``,
    the loss the mean of the per-graph losses and its gradient summed over
    the ranks that hold different graphs."""
    shape = dict(spec.shapes[shape_name])
    cfg = _gnn_model_cfg(spec, shape, smoke, layers_override)
    kind = shape["kind"]
    p = mesh.p
    opt = lm_optimizer(spec)
    if kind == "dist_full":
        n, e, d_feat = shape["n_nodes"], shape["n_edges"], shape["d_feat"]
        if smoke:
            n, e = 512, 2048
            d_feat = getattr(cfg, "d_in", 16)
        return _dist_full_cell(spec, shape_name, cfg, mesh, opt, n, e, d_feat)
    if kind == "minibatch":
        seeds = shape["batch_nodes"] // p if not smoke else 2
        f1, f2 = shape["fanouts"]
        node_cap = seeds * (1 + f1 + f1 * f2)
        edge_cap = seeds * (f1 + f1 * f2)
        return _batched_gnn_cell(spec, shape_name, kind, cfg, mesh, opt,
                                 all_axes(mesh), node_cap, edge_cap, lead=p)
    if kind == "batched_small":
        nb = shape["batch"] if not smoke else 4
        return _batched_gnn_cell(spec, shape_name, kind, cfg, mesh, opt,
                                 data_axes(mesh), shape["n_nodes"],
                                 shape["n_edges"], lead=nb)
    raise ValueError(kind)


def _gnn_model(spec) -> str:
    """The model family a GNN arch's loss runs: ``"gcn"``, ``"mgn"`` (the
    MeshGraphNet family, GraphCast included) or ``"mace"``."""
    name = _base_name(spec)
    return {"gcn-cora": "gcn", "meshgraphnet": "mgn",
            "graphcast": "mgn"}.get(name, "mace")


def _dist_full_cell(spec, shape_name, cfg, mesh, opt, n: int, e: int,
                    d_feat: int) -> Cell:
    from repro_torch.models import gnn as G
    from repro_torch.train import gnn_dist as GD

    name = _base_name(spec)
    model = _gnn_model(spec)
    if name == "gcn-cora":
        loss = lambda prm, pgl, pl, w, bt: GD.dist_gcn_loss(cfg, prm, pgl, pl,
                                                           w, bt, mesh)
    elif name in ("meshgraphnet", "graphcast"):
        mcfg = G.graphcast_mgn(cfg) if name == "graphcast" else cfg
        loss = lambda prm, pgl, pl, bt: GD.dist_mgn_loss(
            mcfg, prm, pgl, pl, bt, mesh, residual=name == "graphcast")
    else:
        loss = lambda prm, pgl, pl, bt: GD.dist_mace_loss(cfg, prm, pgl, pl,
                                                         bt, mesh)
    step = GD.make_dist_train_step(loss, opt, mesh)
    specs = _gnn_param_specs(spec, cfg)

    def make(seed, dev):
        graph = _real_partition(spec, cfg, n, e, d_feat, mesh, seed, dev)
        params = _draw(specs, seed, dev)
        return (params, opt.init(params)) + graph

    def synth(seed, dev):
        from . import synth as S

        pg, plan, weights = S.synth_partitioned_graph(n, e, mesh.p, dev)
        batch = S.synth_gnn_batch(model, cfg, pg, d_feat, dev)
        params = _draw(specs, seed, dev)
        args = (pg, plan, weights, batch) if model == "gcn" else \
            (pg, plan, batch)
        return (params, opt.init(params)) + args

    return Cell(spec.name, shape_name, "dist_full", step, mesh, cfg, make,
                synth, {"n": n, "e": e, "d_feat": d_feat})


def gnn_graph(spec, cfg, n: int, e: int, d_feat: int, seed: int) -> dict:
    """The host data of a ``dist_full`` cell drawn from ``seed``: a
    cora-like graph of ``n`` vertices and about ``e`` edges, its node
    inputs and targets (GCN: features and labels; MGN family: features,
    edge features and targets; MACE: positions, species and an energy)."""
    from repro_torch.graphs.synthetic import cora_like

    model = _gnn_model(spec)
    d_in, d_out, d_edge = _dims_of(model, cfg)
    width = d_feat if model == "gcn" else d_in
    g, feats, labels, mask = cora_like(n=n, avg_deg=max(e // n, 1),
                                       d_feat=width, seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = {"graph": g, "feats": feats, "labels": labels, "mask": mask}
    if model == "mgn":
        out["edge_feats"] = rng.normal(size=(g.m, d_edge)).astype(np.float32)
        out["targets"] = rng.normal(size=(g.n, d_out)).astype(np.float32)
    if model == "mace":
        out["positions"] = (rng.normal(size=(g.n, 3)) * 2).astype(np.float32)
        out["species"] = rng.integers(0, cfg.n_species, g.n).astype(np.int32)
        out["energy"] = float(rng.normal())
    return out


def _real_partition(spec, cfg, n, e, d_feat, mesh, seed: int, dev) -> tuple:
    """This rank's partition of :func:`gnn_graph` (``p`` = the world, TH
    four times the mean degree), its plan, its edge weights (GCN: "sym")
    and its rows of the batch, on ``dev``."""
    from repro_torch.core import bfs as B, engine as E
    from repro_torch.core.partition import partition_graph
    from repro_torch.train import gnn_batches as GB

    model = _gnn_model(spec)
    data = gnn_graph(spec, cfg, n, e, d_feat, seed)
    g = data["graph"]
    pg = partition_graph(g, th=max(8, 4 * max(e // n, 1)), p_rank=mesh.p)
    plan = E.build_exchange_plan(pg)
    r = mesh.rank
    pgv = B.device_view(B.local_partition(pg, r), dev)
    dplan = E.device_plan(E.local_plan(plan, r), dev)
    if model == "gcn":
        batch = GB.gcn_batch(pg, data["feats"], data["labels"], data["mask"])
    elif model == "mgn":
        batch = GB.mgn_batch(pg, data["feats"], data["edge_feats"],
                             data["targets"])
    else:
        batch = GB.mace_batch(pg, data["positions"], data["species"],
                              data["energy"])
    batch = GB.batch_to_device(batch, dev, r)
    if model == "gcn":
        w = E.device_weights(E.build_edge_weights(pg, g.out_degrees(), "sym"),
                             dev, r)
        return pgv, dplan, w, batch
    return pgv, dplan, batch


def _batched_gnn_cell(spec, shape_name, kind, cfg, mesh, opt, lead_axes,
                      node_cap: int, edge_cap: int, lead: int) -> Cell:
    """A data-parallel step over ``lead`` independent graphs split over
    ``lead_axes``: each rank the graphs of its block."""
    from repro_torch.models import equivariant as EQ, gnn as G
    from repro_torch.train.trainer import value_and_grad

    model = _gnn_model(spec)
    name = _base_name(spec)
    specs = _gnn_param_specs(spec, cfg)

    def single(prm, bt):
        if model == "gcn":
            gb = G.GraphBatch(nodes=bt["nodes"], senders=bt["senders"],
                              receivers=bt["receivers"],
                              edge_mask=bt["senders"] < node_cap)
            return G.gcn_loss(cfg, prm, gb, bt["labels"], bt["mask"])
        if model == "mgn":
            gb = G.GraphBatch(nodes=bt["nodes"], senders=bt["senders"],
                              receivers=bt["receivers"],
                              edge_feats=bt["edge_feats"],
                              node_mask=bt["mask"],
                              edge_mask=bt["senders"] < node_cap)
            if name == "graphcast":
                return G.graphcast_loss(cfg, prm, gb, bt["targets"])
            return G.mgn_loss(cfg, prm, gb, bt["targets"])
        gb = G.GraphBatch(nodes=None, senders=bt["senders"],
                          receivers=bt["receivers"], node_mask=bt["mask"],
                          positions=bt["positions"], species=bt["species"])
        return EQ.mace_loss(cfg, prm, gb, bt["energy"][None])

    def local_loss(prm, bt):
        n_loc = next(iter(bt.values())).shape[0]
        return sum(single(prm, {k: v[i] for k, v in bt.items()})
                   for i in range(n_loc)) / lead

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(local_loss, params, batch)
        loss, grads = _sum_over(mesh, lead_axes, (loss, grads))
        new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    def make(seed, dev):
        lo, hi = dim_span(lead, mesh.size(lead_axes) if lead_axes else 1,
                          mesh.index(lead_axes) if lead_axes else 0)
        batch = gnn_batch_arrays(model, cfg, lead, node_cap, edge_cap, seed)
        params = _draw(specs, seed, dev)
        return params, opt.init(params), {
            k: torch.from_numpy(v[lo:hi]).to(dev) for k, v in batch.items()}

    return Cell(spec.name, shape_name, kind, step, mesh, cfg, make,
                info={"lead": lead, "lead_axes": lead_axes,
                      "node_cap": node_cap, "edge_cap": edge_cap})


def gnn_batch_arrays(model: str, cfg, lead: int, node_cap: int,
                     edge_cap: int, seed: int) -> dict:
    """``lead`` graphs of ``node_cap`` nodes and ``edge_cap`` edge slots
    drawn from ``seed`` (numpy, the reference's batch layout): endpoints
    uniform over the nodes, an eighth of the slots padding (sender =
    ``node_cap``)."""
    rng = np.random.default_rng(seed)
    ends = rng.integers(0, node_cap, (2, lead, edge_cap)).astype(np.int32)
    pad = rng.random((lead, edge_cap)) < 0.125
    ends[:, pad] = node_cap
    out = {"senders": ends[0], "receivers": ends[1],
           "mask": rng.random((lead, node_cap)) < 0.75}
    d_in, d_out, d_edge = _dims_of(model, cfg)
    if model == "gcn":
        out["nodes"] = rng.normal(size=(lead, node_cap, d_in)).astype(np.float32)
        out["labels"] = rng.integers(0, cfg.n_classes, (lead, node_cap)
                                     ).astype(np.int32)
    elif model == "mgn":
        out["nodes"] = rng.normal(size=(lead, node_cap, d_in)).astype(np.float32)
        out["edge_feats"] = rng.normal(size=(lead, edge_cap, d_edge)
                                       ).astype(np.float32)
        out["targets"] = rng.normal(size=(lead, node_cap, d_out)
                                    ).astype(np.float32)
    else:
        out["positions"] = (rng.normal(size=(lead, node_cap, 3)) * 2
                            ).astype(np.float32)
        out["species"] = rng.integers(0, cfg.n_species, (lead, node_cap)
                                      ).astype(np.int32)
        out["energy"] = rng.normal(size=(lead,)).astype(np.float32)
    return out


def _dims_of(model: str, cfg) -> tuple:
    """``(node inputs, node outputs, edge inputs)`` of a GNN config."""
    if model == "gcn":
        return cfg.d_in, cfg.n_classes, 0
    if model == "mgn":
        if hasattr(cfg, "n_vars"):
            return cfg.n_vars, cfg.n_vars, cfg.d_edge_in
        return cfg.d_node_in, cfg.d_out, cfg.d_edge_in
    return 3, 1, 0


# -------------------------------------------------------------------- recsys
def build_recsys_cell(spec, shape_name: str, mesh, smoke: bool = False,
                      layers_override: int = 0) -> Cell:
    """``train``: ``train.recsys.make_sharded_recsys_train_step`` (the
    cold rows over the axes of the spec's ``table_rows`` rule, each rank
    its rows of the batch); ``serve``: ``step(params, batch) -> logits``
    of its rows, the same routed lookup without the backward;
    ``retrieval``: ``step(params, batch, candidates) -> (scores, ids)``,
    every rank the whole query batch, its block of the candidates over the
    data axes, each block's top 100 merged over those axes (ids global)."""
    from repro_torch.models import recsys as R
    from repro_torch.train.recsys import make_sharded_recsys_train_step

    cfg = spec.smoke if smoke else spec.model
    shape = dict(spec.shapes[shape_name])
    b = shape["batch"] if not smoke else 8
    rules = spec.rules_override
    axes = R.table_axes(mesh, rules)
    q, s = mesh.size(axes), mesh.index(axes)
    kind = shape["kind"]
    opt = lm_optimizer(spec)

    def params_of(seed, dev):
        from repro_torch.core.convert import xdeepfm_shard_params

        return xdeepfm_shard_params(R.init_params(cfg, seed, dev), s, q)

    def batch_of(seed, dev, rows: int, split: bool):
        # numpy, so the ids stay real tensors in the dry run (routing
        # reads their owner counts on the host)
        rng = np.random.default_rng(seed)
        f = cfg.n_sparse
        hot = rng.integers(0, cfg.n_hot, (rows, f), dtype=np.int32)
        cold = rng.integers(0, cfg.n_cold, (rows, f), dtype=np.int32)
        is_hot = rng.random((rows, f)) < 0.5
        batch = {"hot_idx": np.where(is_hot, hot, -1).astype(np.int32),
                 "cold_idx": np.where(is_hot, -1, cold).astype(np.int32),
                 "labels": rng.integers(0, 2, rows, dtype=np.int32)}
        if split:
            lo, hi = dim_span(rows, mesh.p, mesh.rank)
            batch = {k: v[lo:hi] for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}

    if kind == "train":
        step = make_sharded_recsys_train_step(cfg, opt, mesh, rules=rules)

        def make(seed, dev):
            params = params_of(seed, dev)
            return params, opt.init(params), batch_of(seed, dev, b, True)
        return Cell(spec.name, shape_name, kind, step, mesh, cfg, make,
                    info={"batch": b, "table_axes": axes})

    if kind == "serve":
        @torch.no_grad()
        def step(params, batch):
            route = R.route_cold(mesh, batch["cold_idx"], axes)
            return R.xdeepfm_logits(cfg, params, batch["hot_idx"],
                                    batch["cold_idx"], route=route)

        def make(seed, dev):
            batch = batch_of(seed, dev, b, True)
            batch.pop("labels")
            return params_of(seed, dev), batch
        return Cell(spec.name, shape_name, kind, step, mesh, cfg, make,
                    info={"batch": b, "table_axes": axes})

    if kind == "retrieval":
        nc = shape["n_candidates"] if not smoke else 512
        da = data_axes(mesh)

        @torch.no_grad()
        def step(params, batch, candidates):
            from repro_torch.core.comm import dist as D

            route = R.route_cold(mesh, batch["cold_idx"], axes)
            qv = R.query_vectors(cfg, params, batch["hot_idx"],
                                 batch["cold_idx"], route)
            lo = dim_span(nc, mesh.size(da), mesh.index(da))[0] if da else 0
            vals, idx = torch.topk(qv @ candidates.T, 100)
            if not da or mesh.size(da) == 1:
                return vals, idx + lo
            every_v = D.all_gather(mesh, vals.contiguous(), da)
            every_i = D.all_gather(mesh, (idx + lo).contiguous(), da)
            k = every_v.shape[0]
            flat_v = every_v.permute(1, 0, 2).reshape(vals.shape[0], k * 100)
            flat_i = every_i.permute(1, 0, 2).reshape(vals.shape[0], k * 100)
            top_v, pos = torch.topk(flat_v, 100)
            return top_v, flat_i.gather(1, pos)

        def make(seed, dev):
            batch = batch_of(seed, dev, shape["batch"] if not smoke else 8,
                             False)
            batch.pop("labels")
            lo, hi = (dim_span(nc, mesh.size(da), mesh.index(da)) if da
                      else (0, nc))
            return (params_of(seed, dev), batch,
                    _block_randn(seed + 7, nc, cfg.d_query, lo, hi, dev))
        return Cell(spec.name, shape_name, kind, step, mesh, cfg, make,
                    info={"n_candidates": nc, "table_axes": axes})
    raise ValueError(kind)


def _block_randn(seed: int, n: int, d: int, lo: int, hi: int, dev
                 ) -> torch.Tensor:
    """Rows ``[lo, hi)`` of an ``[n, d]`` N(0, 1) matrix drawn in blocks of
    4,096 rows, each from its own generator: any split of the rows draws
    the same values."""
    out = []
    blk = 4096
    for b0 in range(lo // blk * blk, hi, blk):
        gen = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + b0)
        rows = torch.randn((min(blk, n - b0), d), generator=gen, device=dev)
        out.append(rows[max(lo - b0, 0):hi - b0])
    return torch.cat(out)


# ----------------------------------------------------------------------- BFS
def build_bfs_cell(spec, shape_name: str, mesh, smoke: bool = False,
                   layers_override: int = 0) -> Cell:
    """``core.bfs.make_sharded_bfs`` over every axis of the mesh:
    ``step(pg, [plan,] state) -> state`` on this rank's partition of an
    RMAT graph of the shape's scale (``scale_per_device`` plus log2 of the
    world for the weak-scaling shape; 12 at ``smoke``), edge factor 32
    (Graph500's 16, doubled), from one search key drawn from the seed."""
    from repro_torch.core import bfs as B

    cfg = spec.smoke if smoke else spec.model
    shape = dict(spec.shapes[shape_name])
    p = mesh.p
    if smoke:
        scale = 12
    elif "scale" in shape:
        scale = shape["scale"]
    else:
        scale = shape["scale_per_device"] + int(math.log2(p))
    n = 1 << scale
    e = n * 32
    run = B.make_sharded_bfs(mesh, mesh.axes, cfg,
                             with_plan=cfg.static_exchange)

    def make(seed, dev):
        from repro_torch.core import engine as E
        from repro_torch.core.partition import partition_graph
        from repro_torch.graphs.rmat import pick_sources, rmat_graph

        g = rmat_graph(scale, 16, seed)
        pg = partition_graph(g, th=64, p_rank=p)
        src = int(pick_sources(g, 1, seed + 1)[0])
        pgv = B.device_view(B.local_partition(pg, mesh.rank), dev)
        state = B.init_state(pg, src, cfg, dev, mesh)
        if cfg.static_exchange:
            plan = E.device_plan(E.local_plan(E.build_exchange_plan(pg),
                                              mesh.rank), dev)
            return pgv, plan, state
        return pgv, state

    def synth(seed, dev):
        from . import synth as S

        pg, plan, _ = S.synth_partitioned_graph(n, e, p, dev, d_frac=0.0175,
                                                nn_frac=0.063)
        state = S.synth_bfs_state(pg, cfg, dev)
        return (pg, plan, state) if cfg.static_exchange else (pg, state)

    return Cell(spec.name, shape_name, "bfs", run, mesh, cfg, make, synth,
                {"scale": scale, "n": n, "e": e})


# ----------------------------------------------------------------- dispatch
def build_cell(arch: str, shape_name: str, mesh, smoke: bool = False,
               layers_override: int = 0):
    """The cell of ``arch`` x ``shape_name`` on this rank of ``mesh``; a
    shape the arch skips raises ``ValueError``."""
    from repro_torch.configs.base import get_arch

    spec = get_arch(arch)
    if shape_name in spec.skip:
        raise ValueError(f"{arch}/{shape_name} skipped: {spec.skip[shape_name]}")
    builder = {
        "lm": build_lm_cell, "gnn": build_gnn_cell,
        "recsys": build_recsys_cell, "bfs": build_bfs_cell,
    }[spec.family]
    return builder(spec, shape_name, mesh, smoke,
                   layers_override=layers_override)


def all_cells(include_skipped: bool = False) -> list:
    """``(arch, shape, skip reason or None)`` of every registered arch's
    shapes, in the reference's order."""
    from repro_torch.configs.base import all_archs, get_arch

    out = []
    for arch in all_archs():
        spec = get_arch(arch)
        for shape_name in spec.shapes:
            skipped = shape_name in spec.skip
            if skipped and not include_skipped:
                continue
            out.append((arch, shape_name, spec.skip.get(shape_name)))
    return out
