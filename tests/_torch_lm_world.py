"""World function of the LM-on-a-mesh tests (``test_torch_lm_mesh.py``),
and the inputs it shares with the parent.

One world of ``WORLD`` gloo ranks builds the three meshes of ``MESHES``
(every rank in the same order) and runs, on each, the train cell
(``launch.cells.build_lm_cell``, smoke) of every spec of ``ARCHS`` from
the parameters the parent drew (the reference's, as numpy) on the global
batch :func:`batch` (each rank its rows, ``cell.rows``): the first step's
loss, metrics and gradient (``trainer.mesh_value_and_grad``) and its
update (``trainer.mesh_update``), then ``STEPS - 1`` steps of
``cell.step``. The ``-opt`` specs route in groups
(their smoke config's ``moe_groups`` set to ``-1``, the data size). On the
``2x2`` mesh the MoE spec also runs at ``grad_accum = 2``, and on every
mesh the routing of :func:`routing_case` builds its global dispatch table.
Everything comes back as numpy; the parent compares. Port imports only:
a spawned rank imports no JAX."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import convert
from repro_torch.launch import cells, mesh as M
from repro_torch.launch.sharding import draw_tree, rules_for
from repro_torch.models import lm as LM, moe as MO
from repro_torch.models.common import Parallel
from repro_torch.train.trainer import (make_mesh_train_step, mesh_update,
                                       mesh_value_and_grad, shard_rows,
                                       wire_since)
from repro_torch.tree import flatten_with_path, tree_map

WORLD = 4
#: name -> (axes, sizes): data and model, a ragged model axis (granite's 6
#: heads over 4), and two pods
MESHES = {"2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4)),
          "pod": (("pod", "data", "model"), (2, 1, 2))}
ARCHS = ("gemma3-1b", "granite-34b", "qwen2.5-14b", "kimi-k2-1t-a32b",
         "qwen2-moe-a2.7b", "kimi-k2-1t-a32b-opt", "qwen2-moe-a2.7b-opt")
BATCH, SEQ, STEPS = 4, 16, 2
ACCUM_ARCH, ACCUM = "qwen2-moe-a2.7b", 2
#: routing_case: global tokens, experts, top-k and a capacity that drops
ROUTE_T, ROUTE_E, ROUTE_K, ROUTE_CAP = 64, 8, 2, 8


def arch_spec(arch: str):
    """The registered spec; an ``-opt`` spec's smoke config routes in
    groups (``moe_groups = -1``: the data size, as its full config)."""
    spec = get_arch(arch)
    if arch.endswith("-opt"):
        spec = dataclasses.replace(spec, smoke=dataclasses.replace(
            spec.smoke, moe_groups=-1))
    return spec


def data_size(mesh_name: str) -> int:
    axes, sizes = MESHES[mesh_name]
    return int(np.prod([s for a, s in zip(axes, sizes) if a != "model"]))


def batch(vocab: int) -> dict:
    toks = np.random.default_rng(3).integers(
        0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def routing_case() -> tuple:
    """``(top_i [T, K], top_w [T, K])`` of a global token set, skewed so
    some experts overflow ``ROUTE_CAP``."""
    rng = np.random.default_rng(5)
    p = np.arange(ROUTE_E, 0, -1, dtype=np.float64) ** 2
    top_i = np.stack([rng.choice(ROUTE_E, ROUTE_K, replace=False, p=p / p.sum())
                      for _ in range(ROUTE_T)])
    top_w = rng.random((ROUTE_T, ROUTE_K)).astype(np.float32)
    return top_i.astype(np.int64), top_w


def _np(tree):
    return convert.tree_to_numpy(tree)


def _train(cell, params, rows, step) -> dict:
    """The first step taken apart (its gradient kept), then STEPS - 1
    steps of ``step``."""
    before = dict(cell.par.tally)
    loss, metrics, grads = mesh_value_and_grad(
        lambda p, b: LM.loss_fn(cell.cfg, p, b, cell.par), params, rows,
        cell.par, cell.shardings, cell.accum)
    p, st, norm = mesh_update(cell.optimizer, grads,
                              cell.optimizer.init(params), params, cell.par,
                              cell.shardings)
    out = {"loss": float(loss), "ce": float(metrics["ce"]),
           "aux": float(metrics["aux"]), "grads": _np(grads)}
    losses, norms = [float(loss)], [float(norm)]
    wire = [wire_since(cell.par, before)]
    for _ in range(STEPS - 1):
        p, st, m = step(p, st, rows)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        wire.append(dict(m["wire"]))
    return dict(out, params=_np(p), losses=losses, norms=norms, wire=wire,
                reckoned=cells.lm_wire_bytes(cell, rows["tokens"].shape[0],
                                             SEQ))


def _routing(mesh) -> dict:
    """Global routing of :func:`routing_case` over the data ranks, each
    rank its tokens and its experts' rows, as ``moe._moe_mesh_group``
    dispatches them (``local_slots``); each rank's slots are put back at
    their global positions (the lower data ranks' pairs of the expert
    before them) and token ids, and the tables summed over the world: the
    global table."""
    par = Parallel(mesh, rules_for(mesh))
    i, n = par.index(par.data), par.size(par.data)
    top_i, top_w = (torch.from_numpy(a) for a in routing_case())
    per = ROUTE_T // n
    mine_i, mine_w = top_i[i * per:(i + 1) * per], top_w[i * per:(i + 1) * per]
    _, offsets = MO.data_counts(mine_i, ROUTE_E, par)
    lo, hi = par.span("experts", ROUTE_E)
    tok, w = MO.dispatch(mine_i, mine_w, ROUTE_CAP, ROUTE_E, offsets=offsets,
                         experts=(lo, hi), local_slots=True)
    glob_tok = torch.full((ROUTE_E, ROUTE_CAP), -1, dtype=torch.int64)
    glob_w = torch.zeros((ROUTE_E, ROUTE_CAP), dtype=torch.float32)
    for e in range(lo, hi):
        filled = torch.nonzero(tok[e - lo] >= 0).reshape(-1)
        at = filled + offsets[e]
        glob_tok[e, at] = tok[e - lo, filled] + i * per
        glob_w[e, at] = w[e - lo, filled]
    order, _, _, keep = MO.kept_pairs(mine_i, ROUTE_CAP, offsets)
    kept = torch.zeros(per * ROUTE_K, dtype=torch.bool)
    kept[order] = keep
    every = par.data + par.axes("experts")
    glob_tok = par.all_reduce(glob_tok, every, "max")
    glob_w = par.all_reduce(glob_w, every, "sum")
    kept = par.all_gather(kept.reshape(per, ROUTE_K), par.data)
    return {"tok": glob_tok.numpy(), "w": glob_w.numpy(),
            "kept": kept.reshape(ROUTE_T, ROUTE_K).numpy()}


def lm_world(rank: int, world: int, params_np: dict) -> dict:
    """Every mesh of MESHES, every spec of ARCHS (and the accumulation and
    routing cases) on this rank; ``params_np``: arch -> the whole numpy
    parameter tree."""
    torch.manual_seed(0)
    out = {}
    for name, (axes, sizes) in MESHES.items():
        mesh = M.make_test_mesh(sizes, axes)
        for arch in ARCHS:
            cell = cells.build_lm_cell(arch_spec(arch), "train_4k", mesh,
                                       smoke=True)
            params = cell.shard_params(convert.tree_from_numpy(
                params_np[arch], "cpu"))
            rows = cell.rows({k: torch.from_numpy(v)
                              for k, v in batch(cell.cfg.vocab).items()})
            out[name, arch] = _train(cell, params, rows, cell.step)
            if name == "2x2" and arch == ACCUM_ARCH:
                cell.accum = ACCUM
                step = make_mesh_train_step(
                    lambda p, b: LM.loss_fn(cell.cfg, p, b, cell.par),
                    cell.optimizer, cell.par, cell.shardings, ACCUM)
                rows = shard_rows({k: torch.from_numpy(v) for k, v in
                                   batch(cell.cfg.vocab).items()},
                                  *cell.data_index, ACCUM)
                out[name, "accum"] = dict(_train(cell, params, rows, step),
                                          rows=rows["tokens"].numpy())
        out[name, "routing"] = _routing(mesh)
    return out


# ------------------------------------------------------------- on the card
#: the world-1 NCCL card test's smoke specs (MoE + AdamW, MoE + Adafactor
#: with the FSDP rule, dense GELU + Adafactor)
CARD_ARCHS = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "granite-34b")


def one_rank_world(rank: int, world: int, archs: tuple) -> dict:
    """A world of one rank (NCCL on the card): each smoke spec's cell on
    the mesh (1, 1) and the one-device step (``trainer.make_train_step``)
    from the same parameters (``materialize``, seed 0, float32, TF32 off),
    STEPS steps each on :func:`batch`: losses and parameters, as numpy."""
    from repro_torch.models.common import materialize
    from repro_torch.train.trainer import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = M.make_test_mesh((1, 1))
    out = {}
    for arch in archs:
        cell = cells.build_lm_cell(arch_spec(arch), "train_4k", mesh,
                                   smoke=True)
        cfg = cell.cfg
        start = materialize(LM.lm_param_specs(cfg), 0, dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch(cfg.vocab).items()}
        one = make_train_step(lambda p, bt: LM.loss_fn(cfg, p, bt),
                              cell.optimizer)
        for name, step in (("mesh", cell.step), ("one", one)):
            p, st, losses = start, cell.optimizer.init(start), []
            for _ in range(STEPS):
                p, st, m = step(p, st, b)
                losses.append(float(m["loss"]))
            out[arch, name] = {"losses": losses, "params": _np(p)}
        out[arch, "start"] = _np(start)
    return out


def whole_params(cell, seed: int, device) -> dict:
    """The whole initial tree whose blocks ``cell.draw_params(seed)``
    draws on each rank (``sharding.draw_tree`` without a layout)."""
    return draw_tree(LM.lm_param_specs(cell.cfg), seed, cell.rules,
                     cell.mesh.axes, cell.mesh.sizes, None, device,
                     LM.lm_units(cell.cfg))


def full_width_rank(rank: int, world: int, spec: dict) -> dict:
    """A rank of a NCCL world of ``spec["sizes"]`` (one card a rank): the
    one-card step of ``spec["arch"]`` at FULL widths and
    ``spec["layers"]`` layers on the whole tree the mesh's ranks draw
    (this rank's card; its blocks of the result kept on the host), then
    the mesh step from this rank's blocks (AdamW from step
    ``spec["from"]``), then ``spec["timed"]`` more mesh steps (ms a step,
    synchronised). Returns the losses, each leaf's squared distance to the
    one-card step and squared change, the wire bytes as counted and from
    shapes, and the ms a step. ``spec["device"] == "cpu"`` rehearses it
    on gloo ranks."""
    import time

    from repro_torch.data.tokens import TokenStream
    from repro_torch.train.trainer import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = spec.get("device", "cuda") != "cpu"
    dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
           else torch.device("cpu"))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = M.make_test_mesh(spec["sizes"])
    cell = cells.build_lm_cell(get_arch(spec["arch"]), "train_4k", mesh,
                               layers_override=spec["layers"])
    cfg, opt = cell.cfg, cell.optimizer

    def state(p):
        s = opt.init(p)
        s["step"].fill_(spec["from"])
        return s

    b = {k: torch.from_numpy(v).to(dev) for k, v in TokenStream(
        cfg.vocab, spec["seq"], spec["batch"], seed=0).batch(0).items()}
    whole = whole_params(cell, 0, dev)
    one = make_train_step(lambda p, bt: LM.loss_fn(cfg, p, bt), opt)
    p1, _, m1 = one(whole, state(whole), b)
    want = tree_map(lambda t: t.cpu(), cell.shard_params(p1))
    one_loss = float(m1["loss"])
    del whole, p1, m1
    torch.cuda.empty_cache()
    start = cell.draw_params(0, dev)
    rows = cell.rows(b)
    p, st, m = cell.step(start, state(start), rows)
    out = {"loss": float(m["loss"]), "one_loss": one_loss,
           "wire": dict(m["wire"]),
           "reckoned": cells.lm_wire_bytes(cell, rows["tokens"].shape[0],
                                           spec["seq"])}
    sq = {}
    for (k, g), (_, w), (_, s0) in zip(*(flatten_with_path(t)
                                         for t in (p, want, start))):
        w = w.to(dev)
        sq[k] = (float((g.double() - w.double()).square().sum()),
                 float((w.double() - s0.double()).square().sum()))
    out["sq"] = sq
    del want, start
    ms = []
    for _ in range(spec["timed"]):
        sync()
        t0 = time.perf_counter()
        p, st, m = cell.step(p, st, rows)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = ms
    out["sharded"] = {k: cell.par.size(sh.sharded) > 1 for k, sh in
                      flatten_with_path(cell.shardings)}
    out["peak"] = torch.cuda.max_memory_allocated() if on_card else 0
    return out
