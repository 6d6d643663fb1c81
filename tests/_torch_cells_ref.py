"""Parent-side helpers of the cell tests (``test_torch_cells.py``,
``test_torch_cells_gnn.py``): the reference's cells on a one-device mesh
(each jitted once per module; a ``-opt`` variant that computes its base's
function on one rank shares its base's), the reference's arguments of the
graph cells rebuilt from the rank's seed, and the checks."""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import _torch_cells_world as W
from _torch_lm import LOGIT, PRIM
from repro.configs import base as RCB, get_arch as ref_arch
from repro.core import bfs as RB, engine as RE
from repro.core.partition import partition_graph as ref_partition
from repro.core.types import COOGraph as RCOO
from repro.launch import cells as RC
from repro.launch.mesh import make_test_mesh
from repro.train import gnn_batches as RGB, optim as RO
from repro_torch.configs.base import get_arch
from repro_torch.core import comm as TC, convert
from repro_torch.graphs.rmat import pick_sources, rmat_graph
from repro_torch.launch import cells as TCL
from repro_torch.tree import flatten_with_path

# the reference loads its registry only while it is empty
RCB._load_all()

#: the parameters after a step: each leaf within PARAM_REL of its change
PARAM_REL = 1e-3
#: on one rank these compute their base's function (grouped routing in one
#: group is the global routing; mace-opt's knobs act on the distributed
#: path only; the BFS shapes are one scale-12 graph at smoke), so the
#: reference's cell of the base serves them
SAME_AS = {("kimi-k2-1t-a32b-opt", "train_4k"): ("kimi-k2-1t-a32b", "train_4k"),
           ("qwen2-moe-a2.7b-opt", "train_4k"): ("qwen2-moe-a2.7b", "train_4k"),
           ("mace-opt", "molecule"): ("mace", "molecule"),
           ("bfs-rmat", "rmat_weak"): ("bfs-rmat", "rmat_s30")}


def spawn_world(cases) -> dict:
    return TC.dist.spawn(W.cells_world, 1, (cases,), timeout=300.0)[0]


@functools.lru_cache(maxsize=None)
def mesh1():
    return make_test_mesh((1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def ref_cell(arch: str, shape: str):
    arch, shape = SAME_AS.get((arch, shape), (arch, shape))
    return RC.build_cell(arch, shape, mesh1(), smoke=True)[0]


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_opt(arch: str):
    return RO.get_optimizer(ref_arch(arch).optimizer,
                            lr=RO.cosine_schedule(3e-4, 100, 10000))


def params_close(got, want, start) -> None:
    got, want, start = (dict(flatten_with_path(t)) for t in (got, want, start))
    assert sorted(got) == sorted(want)
    for k in want:
        moved = float(np.linalg.norm((want[k] - start[k]).astype(np.float64)))
        diff = float(np.linalg.norm((got[k] - want[k]).astype(np.float64)))
        assert diff <= PARAM_REL * moved + 1e-6, (k, diff, moved)


def train_outputs(res, out) -> None:
    new_params, _, metrics = out
    loss = metrics["loss"] if isinstance(metrics, dict) else metrics
    np.testing.assert_allclose(res["loss"],
                               float(np.asarray(loss).reshape(-1)[0]), **PRIM)
    params_close(res["params"], np_tree(new_params), res["start"])


def dist_full_args(arch: str):
    """The reference's arguments of a ``dist_full`` cell: the partition,
    plan, weights and batch of the graph ``cells.gnn_graph`` draws from
    the rank's seed, and ``materialize``'s parameters (the rank's)."""
    from repro_torch.models.common import materialize

    spec = get_arch(arch)
    cfg = spec.smoke
    n, e, d_feat = 512, 2048, getattr(cfg, "d_in", 16)
    data = TCL.gnn_graph(spec, cfg, n, e, d_feat, W.SEED)
    g = data["graph"]
    rpg = ref_partition(RCOO(g.n, g.src, g.dst), th=max(8, 4 * (e // n)),
                        p_rank=1)
    model = TCL._gnn_model(spec)
    if model == "gcn":
        batch = RGB.gcn_batch(rpg, data["feats"], data["labels"], data["mask"])
    elif model == "mgn":
        batch = RGB.mgn_batch(rpg, data["feats"], data["edge_feats"],
                              data["targets"])
    else:
        batch = RGB.mace_batch(rpg, data["positions"], data["species"],
                               data["energy"])
    graph = [RB.device_view(rpg), jnp_tree(RE.build_exchange_plan(rpg))]
    if model == "gcn":
        graph.append(jnp_tree(RE.build_edge_weights(rpg, g.out_degrees(),
                                                    "sym")))
    params = convert.tree_to_numpy(materialize(
        TCL._gnn_param_specs(spec, cfg), W.SEED, "cpu"))
    return params, graph, jnp_tree(batch)


def bfs_args(arch: str):
    cfg = ref_arch(arch).smoke
    g = rmat_graph(12, 16, W.SEED)
    src = int(pick_sources(g, 1, W.SEED + 1)[0])
    rpg = ref_partition(RCOO(g.n, g.src, g.dst), th=64, p_rank=1)
    state = jnp_tree(RB.init_state(rpg, src, cfg))
    if cfg.static_exchange:
        return RB.device_view(rpg), jnp_tree(RE.build_exchange_plan(rpg)), state
    return RB.device_view(rpg), state


def world_and_reference(cases, threads: int = 4) -> tuple:
    """``(world, reference)``: the rank's outputs (:func:`spawn_world`) and
    the reference's on the same arguments, in a pool of threads (XLA
    compiles with the GIL released): the graph cells, whose arguments the
    parent rebuilds from the seed, beside the rank's world; the others
    once the rank has returned its arguments."""
    from concurrent.futures import ThreadPoolExecutor

    def own(c):
        return (get_arch(c[0]).family == "bfs"
                or get_arch(c[0]).shapes[c[1]]["kind"] == "dist_full")

    ref = lambda res, c: np_tree(run_reference(res, *c))
    with ThreadPoolExecutor(threads) as pool:
        world = pool.submit(spawn_world, cases)
        first = {c: pool.submit(ref, None, c) for c in cases if own(c)}
        world = world.result()
        rest = {c: pool.submit(ref, world[c], c) for c in cases if not own(c)}
        return world, {c: f.result() for c, f in {**first, **rest}.items()}


def run_reference(res: dict, arch: str, shape: str):
    """The reference's cell on the arguments the rank drew."""
    fn = ref_cell(arch, shape)
    family, kind = get_arch(arch).family, get_arch(arch).shapes[shape]["kind"]
    if family == "bfs":
        out = fn(*bfs_args(arch))
        return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}
    if kind == "dist_full":
        params, graph, batch = dist_full_args(arch)
        p = jnp_tree(params)
        return fn(p, ref_opt(arch).init(p), *graph, batch)
    if kind in ("train", "minibatch", "batched_small"):
        p = jnp_tree(res["start"])
        return fn(p, ref_opt(arch).init(p), jnp_tree(res["args"]))
    if kind == "serve":
        return fn(jnp_tree(res["params"]), jnp_tree(res["batch"]))
    if kind == "retrieval":
        return fn(jnp_tree(res["params"]), jnp_tree(res["batch"]),
                  jnp.asarray(res["candidates"]))
    if kind == "prefill":
        return fn(jnp_tree(res["params"]), jnp.asarray(res["tokens"]))
    return fn(jnp_tree(res["params"]), jnp_tree(res["cache_in"]),
              jnp.asarray(res["token"]), jnp.int32(res["pos"]))


def check_cell(res: dict, out, arch: str, shape: str) -> None:
    """The rank's outputs against the reference's (``out``) on the same
    arguments."""
    family, kind = get_arch(arch).family, get_arch(arch).shapes[shape]["kind"]
    if family == "bfs":
        for k, v in res["state"].items():
            np.testing.assert_array_equal(v, out[k], err_msg=k)
    elif kind in ("train", "minibatch", "batched_small", "dist_full"):
        train_outputs(res, out)
    elif kind == "serve":
        np.testing.assert_allclose(res["logits"], out, **PRIM)
    elif kind == "retrieval":
        np.testing.assert_allclose(res["scores"], out[0], **PRIM)
        np.testing.assert_array_equal(res["ids"], out[1])
    else:
        # the port's serving path against the reference's: the LM tests'
        # bound
        logits, cache = out
        np.testing.assert_allclose(res["logits"], logits, **LOGIT)
        for (k, got), (_, want) in zip(flatten_with_path(res["cache"]),
                                       flatten_with_path(cache)):
            np.testing.assert_allclose(got, want, **LOGIT, err_msg=k)
