"""World functions of the sharded GNN training tests, and the runs they
are held against.

Every rank of a spawned world (``repro_torch.core.comm.dist.spawn``)
builds the same graph and batch, keeps its own partition's rows, and runs
the distributed GCN and MeshGraphNet training steps (:func:`gnn_world`)
or the distributed MACE loss and a train step (:func:`mace_world`) over
its mesh (the differentiable collectives carry the backward); the parent
runs the same steps emulated (:func:`run_cases` / :func:`mace_cases` with
``mesh=None``). Port imports only: a spawned rank imports no JAX."""
import numpy as np

from repro_torch.core import bfs as B, comm as C, convert, engine as E
from repro_torch.core.partition import partition_graph
from repro_torch.graphs.synthetic import cora_like
from repro_torch.models import equivariant as EQ, gnn as G
from repro_torch.models.common import materialize
from repro_torch.train import gnn_batches as GB, gnn_dist as GD
from repro_torch.train.optim import SGD, AdamW

AXES = ("rank", "gpu")
SPEC = dict(n=96, avg_deg=4, d_feat=12, seed=3, th=10, sizes=(1, 2),
            steps=3, mgn_layers=2)


def views(spec: dict, device, mesh=None):
    """The graph, its partition, and the device views of the partitions
    this process holds (all of them without ``mesh``, its rank's row
    with one)."""
    g, feats, labels, mask = cora_like(n=spec["n"], avg_deg=spec["avg_deg"],
                                       d_feat=spec["d_feat"], seed=spec["seed"])
    pg = partition_graph(g, th=spec["th"], p_rank=spec["sizes"][0],
                         p_gpu=spec["sizes"][1])
    plan = E.build_exchange_plan(pg)
    w = E.build_edge_weights(pg, g.out_degrees(), "sym")
    part = None if mesh is None else mesh.rank
    if mesh is None:
        pgv, dplan = B.device_view(pg, device), E.device_plan(plan, device)
    else:
        pgv = B.device_view(B.local_partition(pg, part), device)
        dplan = E.device_plan(E.local_plan(plan, part), device)
    return g, feats, labels, mask, pg, pgv, dplan, E.device_weights(
        w, device, part), part


def run_cases(spec: dict, device="cpu", mesh=None) -> dict:
    """``steps`` GCN steps (SGD with momentum) and MGN steps (AdamW) from
    seeded parameters; returns each run's parameters and losses, numpy."""
    g, feats, labels, mask, pg, pgv, plan, w, part = views(spec, device, mesh)
    out = {}
    gcfg = G.GCNConfig(n_layers=2, d_in=spec["d_feat"], d_hidden=8, n_classes=7)
    batch = GB.batch_to_device(GB.gcn_batch(pg, feats, labels, mask), device,
                               part)
    params = materialize(G.gcn_param_specs(gcfg), 0, device)
    opt = SGD(lr=0.5, momentum=0.9)
    step = GD.make_dist_train_step(
        lambda prm, bt: GD.dist_gcn_loss(gcfg, prm, pgv, plan, w, bt, mesh),
        opt, mesh)
    out["gcn"] = _run(step, params, opt, batch, spec["steps"])
    rng = np.random.default_rng(0)
    mcfg = G.MGNConfig(n_layers=spec["mgn_layers"], d_hidden=8, mlp_layers=2,
                       d_node_in=spec["d_feat"], d_edge_in=4, d_out=3)
    ef = rng.normal(size=(g.m, 4)).astype(np.float32)
    tgt = rng.normal(size=(g.n, 3)).astype(np.float32)
    batch = GB.batch_to_device(GB.mgn_batch(pg, feats, ef, tgt), device, part)
    params = materialize(G.mgn_param_specs(mcfg), 1, device)
    opt = AdamW(lr=1e-2)
    step = GD.make_dist_train_step(
        lambda prm, bt: GD.dist_mgn_loss(mcfg, prm, pgv, plan, bt, mesh),
        opt, mesh)
    out["mgn"] = _run(step, params, opt, batch, spec["steps"])
    return out


def _run(step, params, opt, batch, steps: int) -> dict:
    state, losses = opt.init(params), []
    for _ in range(steps):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return {"params": convert.tree_to_numpy(params), "losses": losses}


def gnn_world(rank: int, world: int, spec: dict) -> dict:
    """Both training runs on this rank's partition, over a gloo mesh."""
    mesh = C.dist.PartitionMesh(AXES, spec["sizes"])
    return run_cases(spec, "cpu", mesh)


#: MACE over the same graph: atoms at seeded positions and species, the
#: reference test's small config, both fetch variants in float32
MACE = dict(d_hidden=4, n_rbf=4, n_species=5, target=0.5, lr=1e-2)


def mace_cases(spec: dict, device="cpu", mesh=None) -> dict:
    """The distributed MACE loss and one AdamW step from seeded
    parameters, with the full fetch and the positions-only fetch; returns
    each variant's loss before the step and parameters after it, numpy."""
    g, _, _, _, pg, pgv, plan, _, part = views(spec, device, mesh)
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(g.n, 3)).astype(np.float32) * 2
    species = rng.integers(0, MACE["n_species"], g.n).astype(np.int32)
    batch = GB.batch_to_device(GB.mace_batch(pg, pos, species,
                                             MACE["target"]), device, part)
    out = {}
    for pos_only in (False, True):
        cfg = EQ.MACEConfig(n_layers=2, d_hidden=MACE["d_hidden"],
                            n_rbf=MACE["n_rbf"], n_species=MACE["n_species"],
                            dist_fetch_pos_only=pos_only)
        params = materialize(EQ.mace_param_specs(cfg), 2, device)
        loss_fn = lambda prm, bt: GD.dist_mace_loss(cfg, prm, pgv, plan, bt,
                                                    mesh)
        opt = AdamW(lr=MACE["lr"])
        step = GD.make_dist_train_step(loss_fn, opt, mesh)
        params, _, loss = step(params, opt.init(params), batch)
        out["pos_only" if pos_only else "full"] = {
            "loss": float(loss), "params": convert.tree_to_numpy(params)}
    return out


def mace_world(rank: int, world: int, spec: dict) -> dict:
    """:func:`mace_cases` on this rank's partition, over a gloo mesh."""
    mesh = C.dist.PartitionMesh(AXES, spec["sizes"])
    return mace_cases(spec, "cpu", mesh)
