"""Distributed full-graph GNN training on the port's degree-separated
engine (``train/gnn_dist.py``, ``train/gnn_batches.py``, the GNN models),
against the JAX reference with the reference's own parameters carried
across (``convert.tree_from_numpy``), and against the single-device model.

Graphs: the reference GNN tests' ``cora_like(n=96, avg_deg=4, d_feat=12,
seed=3)`` over ``partition_graph(th=10, p_rank=2, p_gpu=2)`` (GCN), and
``mesh_batch(6, 6, ...)`` with two multimesh levels over ``th=7`` (six
hub delegates; MeshGraphNet and GraphCast, SMOKE configs). Each JAX
reference is computed once, in a module fixture.

Tolerances: the GCN forward ``rtol=1e-5, atol=1e-6``; the MGN and
GraphCast forwards (layer norms in a stack) ``rtol=1e-4, atol=1e-5``;
losses ``rtol=1e-5``; gradients ``rtol=2e-3, atol=2e-5``; the 5-step SGD
and AdamW trajectories ``rtol=5e-3, atol=5e-4`` (the reference tests'
bounds); the world-2 gloo mesh against the emulated run ``rtol=1e-5``
(parameters ``atol=1e-6``: the ranks sum gradients in another order, and
AdamW's update is the same size for a gradient near 0)."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import _torch_gnn_world as GW
from repro.core import bfs as RB, engine as RE
from repro.core.partition import partition_graph as ref_partition
from repro.graphs import synthetic as RS
from repro.models import gnn as RG
from repro.models.common import materialize as ref_materialize
from repro.train import gnn_batches as RGB, gnn_dist as RGD
from repro.train import optim as RO
from repro_torch.configs import gcn_cora, graphcast, meshgraphnet
from repro_torch.core import bfs as TB, comm as TC, convert, engine as TE
from repro_torch.models import gnn as TG
from repro_torch.train import gnn_batches as TGB, gnn_dist as TGD
from repro_torch.train import optim as TO
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import flatten_with_path

FWD = dict(rtol=1e-5, atol=1e-6)
FWD_MLP = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=2e-5)
TRAJ = dict(rtol=5e-3, atol=5e-4)
STEPS = 5
OPTS = {"sgd": dict(lr=0.5, momentum=0.9), "adamw": dict(lr=5e-2)}
WORLD_TIMEOUT = 300.0
#: the leaves whose gradients the reference's padding edges reach (C2)
ENC_EDGE_BIASES = tuple(f"['enc_edge']['{k}']" for k in ("b0", "b1", "ln_b"))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_trees(got, want, skip=(), **tol):
    got = dict(flatten_with_path(convert.tree_to_numpy(got)))
    want = dict(flatten_with_path(want))
    assert sorted(got) == sorted(want)
    for k in want:
        if k not in skip:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def lane0(tree):
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


def ref_config(cfg, cls):
    """The reference config of a port config (same fields, JAX dtype)."""
    kw = {k: v for k, v in vars(cfg).items() if k != "dtype"}
    return cls(**kw)


@pytest.fixture(scope="module")
def gcn():
    g, feats, labels, mask = RS.cora_like(n=96, avg_deg=4, d_feat=12, seed=3)
    rpg = ref_partition(g, th=10, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    cfg = gcn_cora.SMOKE
    rcfg = ref_config(cfg, RG.GCNConfig)
    rparams = np_tree(ref_materialize(RG.gcn_param_specs(rcfg), 0))
    rpgv, rplan = RB.device_view(rpg), RE.build_exchange_plan(rpg)
    rw = RE.build_edge_weights(rpg, g.out_degrees(), "sym")
    rbatch = RGB.gcn_batch(rpg, feats, labels, mask)
    jb = jax.tree.map(jnp.asarray, rbatch)
    gb = RG.GraphBatch(nodes=jnp.asarray(feats),
                       senders=jnp.asarray(g.src, jnp.int32),
                       receivers=jnp.asarray(g.dst, jnp.int32))
    loss_local = lambda prm, pgl, pl, wl, bt: RGD.dist_gcn_loss(
        rcfg, prm, pgl, pl, wl, bt, "p")

    def fwd_grad(prm, pgl, pl, wl, bt):
        out = RGD.dist_gcn_forward(rcfg, prm, pgl, pl, wl, bt["x_n"],
                                   bt["x_d"], "p")
        return out, jax.lax.pmean(jax.value_and_grad(loss_local)(
            prm, pgl, pl, wl, bt), "p")

    (ln, ld), (loss, grads) = jax.jit(jax.vmap(
        fwd_grad, axis_name="p", in_axes=(None, 0, 0, 0, 0)))(
        rparams, rpgv, rplan, rw, jb)
    local_loss = lambda p: RG.gcn_loss(rcfg, p, gb, jnp.asarray(labels),
                                       jnp.asarray(mask))
    traj = {}
    for name, kw in OPTS.items():
        opt = RO.get_optimizer(name, **kw)
        step = jax.jit(jax.vmap(RGD.make_dist_train_step(loss_local, opt, "p"),
                                axis_name="p", in_axes=(None, None, 0, 0, 0, 0),
                                out_axes=(None, None, 0)))
        p_, st = rparams, opt.init(rparams)
        losses = []
        for _ in range(STEPS):
            p_, st, l_ = step(p_, st, rpgv, rplan, rw, jb)
            losses.append(float(l_[0]))
        traj[name] = (np_tree(p_), np_tree(st), losses)
    tw = TE.device_weights(TE.build_edge_weights(pg, g.out_degrees(), "sym"),
                           "cpu")
    return dict(
        g=g, feats=feats, labels=labels, mask=mask, rpg=rpg, pg=pg, cfg=cfg,
        rparams=rparams, params=convert.tree_from_numpy(rparams, "cpu"),
        pgv=TB.device_view(pg, "cpu"),
        plan=TE.device_plan(TE.build_exchange_plan(pg), "cpu"), w=tw,
        rbatch=rbatch, batch=TGB.batch_to_device(
            TGB.gcn_batch(pg, feats, labels, mask), "cpu"),
        ref_logits=(np.asarray(ln), np.asarray(ld)), ref_loss=float(loss[0]),
        ref_grads=lane0(grads),
        ref_local=np.asarray(RG.gcn_forward(rcfg, rparams, gb)),
        ref_local_loss=float(local_loss(rparams)),
        ref_local_grads=np_tree(jax.grad(local_loss)(rparams)), traj=traj)


def mesh_setup(n_vars, d_node, d_out, levels=2, th=7):
    gb = RS.mesh_batch(6, 6, d_node, 4, multimesh_levels=levels)
    g, _ = RS.grid_mesh(6, 6, levels)
    rpg = ref_partition(g, th=th, p_rank=2, p_gpu=2)
    pg = convert.partition_from_arrays(*convert.partition_to_arrays(rpg))
    tgt = np.random.default_rng(2).normal(size=(g.n, d_out)).astype(np.float32)
    return gb, g, rpg, pg, tgt


def mgn_family(cfg, rcfg, specs_fn, residual, local_loss_fn, local_fwd_fn):
    d_in = cfg.d_node_in if hasattr(cfg, "d_node_in") else cfg.n_vars
    d_out = cfg.d_out if hasattr(cfg, "d_out") else cfg.n_vars
    gb, g, rpg, pg, tgt = mesh_setup(None, d_in, d_out)
    assert pg.d > 0
    mcfg = rcfg if not residual else RG.MGNConfig(
        n_layers=rcfg.n_layers, d_hidden=rcfg.d_hidden, mlp_layers=2,
        d_node_in=rcfg.n_vars, d_edge_in=rcfg.d_edge_in, d_out=rcfg.n_vars)
    rparams = np_tree(ref_materialize(specs_fn(rcfg), 1))
    # non-zero biases and norms: padding edges then carry messages too
    rng = np.random.default_rng(5)
    rparams = jax.tree.map(lambda a: (a + 0.1 * rng.normal(size=a.shape)
                                      ).astype(a.dtype), rparams)
    # the reference's distributed forward leaves its local model once
    # enc_edge(0) != 0 (its padding edges reach column 0; the port masks
    # them): it is held against the port where enc_edge's biases are 0
    zb = {**rparams, "enc_edge": {k: (np.zeros_like(v) if k[0] != "w" else v)
                                  for k, v in rparams["enc_edge"].items()}}
    rpgv, rplan = RB.device_view(rpg), RE.build_exchange_plan(rpg)
    rbatch = RGB.mgn_batch(rpg, gb.nodes, gb.edge_feats, tgt)
    loss_local = lambda prm, pgl, pl, bt: RGD.dist_mgn_loss(
        mcfg, prm, pgl, pl, bt, "p", residual=residual)

    def fwd_grad(prm, pgl, pl, bt):
        out = RGD.dist_mgn_forward(mcfg, prm, pgl, pl, bt, "p")
        return out, jax.lax.pmean(jax.value_and_grad(loss_local)(
            prm, pgl, pl, bt), "p")

    (on, od), (loss, grads) = jax.jit(jax.vmap(
        fwd_grad, axis_name="p", in_axes=(None, 0, 0, 0)))(
        zb, rpgv, rplan, jax.tree.map(jnp.asarray, rbatch))
    jgb = jax.tree.map(jnp.asarray, gb)
    local_loss = lambda prm: local_loss_fn(rcfg, prm, jgb, jnp.asarray(tgt))
    return dict(
        cfg=cfg, gb=gb, g=g, pg=pg, tgt=tgt, rparams=rparams,
        params=convert.tree_from_numpy(rparams, "cpu"),
        params_zb=convert.tree_from_numpy(zb, "cpu"),
        pgv=TB.device_view(pg, "cpu"),
        plan=TE.device_plan(TE.build_exchange_plan(pg), "cpu"),
        rbatch=rbatch,
        batch=TGB.batch_to_device(TGB.mgn_batch(pg, gb.nodes, gb.edge_feats,
                                                tgt), "cpu"),
        ref_out=(np.asarray(on), np.asarray(od)), ref_loss=float(loss[0]),
        ref_grads=lane0(grads),
        ref_local=np.asarray(local_fwd_fn(rcfg, rparams, jgb)),
        ref_local_loss=float(local_loss(rparams)),
        ref_local_grads=np_tree(jax.grad(local_loss)(rparams)))


@pytest.fixture(scope="module")
def mgn():
    return mgn_family(meshgraphnet.SMOKE, ref_config(meshgraphnet.SMOKE,
                                                     RG.MGNConfig),
                      RG.mgn_param_specs, False, RG.mgn_loss, RG.mgn_forward)


@pytest.fixture(scope="module")
def gcast():
    return mgn_family(graphcast.SMOKE, ref_config(graphcast.SMOKE,
                                                  RG.GraphCastConfig),
                      RG.graphcast_param_specs, True, RG.graphcast_loss,
                      RG.graphcast_forward)


# ----------------------------------------------------------------------- GCN
def test_gcn_batch_equals_reference(gcn):
    for k, v in TGB.gcn_batch(gcn["pg"], gcn["feats"], gcn["labels"],
                              gcn["mask"]).items():
        assert v.dtype == gcn["rbatch"][k].dtype
        np.testing.assert_array_equal(v, gcn["rbatch"][k])


def test_gcn_local_forward_and_loss_match_reference(gcn):
    g = gcn["g"]
    gb = TG.batch_to(TG.GraphBatch(nodes=gcn["feats"],
                                   senders=g.src.astype(np.int32),
                                   receivers=g.dst.astype(np.int32)), "cpu")
    got = TG.gcn_forward(gcn["cfg"], gcn["params"], gb)
    np.testing.assert_allclose(got.numpy(), gcn["ref_local"], **FWD)
    loss, grads = value_and_grad(lambda p: TG.gcn_loss(
        gcn["cfg"], p, gb, torch.from_numpy(gcn["labels"]),
        torch.from_numpy(gcn["mask"])), gcn["params"])
    np.testing.assert_allclose(float(loss), gcn["ref_local_loss"], rtol=1e-5)
    assert_trees(grads, gcn["ref_local_grads"], **GRAD)


def test_dist_gcn_forward_matches_reference_and_local(gcn):
    ln, ld = TGD.dist_gcn_forward(gcn["cfg"], gcn["params"], gcn["pgv"],
                                  gcn["plan"], gcn["w"], gcn["batch"]["x_n"],
                                  gcn["batch"]["x_d"])
    np.testing.assert_allclose(ln.numpy(), gcn["ref_logits"][0], **FWD)
    np.testing.assert_allclose(ld.numpy(), gcn["ref_logits"][1], **FWD)
    out = TE.gather_features(gcn["pg"], ln.numpy(), ld[0].numpy())
    np.testing.assert_allclose(out, gcn["ref_local"], rtol=2e-3, atol=2e-4)


def test_dist_gcn_loss_and_grads_match_reference_and_local(gcn):
    loss, grads = value_and_grad(lambda p: TGD.dist_gcn_loss(
        gcn["cfg"], p, gcn["pgv"], gcn["plan"], gcn["w"], gcn["batch"]),
        gcn["params"])
    np.testing.assert_allclose(float(loss), gcn["ref_loss"], rtol=1e-5)
    assert abs(float(loss) - gcn["ref_local_loss"]) / gcn["ref_local_loss"] < 1e-3
    assert_trees(grads, gcn["ref_grads"], **GRAD)
    assert_trees(grads, gcn["ref_local_grads"], **GRAD)


@pytest.mark.parametrize("opt_name", list(OPTS))
def test_dist_train_trajectory_matches_reference(gcn, opt_name):
    opt = TO.get_optimizer(opt_name, **OPTS[opt_name])
    step = TGD.make_dist_train_step(lambda prm, bt: TGD.dist_gcn_loss(
        gcn["cfg"], prm, gcn["pgv"], gcn["plan"], gcn["w"], bt), opt)
    params, state, losses = gcn["params"], opt.init(gcn["params"]), []
    for _ in range(STEPS):
        params, state, loss = step(params, state, gcn["batch"])
        losses.append(float(loss))
    want_p, want_st, want_losses = gcn["traj"][opt_name]
    assert_trees(params, want_p, **TRAJ)
    assert_trees(state, want_st, **TRAJ)
    np.testing.assert_allclose(losses, want_losses, **TRAJ)
    assert losses[-1] < losses[0]


# ------------------------------------------------------ MeshGraphNet family
@pytest.mark.parametrize("which", ["mgn", "gcast"])
def test_mgn_batch_equals_reference(request, which):
    s = request.getfixturevalue(which)
    got = TGB.mgn_batch(s["pg"], s["gb"].nodes, s["gb"].edge_feats, s["tgt"])
    for k, v in got.items():
        if k == "ef":
            for kind in v:
                np.testing.assert_array_equal(v[kind], s["rbatch"]["ef"][kind])
        else:
            np.testing.assert_array_equal(v, s["rbatch"][k])


def test_mgn_local_forward_and_loss_match_reference(mgn):
    gb = TG.batch_to(mgn["gb"], "cpu")
    out = TG.mgn_forward(mgn["cfg"], mgn["params"], gb)
    np.testing.assert_allclose(out.detach().numpy(), mgn["ref_local"], **FWD_MLP)
    loss = TG.mgn_loss(mgn["cfg"], mgn["params"], gb, torch.from_numpy(mgn["tgt"]))
    np.testing.assert_allclose(float(loss), mgn["ref_local_loss"], rtol=1e-5)


def test_graphcast_local_forward_and_loss_match_reference(gcast):
    gb = TG.batch_to(gcast["gb"], "cpu")
    out = TG.graphcast_forward(gcast["cfg"], gcast["params"], gb)
    np.testing.assert_allclose(out.detach().numpy(), gcast["ref_local"],
                               **FWD_MLP)
    loss = TG.graphcast_loss(gcast["cfg"], gcast["params"], gb,
                             torch.from_numpy(gcast["tgt"]))
    np.testing.assert_allclose(float(loss), gcast["ref_local_loss"], rtol=1e-5)


@pytest.mark.parametrize("which,residual", [("mgn", False), ("gcast", True)])
def test_dist_mgn_forward_loss_grads_match_reference(request, which, residual):
    """Every parameter perturbed but enc_edge's biases, which stay 0: there
    the reference's distributed forward is still its local one (C2). The
    gradients of those biases differ: the reference's padding edges carry
    enc_edge's bias terms into the loss, the port's are masked (the port's
    are held against the local model below)."""
    s = request.getfixturevalue(which)
    cfg = s["cfg"] if not residual else TG.graphcast_mgn(s["cfg"])
    on, od = TGD.dist_mgn_forward(cfg, s["params_zb"], s["pgv"], s["plan"],
                                  s["batch"])
    np.testing.assert_allclose(on.detach().numpy(), s["ref_out"][0], **FWD_MLP)
    np.testing.assert_allclose(od.detach().numpy(), s["ref_out"][1], **FWD_MLP)
    loss, grads = value_and_grad(lambda p: TGD.dist_mgn_loss(
        cfg, p, s["pgv"], s["plan"], s["batch"], residual=residual),
        s["params_zb"])
    np.testing.assert_allclose(float(loss), s["ref_loss"], rtol=1e-5)
    assert_trees(grads, s["ref_grads"], skip=ENC_EDGE_BIASES, **GRAD)


@pytest.mark.parametrize("which,residual", [("mgn", False), ("gcast", True)])
def test_dist_mgn_matches_local_model(request, which, residual):
    """The reference's own check: gathered distributed outputs equal the
    single-device model on the whole graph (zero biases, as materialized:
    padding edges then carry no message)."""
    s = request.getfixturevalue(which)
    cfg = s["cfg"] if not residual else TG.graphcast_mgn(s["cfg"])
    specs = (TG.mgn_param_specs(cfg))
    from repro_torch.models.common import materialize
    params = materialize(specs, 3, "cpu")
    on, od = TGD.dist_mgn_forward(cfg, params, s["pgv"], s["plan"], s["batch"])
    got = TE.gather_features(s["pg"], on.detach().numpy(), od[0].detach().numpy())
    want = TG.mgn_forward(cfg, params, TG.batch_to(s["gb"], "cpu"))
    np.testing.assert_allclose(got, want.detach().numpy(), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("which,residual", [("mgn", False), ("gcast", True)])
def test_dist_mgn_matches_local_at_perturbed_params(request, which, residual):
    """C2: every parameter plus 0.1 N(0, 1) (enc_edge(0) != 0). The
    gathered distributed forward equals the port's and the reference's
    local model within 1e-4, and one distributed step's gradients equal the
    port's and the reference's local model's, enc_edge's biases included
    (the padding edges' messages are masked)."""
    s = request.getfixturevalue(which)
    cfg = s["cfg"] if not residual else TG.graphcast_mgn(s["cfg"])
    local_fwd = TG.graphcast_forward if residual else TG.mgn_forward
    local_loss = TG.graphcast_loss if residual else TG.mgn_loss
    gb = TG.batch_to(s["gb"], "cpu")
    on, od = TGD.dist_mgn_forward(cfg, s["params"], s["pgv"], s["plan"],
                                  s["batch"])
    if residual:
        on = on + s["batch"]["x_n"]
        od = od + s["batch"]["x_d"]
    got = TE.gather_features(s["pg"], on.detach().numpy(),
                             od[0].detach().numpy())
    want = local_fwd(s["cfg"], s["params"], gb).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, s["ref_local"], rtol=0, atol=1e-4)
    loss, grads = value_and_grad(lambda p: TGD.dist_mgn_loss(
        cfg, p, s["pgv"], s["plan"], s["batch"], residual=residual),
        s["params"])
    tgt = torch.from_numpy(s["tgt"])
    lloss, lgrads = value_and_grad(
        lambda p: local_loss(s["cfg"], p, gb, tgt), s["params"])
    np.testing.assert_allclose(float(loss), float(lloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), s["ref_local_loss"], rtol=1e-5)
    assert_trees(grads, convert.tree_to_numpy(lgrads), **GRAD)
    assert_trees(grads, s["ref_local_grads"], **GRAD)


# ---------------------------------------------------------- world-2 mesh
@pytest.fixture(scope="module")
def world():
    return TC.dist.spawn(GW.gnn_world, 2, (GW.SPEC,), timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def emulated():
    return GW.run_cases(GW.SPEC, "cpu")


@pytest.mark.parametrize("model", ["gcn", "mgn"])
def test_mesh_training_equals_emulated(world, emulated, model):
    """Two gloo ranks, one partition each: the sharded training steps
    (differentiable delegate sum and payload all-to-all in the backward,
    gradients averaged over the ranks) give every rank the emulated run's
    parameters and losses."""
    want = emulated[model]
    flat = dict(flatten_with_path(want["params"]))
    for rank, res in enumerate(world):
        np.testing.assert_allclose(res[model]["losses"], want["losses"],
                                   rtol=1e-5)
        for k, v in flatten_with_path(res[model]["params"]):
            np.testing.assert_allclose(v, flat[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {rank} {k}")
    assert want["losses"][-1] < want["losses"][0]
