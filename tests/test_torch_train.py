"""The port's training substrate (``train/optim.py``, ``trainer.py``,
``checkpoint.py``, ``fault.py``), ``models/common.py``, the tree helpers,
the GNN configs and ``convert``'s tree carriers, against the JAX
reference.

Optimizer trajectories on the reference tests' least-squares problem:
``rtol=1e-5, atol=1e-6`` after 20 steps (float32 arithmetic in another
order). Checkpoints: exact leaves, names, shapes and dtypes across the
two packages, both ways."""
import glob
import json
import os

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import base as RCB, gcn_cora as RCG, graphcast as RCC
from repro.configs import meshgraphnet as RCM
from repro.models import common as RM, gnn as RG
from repro.train import checkpoint as RC, fault as RF, optim as RO
from repro.train.trainer import make_train_step as ref_train_step
from repro_torch.configs import base as TCB, gcn_cora, graphcast, meshgraphnet
from repro_torch.core import convert
from repro_torch.models import common as TM, gnn as TG
from repro_torch.train import checkpoint as C, fault as F, optim as O
from repro_torch.train.trainer import make_eval_step, make_train_step
from repro_torch.tree import flatten_with_path, tree_map

TOL = dict(rtol=1e-5, atol=1e-6)
OPT_NAMES = ["adamw", "adafactor", "sgd"]


def quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = torch.mean((pred - batch["y"]) ** 2)
    return loss, {"rmse": torch.sqrt(loss)}


def ref_quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    loss = jnp.mean((pred - batch["y"]) ** 2)
    return loss, {"rmse": jnp.sqrt(loss)}


def make_problem(seed=0, n=256):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(4, 1)).astype(np.float32)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = x @ w_true + 0.5
    params = {"w": np.zeros((4, 1), np.float32), "b": np.zeros((1,), np.float32)}
    return params, {"x": x, "y": y}


def port(tree):
    return convert.tree_from_numpy(tree, "cpu")


def assert_trees(got, want, **tol):
    got = dict(flatten_with_path(got))
    want = dict(flatten_with_path(want))
    assert sorted(got) == sorted(want)
    for k in want:
        g = got[k].detach().numpy() if torch.is_tensor(got[k]) else got[k]
        np.testing.assert_allclose(g, np.asarray(want[k]), err_msg=k, **tol)


def ref_run(opt, params, batch, steps, grad_accum=1):
    step = jax.jit(ref_train_step(ref_quad_loss, opt, grad_accum))
    p, st = jax.tree.map(jnp.asarray, params), None
    st = opt.init(p)
    b = jax.tree.map(jnp.asarray, batch)
    for _ in range(steps):
        p, st, m = step(p, st, b)
    return jax.tree.map(np.asarray, (p, st, m))


def port_run(opt, params, batch, steps, grad_accum=1):
    step = make_train_step(quad_loss, opt, grad_accum)
    p, b = port(params), port(batch)
    st = opt.init(p)
    for _ in range(steps):
        p, st, m = step(p, st, b)
    return p, st, m


# ---------------------------------------------------------------- optimizers
@pytest.mark.parametrize("opt_name", OPT_NAMES)
def test_optimizer_trajectory_matches_reference(opt_name):
    params, batch = make_problem()
    kw = dict(lr=0.05)
    p, st, m = port_run(O.get_optimizer(opt_name, **kw), params, batch, 20)
    rp, rst, rm = ref_run(RO.get_optimizer(opt_name, **kw), params, batch, 20)
    assert_trees(p, rp, **TOL)
    assert_trees(st, rst, **TOL)
    assert int(st["step"]) == 20 and st["step"].dtype == torch.int32
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)


@pytest.mark.parametrize("opt_name", OPT_NAMES)
def test_optimizers_converge(opt_name):
    params, batch = make_problem()
    _, _, m = port_run(O.get_optimizer(opt_name, lr=0.05), params, batch, 300)
    assert float(m["loss"]) < 1e-2, (opt_name, float(m["loss"]))


def test_adamw_weight_decay_and_cosine_schedule_match_reference():
    params, batch = make_problem(seed=1)
    sched = O.cosine_schedule(0.1, 3, 12)
    rsched = RO.cosine_schedule(0.1, 3, 12)
    for s in range(15):
        np.testing.assert_allclose(float(sched(s)), float(rsched(s)), rtol=1e-6)
    p, st, _ = port_run(O.AdamW(lr=sched, weight_decay=0.1, clip_norm=0.5),
                        params, batch, 10)
    rp, rst, _ = ref_run(RO.AdamW(lr=rsched, weight_decay=0.1, clip_norm=0.5),
                         params, batch, 10)
    assert_trees(p, rp, **TOL)
    assert_trees(st, rst, **TOL)


def test_grad_accumulation_matches_reference_and_full_batch():
    params, batch = make_problem()
    opt, ropt = O.AdamW(lr=0.1, clip_norm=0.0), RO.AdamW(lr=0.1, clip_norm=0.0)
    p2, st2, m2 = port_run(opt, params, batch, 1, grad_accum=2)
    rp2, rst2, rm2 = ref_run(ropt, params, batch, 1, grad_accum=2)
    assert_trees(p2, rp2, **TOL)
    assert_trees(m2, rm2, **TOL)
    p1, _, _ = port_run(opt, params, batch, 1, grad_accum=1)
    assert_trees(p2, tree_map(lambda t: t.numpy(), p1), **TOL)


def test_adafactor_state_is_factored():
    params = {"big": torch.zeros((64, 32))}
    st = O.Adafactor(lr=1e-2).init(params)
    assert sum(x.numel() for _, x in flatten_with_path(st["stats"])) == 64 + 32
    want = RO.Adafactor(lr=1e-2).init({"big": jnp.zeros((64, 32))})
    assert ([k for k, _ in flatten_with_path(st)]
            == [jax.tree_util.keystr(k) for k, _ in
                jax.tree_util.tree_flatten_with_path(want)[0]])


def test_clip_by_global_norm_matches_reference():
    tree = {"a": np.ones((10,), np.float32) * 100.0,
            "b": np.arange(6, dtype=np.float32).reshape(2, 3)}
    clipped, norm = O.clip_by_global_norm(port(tree), 1.0)
    rclipped, rnorm = RO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=1e-6)
    assert float(O.global_norm(clipped)) <= 1.0 + 1e-5
    assert_trees(clipped, jax.tree.map(np.asarray, rclipped), **TOL)


def test_eval_step():
    params, batch = make_problem()
    out = make_eval_step(quad_loss)(port(params), port(batch))
    assert set(out) == {"loss", "rmse"} and not out["loss"].requires_grad
    np.testing.assert_allclose(float(out["rmse"]) ** 2, float(out["loss"]),
                               rtol=1e-6)


# -------------------------------------------------------------- checkpoints
def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "s": {"v": torch.ones((2,))}}
    d = str(tmp_path / "ck")
    C.save(d, 10, tree)
    C.save(d, 20, tree_map(lambda x: x * 2, tree))
    assert C.latest_step(d) == 20
    step, restored = C.restore(d, tree)
    assert step == 20
    np.testing.assert_allclose(restored["w"].numpy(),
                               np.arange(12.0).reshape(3, 4) * 2)
    # a partially-written (manifest-less) dir is ignored
    os.makedirs(os.path.join(d, "step_00000030"))
    assert C.latest_step(d) == 20
    # corruption detection
    f = glob.glob(os.path.join(d, "step_00000020", "*.npz"))[0]
    with open(f, "r+b") as fh:
        fh.seek(10)
        fh.write(b"\xde\xad")
    with pytest.raises(IOError):
        C.restore(d, tree, step=20)
    with pytest.raises(ValueError):
        C.restore(d, {"w": torch.zeros(3, 3), "s": {"v": torch.ones(2)}}, step=10)


def test_checkpoint_gc(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(5):
        C.save(d, s, {"x": torch.zeros((2,))}, keep=2)
    assert sorted(C.all_steps(d)) == [3, 4]


@pytest.fixture(scope="module")
def train_state():
    """An MGN parameter tree (stacked ``layers``) and an AdamW state after
    one step, from the reference, as numpy."""
    cfg = RG.MGNConfig(n_layers=2, d_hidden=4, d_node_in=3, d_edge_in=2, d_out=2)
    params = RM.materialize(RG.mgn_param_specs(cfg), 0)
    opt = RO.AdamW(lr=1e-2)
    grads = jax.tree.map(lambda a: jnp.ones_like(a) * 0.1, params)
    params, st = opt.update(grads, opt.init(params), params)
    return jax.tree.map(np.asarray, {"params": params, "opt": st})


def test_checkpoint_written_by_reference_restores_in_port(tmp_path, train_state):
    d = str(tmp_path / "ck")
    RC.save(d, 7, train_state)
    like = tree_map(torch.zeros_like, port(train_state))
    step, got = C.restore(d, like)
    assert step == 7
    assert got["opt"]["step"].dtype == torch.int32
    assert_trees(got, train_state, rtol=0, atol=0)


def test_checkpoint_written_by_port_restores_in_reference(tmp_path, train_state):
    d = str(tmp_path / "ck")
    C.save(d, 9, port(train_state))
    step, got = RC.restore(d, jax.tree.map(np.zeros_like, train_state))
    assert step == 9
    assert_trees(got, train_state, rtol=0, atol=0)
    RC.save(str(tmp_path / "ref"), 9, train_state)
    mine, theirs = (json.load(open(os.path.join(x, "step_00000009",
                                                "manifest.json")))
                    for x in (d, str(tmp_path / "ref")))
    for k in ("names", "shapes", "dtypes"):
        assert mine[k] == theirs[k], k


# ------------------------------------------------------------ fault driver
def run_driver(ckpt_dir, mod, step_fn, init_state):
    crashed = {"done": False}

    def fault_hook(step):
        if step == 7 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    return mod.run_resilient(ckpt_dir=ckpt_dir, init_state=init_state,
                             step_fn=step_fn, total_steps=12, ckpt_every=5,
                             fault_hook=fault_hook)


def test_resilient_driver_matches_reference(tmp_path):
    """A crash injected at step 7 (after the checkpoint at 5): both drivers
    restore, replay steps 5-7 and finish with the same report and the same
    parameters."""
    params, batch = make_problem()
    opt, ropt = O.SGD(lr=0.05), RO.SGD(lr=0.05)
    tstep = make_train_step(quad_loss, opt)
    rstep = jax.jit(ref_train_step(ref_quad_loss, ropt))
    pb, rb = port(batch), jax.tree.map(jnp.asarray, batch)

    def step_fn(step, state):
        p, o, m = tstep(state["params"], state["opt"], pb)
        return {"params": p, "opt": o}, m

    def rstep_fn(step, state):
        p, o, m = rstep(state["params"], state["opt"], rb)
        return {"params": p, "opt": o}, m

    rep = run_driver(str(tmp_path / "port"), F, step_fn,
                     lambda: (0, {"params": port(params),
                                  "opt": opt.init(port(params))}))
    rparams = jax.tree.map(jnp.asarray, params)
    rrep = run_driver(str(tmp_path / "ref"), RF, rstep_fn,
                      lambda: (0, {"params": rparams, "opt": ropt.init(rparams)}))
    assert (rep.final_step, rep.restarts, rep.steps_run) == (
        rrep.final_step, rrep.restarts, rrep.steps_run) == (12, 1, 14)
    _, got = C.restore(str(tmp_path / "port"),
                       {"params": port(params), "opt": opt.init(port(params))})
    _, want = RC.restore(str(tmp_path / "ref"),
                         jax.tree.map(np.asarray, {"params": rparams,
                                                   "opt": ropt.init(rparams)}))
    assert_trees(got, want, **TOL)


def test_resilient_driver_gives_up_after_max_restarts(tmp_path):
    def step_fn(step, state):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="always fails"):
        F.run_resilient(ckpt_dir=str(tmp_path), init_state=lambda: (0, {}),
                        step_fn=step_fn, total_steps=3, max_restarts=2)


def test_straggler_monitor():
    mon = F.StragglerMonitor(window=16, threshold=2.0)
    flagged = [mon.observe(0.1) for _ in range(10)]
    assert not any(flagged)
    assert mon.observe(1.0) is True


# ---------------------------------------------- models/common, tree, convert
def test_materialize_follows_the_specs():
    cfg = meshgraphnet.SMOKE
    specs = TG.mgn_param_specs(cfg)
    a, b = TM.materialize(specs, 0, "cpu"), TM.materialize(specs, 0, "cpu")
    want = RM.shape_tree(RG.mgn_param_specs(
        RG.MGNConfig(**{k: v for k, v in vars(cfg).items() if k != "dtype"})))
    got = dict(flatten_with_path(a))
    ref = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert torch.equal(v, dict(flatten_with_path(b))[k])
    assert got["['layers']['edge_mlp']['w0']"].shape == (cfg.n_layers,
                                                        3 * cfg.d_hidden,
                                                        cfg.d_hidden)
    assert (got["['enc_node']['ln_w']"] == 1).all()
    meta = TM.shape_tree(specs)
    assert meta["layers"]["node_mlp"]["w1"].device.type == "meta"


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 6)).astype(np.float32)
    w, b = rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(
        TM.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(RM.layer_norm(*map(jnp.asarray, (x, w, b)))), **TOL)
    specs = RM.gelu_mlp_specs(6, 4, 2)
    params = jax.tree.map(np.asarray, RM.materialize(specs, 1))
    for final in (True, False):
        np.testing.assert_allclose(
            TM.mlp_apply(port(params), torch.from_numpy(x), 2,
                         final_act=final).numpy(),
            np.asarray(RM.mlp_apply(params, jnp.asarray(x), 2, final_act=final)),
            **TOL)
    assert {k: tuple(v.shape) for k, v in TM.gelu_mlp_specs(6, 4, 2).items()} \
        == {k: tuple(v.shape) for k, v in specs.items()}
    labels = rng.integers(0, 6, 5)
    mask = rng.random(5) < 0.6
    for m in (None, mask):
        np.testing.assert_allclose(
            float(TM.cross_entropy_loss(torch.from_numpy(x), torch.from_numpy(labels),
                                        None if m is None else torch.from_numpy(m))),
            float(RM.cross_entropy_loss(jnp.asarray(x), jnp.asarray(labels),
                                        None if m is None else jnp.asarray(m))),
            rtol=1e-6)


def test_tree_paths_and_convert_roundtrip(train_state):
    names = [k for k, _ in flatten_with_path(train_state)]
    assert names == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(train_state)[0]]
    back = convert.tree_to_numpy(port(train_state))
    assert_trees(back, train_state, rtol=0, atol=0)
    assert back["opt"]["step"].shape == () and back["opt"]["step"].dtype == np.int32


# ------------------------------------------------------------------ configs
def test_gnn_configs_match_reference():
    for mine, theirs in ((TCB.GNN_SHAPES, RCB.GNN_SHAPES),
                         (TCB.LM_SHAPES, RCB.LM_SHAPES),
                         (TCB.RECSYS_SHAPES, RCB.RECSYS_SHAPES),
                         (TCB.BFS_SHAPES, RCB.BFS_SHAPES)):
        assert mine == theirs
    fields = lambda c: {k: v for k, v in vars(c).items() if k != "dtype"}

    def same(mine, theirs):
        # the port carries every reference field its forward reads; the
        # reference's layer-scan switch and multimesh refinement are not
        mine, theirs = fields(mine), fields(theirs)
        assert set(theirs) - set(mine) <= {"scan_layers", "mesh_refinement"}
        assert mine == {k: theirs[k] for k in mine}

    for mod, rmod in ((gcn_cora, RCG), (meshgraphnet, RCM), (graphcast, RCC)):
        same(mod.SMOKE, rmod.SMOKE)
        for shape in TCB.GNN_SHAPES.values():
            same(mod.model_for_shape(shape), rmod.model_for_shape(shape))
        assert TCB.get_arch(mod.CONFIG.name) is mod.CONFIG
        assert mod.CONFIG.optimizer == RCB.get_arch(mod.CONFIG.name).optimizer
    assert {"gcn-cora", "graphcast", "meshgraphnet", "xdeepfm", "mace",
            "mace-opt"} <= set(TCB.all_archs())
