"""The LM on a mesh (``launch/{mesh,sharding,cells}.py``, the ``par``
paths of ``models/{lm,moe,common}.py``, ``train/trainer.py``'s mesh step,
the sharded optimizers and checkpoints, ``core/convert.py``'s
``lm_shard_params`` / ``lm_gather_params``, the differentiable collectives
of ``core/comm/dist.py`` and the launcher's ``--distributed``) against the
port's one-device step and the JAX reference on the CPU.

One gloo world of 4 ranks (``_torch_lm_world.py``) runs every LM spec's
smoke config on three meshes: ``(data 2, model 2)``, ``(data 1, model 4)``
(ragged heads: granite's 6 over 4) and ``(pod 2, data 1, model 2)``.
Bounds: loss, ``ce`` and ``aux`` equal the one-device step's at ``rtol
1e-5, atol 1e-6``; the gathered gradients equal ``jax.grad`` of the
reference's ``loss_fn`` within 1e-3 of each leaf's largest |g| (the
LM tests' ``GRAD_REL``); the gathered parameters after 2 steps equal the
one-device step's within 1e-3 of each leaf's change in the L2 norm
(AdamW's ``m / sqrt(v)`` amplifies float32 rounding where ``m`` is near 0,
so elementwise the first step is sign-like); the routing's integers and
the wire bytes exactly. The JAX references are jitted and computed once
per module."""
import dataclasses
import functools
import os
import re
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import _torch_lm_world as W
from _torch_lm import GRAD_REL, PRIM, np_tree, ref_config
from repro import compat
from repro.configs import base as RCB
from repro.launch import sharding as RS
from repro.models import lm as RL
from repro.train import optim as RO
from repro_torch.configs import base as TCB
from repro_torch.core import comm as TC, convert
from repro_torch.launch import mesh as TMESH, sharding as TS
from repro_torch.launch import train as launcher
from repro_torch.models import common as TM, lm as TL, moe as TMOE
from repro_torch.train.optim import cosine_schedule, get_optimizer
from repro_torch.train.trainer import make_train_step, value_and_grad
from repro_torch.tree import flatten_with_path

# the reference loads its registry only while it is empty: a module that
# imports one config first (as other test files do) would leave the LM
# archs out of it
RCB._load_all()

ROOT = Path(__file__).resolve().parents[1]
CASES = [(m, a) for m in W.MESHES for a in W.ARCHS]
#: the parameters after the steps: each leaf within PARAM_REL of its change
PARAM_REL = 1e-3


def groups(arch: str, mesh: str) -> int:
    return W.data_size(mesh) if arch.endswith("-opt") else 0


def smoke_cfg(arch: str, g: int):
    return dataclasses.replace(TCB.get_arch(arch).smoke, moe_groups=g)


def params_np(arch: str) -> dict:
    """The smoke config's parameters (``materialize``, seed 0) as numpy:
    what both packages are given (an ``-opt`` spec shares its base's)."""
    return _params_np(TCB.get_arch(arch).smoke)


@functools.lru_cache(maxsize=None)
def _params_np(cfg) -> dict:
    return convert.tree_to_numpy(TM.materialize(TL.lm_param_specs(cfg), 0,
                                                "cpu"))


@pytest.fixture(scope="module")
def world():
    return TC.dist.spawn(W.lm_world, W.WORLD,
                         ({a: params_np(a) for a in W.ARCHS},), timeout=300.0)


def reference(arch: str, g: int) -> dict:
    """``jax.value_and_grad`` of the reference's ``loss_fn`` on the global
    batch (``g > 0``: routing in ``g`` groups, which the reference does
    under a shard function; one group is the ungrouped routing of the
    same smoke config)."""
    if g == 1:
        return _reference(arch.removesuffix("-opt"), 0)
    return _reference(arch, g)


@functools.lru_cache(maxsize=None)
def _reference(arch: str, g: int) -> dict:
    rcfg = ref_config(smoke_cfg(arch, g))
    shard = (lambda x, axes: x) if g else RL.no_shard
    b = W.batch(rcfg.vocab)
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p, bt: RL.loss_fn(rcfg, p, bt, shard), has_aux=True))(
        params_np(arch), b)
    return {"loss": float(loss), "ce": float(m["ce"]), "aux": float(m["aux"]),
            "grads": np_tree(grads)}


@functools.lru_cache(maxsize=None)
def one_device(arch: str, g: int, accum: int = 1) -> dict:
    """The port's one-device step (``trainer.make_train_step`` over
    ``LM.loss_fn``, the spec's optimizer on the cell's schedule): the first
    step's loss and metrics, the parameters after ``W.STEPS`` steps and
    each step's loss."""
    cfg = smoke_cfg(arch, g)
    spec = TCB.get_arch(arch)
    opt = get_optimizer(spec.optimizer, lr=cosine_schedule(3e-4, 100, 10000))
    loss = lambda p, b: TL.loss_fn(cfg, p, b)
    b = {k: torch.from_numpy(v) for k, v in W.batch(cfg.vocab).items()}
    p = convert.tree_from_numpy(params_np(arch), "cpu")
    (l, m), _ = value_and_grad(loss, p, b, has_aux=True)
    step = make_train_step(loss, opt, accum)
    st, losses = opt.init(p), []
    for _ in range(W.STEPS):
        p, st, mm = step(p, st, b)
        losses.append(float(mm["loss"]))
    return {"loss": float(l), "ce": float(m["ce"]), "aux": float(m["aux"]),
            "params": convert.tree_to_numpy(p), "losses": losses}


def gathered(world, key, what: str, arch: str):
    axes, sizes = W.MESHES[key[0]]
    mesh = types.SimpleNamespace(axes=axes)
    spec = W.arch_spec(arch)
    cfg = smoke_cfg(arch, groups(arch, key[0]))
    return convert.lm_gather_params([r[key][what] for r in world], cfg,
                                    TS.rules_for(mesh, spec.rules_override),
                                    axes, sizes)


def params_close(got, want, start) -> float:
    got, want, start = (dict(flatten_with_path(t)) for t in (got, want, start))
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k in want:
        moved = float(np.linalg.norm((want[k] - start[k]).astype(np.float64)))
        diff = float(np.linalg.norm((got[k] - want[k]).astype(np.float64)))
        assert diff <= PARAM_REL * moved, (k, diff, moved)
        worst = max(worst, diff / moved if moved else 0.0)
    return worst


# ----------------------------------------------------------- the seven specs
@pytest.mark.parametrize("mesh,arch", CASES)
def test_mesh_loss_equals_one_device_step(world, mesh, arch):
    want = one_device(arch, groups(arch, mesh))
    for r in world:
        got = r[mesh, arch]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(got[k], want[k], **PRIM, err_msg=k)
        np.testing.assert_allclose(got["losses"], want["losses"], **PRIM)


@pytest.mark.parametrize("mesh,arch", CASES)
def test_mesh_gradients_equal_reference_grad(world, mesh, arch):
    want = dict(flatten_with_path(reference(arch, groups(arch, mesh))["grads"]))
    got = dict(flatten_with_path(gathered(world, (mesh, arch), "grads", arch)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        top = float(np.abs(w).max())
        assert float(np.abs(got[k] - w).max()) <= GRAD_REL * max(top, 1e-30), k


@pytest.mark.parametrize("mesh,arch", CASES)
def test_mesh_two_steps_equal_one_device(world, mesh, arch):
    want = one_device(arch, groups(arch, mesh))["params"]
    got = gathered(world, (mesh, arch), "params", arch)
    params_close(got, want, params_np(arch))


@pytest.mark.parametrize("mesh,arch", CASES)
def test_wire_bytes_equal_the_count_from_shapes(world, mesh, arch):
    """The bytes each rank's collectives counted in each step equal
    ``cells.lm_wire_bytes`` (a checkpointed layer's forward collectives
    twice: forward and recompute), and a split axis puts bytes on the
    wire."""
    for r in world:
        got = r[mesh, arch]
        for wire in got["wire"]:
            assert wire == got["reckoned"]
    assert world[0][mesh, arch]["wire"][0].get("reduce", 0) > 0


def test_mesh_norm_is_the_worlds(world):
    """AdamW's clip reads the world's norm: every rank the same."""
    for mesh, arch in CASES:
        norms = [r[mesh, arch]["norms"] for r in world]
        assert all(n == norms[0] for n in norms)


def test_accumulation_holds_the_row_layout(world):
    """MoE at grad_accum 2 on (data 2, model 2): data rank r holds its
    slice of each microbatch of the one-device step (microbatch i: global
    rows [i B / 2, (i + 1) B / 2), split over data), and the step equals
    the one-device step at grad_accum 2."""
    arch = W.ACCUM_ARCH
    per = W.BATCH // (W.ACCUM * 2)
    toks = W.batch(smoke_cfg(arch, 0).vocab)["tokens"]
    for rank, r in enumerate(world):
        d = rank // 2
        want = np.concatenate([toks[i * W.BATCH // W.ACCUM + d * per:][:per]
                               for i in range(W.ACCUM)])
        np.testing.assert_array_equal(r["2x2", "accum"]["rows"], want)
    want = one_device(arch, 0, W.ACCUM)
    got = world[0]["2x2", "accum"]
    np.testing.assert_allclose(got["losses"], want["losses"], **PRIM)
    params_close(gathered(world, ("2x2", "accum"), "params", arch),
                 want["params"], params_np(arch))
    for r in world:
        for wire in r["2x2", "accum"]["wire"]:
            assert wire == r["2x2", "accum"]["reckoned"]


@pytest.mark.parametrize("mesh", list(W.MESHES))
def test_dispatch_tables_and_drops_equal_one_device(world, mesh):
    """Global routing over the data ranks: the gathered dispatch table
    (token and weight in each slot) and the kept (token, slot) pairs equal
    the one-device dispatch's on the global token set, exactly; some
    pairs are dropped."""
    top_i, top_w = (torch.from_numpy(a) for a in W.routing_case())
    tok, w = TMOE.dispatch(top_i, top_w, W.ROUTE_CAP, W.ROUTE_E)
    order, _, _, keep = TMOE.kept_pairs(top_i, W.ROUTE_CAP)
    kept = torch.zeros(top_i.numel(), dtype=torch.bool)
    kept[order] = keep
    kept = kept.reshape(top_i.shape).numpy()
    assert 0 < (~kept).sum()
    for r in world:
        np.testing.assert_array_equal(r[mesh, "routing"]["tok"], tok.numpy())
        np.testing.assert_array_equal(r[mesh, "routing"]["w"], w.numpy())
        np.testing.assert_array_equal(r[mesh, "routing"]["kept"], kept)


# ------------------------------------------------------------------- rules
LM_ARCHS = sorted(a for a in TCB.all_archs() if TCB.get_arch(a).family == "lm")
AXES = [("data", "model"), ("pod", "data", "model")]


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("axes", AXES, ids=["2-axis", "3-axis"])
def test_rules_equal_the_reference(arch, axes):
    over = TCB.get_arch(arch).rules_override
    assert over == RCB.get_arch(arch).rules_override
    want = RS.rules_for(types.SimpleNamespace(axis_names=axes), over)
    assert TS.rules_for(types.SimpleNamespace(axes=axes), over) == want


@pytest.mark.parametrize("arch", ["granite-34b", "kimi-k2-1t-a32b",
                                  "qwen2.5-14b"])
@pytest.mark.parametrize("axes", AXES, ids=["2-axis", "3-axis"])
def test_opt_state_layout_equals_the_reference(arch, axes):
    """Each optimizer-state leaf's mesh axes equal the PartitionSpec of
    the reference's ``opt_state_struct`` (AdamW's moments like their
    parameter; Adafactor's vr / vc less the reduced axis)."""
    spec = TCB.get_arch(arch)
    cfg = spec.model
    mesh = compat.make_mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(axes)), axes)
    rules = RS.rules_for(mesh, spec.rules_override)
    ropt = RO.get_optimizer(spec.optimizer, lr=1e-3)
    want, _ = RS.opt_state_struct(ropt, RL.lm_param_specs(ref_config(cfg)),
                                  mesh, rules)
    got = TS.opt_state_shardings(
        get_optimizer(spec.optimizer, lr=1e-3), TL.lm_param_specs(cfg),
        TS.rules_for(types.SimpleNamespace(axes=axes), spec.rules_override))
    want = dict(flatten_with_path(want))
    got = dict(flatten_with_path(got))
    assert sorted(got) == sorted(want)
    for k, sds in want.items():
        pspec = tuple(sds.sharding.spec) + (None,) * (len(sds.shape)
                                                      - len(sds.sharding.spec))
        assert got[k].dims == tuple(TS.mesh_axes(a) for a in pspec), k
        assert got[k].shape == tuple(sds.shape), k


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_layout(multi_pod, monkeypatch):
    """model is the ranks of one host, data the rest; --multi-pod puts two
    pods in front; --mesh fixes data and model."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    axes, sizes = TMESH.mesh_layout(16, multi_pod)
    if multi_pod:
        assert (axes, sizes) == (("pod", "data", "model"), (2, 2, 4))
    else:
        assert (axes, sizes) == (("data", "model"), (4, 4))
    world = 8 if multi_pod else 4
    assert TMESH.mesh_layout(world, multi_pod, sizes=(2, 2))[1] == (
        (2, 2, 2) if multi_pod else (2, 2))
    with pytest.raises(ValueError):
        TMESH.mesh_layout(6, multi_pod, sizes=(4, 1))


def test_production_mesh_refuses_a_split_host(monkeypatch):
    """A world that LOCAL_WORLD_SIZE does not divide is refused (no quiet
    fall-back to data parallel), with --mesh named; --mesh lays it out."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="--mesh DATA,MODEL"):
        TMESH.mesh_layout(6)
    assert TMESH.mesh_layout(6, sizes=(3, 2)) == (("data", "model"), (3, 2))


# -------------------------------------------------------------- the shards
@pytest.mark.parametrize("mesh", list(W.MESHES))
@pytest.mark.parametrize("arch", ["granite-34b", "kimi-k2-1t-a32b",
                                  "qwen2-moe-a2.7b"])
def test_shard_round_trip(mesh, arch):
    """``lm_shard_params`` then ``lm_gather_params`` gives the tree back;
    a rank's shard is the slice of the whole (heads cut whole)."""
    axes, sizes = W.MESHES[mesh]
    spec = TCB.get_arch(arch)
    cfg = spec.smoke
    rules = TS.rules_for(types.SimpleNamespace(axes=axes), spec.rules_override)
    whole = params_np(arch)
    shards = [convert.lm_shard_params(whole, cfg, rules,
                                      TS.MeshLayout.of(axes, sizes, r))
              for r in range(int(np.prod(sizes)))]
    back = convert.lm_gather_params(shards, cfg, rules, axes, sizes)
    for (k, a), (_, b) in zip(flatten_with_path(back), flatten_with_path(whole)):
        np.testing.assert_array_equal(a, b, err_msg=k)
    if mesh == "1x4" and arch == "granite-34b":
        wq = shards[2]["layers"]["wq"]      # heads [4, 5) of 6
        np.testing.assert_array_equal(
            wq, whole["layers"]["wq"][..., 4 * cfg.d_head:5 * cfg.d_head])


def test_drawn_blocks_make_the_whole():
    """Each rank draws its own blocks from the seed (by the leaf and the
    block's coordinates, never the rank): ranks that hold a block hold the
    same values, and the blocks put together are the whole draw."""
    axes, sizes = W.MESHES["2x2"]
    spec = TCB.get_arch("kimi-k2-1t-a32b")
    cfg = spec.smoke
    specs = TL.lm_param_specs(cfg)
    rules = TS.rules_for(types.SimpleNamespace(axes=axes), spec.rules_override)
    units = TL.lm_units(cfg)
    whole = TS.draw_tree(specs, 7, rules, axes, sizes, device="cpu",
                         units=units)
    shards = [TS.draw_tree(specs, 7, rules, axes, sizes,
                           TS.MeshLayout.of(axes, sizes, r), device="cpu",
                           units=units)
              for r in range(4)]
    back = TS.gather_tree(shards, TS.param_shardings(specs, rules, units),
                          axes, sizes)
    for (k, a), (_, b) in zip(flatten_with_path(back), flatten_with_path(whole)):
        assert torch.equal(a, b), k
    # model-replicated: the router on both data ranks' model ranks
    assert torch.equal(shards[0]["layers"]["router"],
                       shards[3]["layers"]["router"])
    assert float(whole["layers"]["we_gate"].std()) > 0


# ---------------------------------------------------------------- launcher
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_all(runs: list, tmp: Path, world: int = 2) -> list:
    """Each run (launcher arguments) on its own world of ``world`` processes
    started with the env:// variables, the worlds side by side; returns
    each run's rank-0 logged losses."""
    procs = []
    for args in runs:
        port = _free_port()
        for r in range(world):
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(r),
                       LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       GLOO_SOCKET_IFNAME="lo")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *args,
                 "--distributed", "--device", "cpu", "--log-every", "1"],
                cwd=tmp, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    return [[float(m.group(1)) for m in re.finditer(
        r"step \d+ loss (\S+)$", outs[i * world][1], re.M)]
        for i in range(len(runs))]


def test_distributed_launcher_restarts_with_the_same_losses(tmp_path):
    """2 gloo ranks (env://) at --smoke: 4 steps straight against 2 steps,
    then a restart from each rank's sharded checkpoint to 4: the same
    losses, exactly; and the losses of the one-device launcher within
    float32 rounding (the vocabulary and heads split over the 2 ranks)."""
    base = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--ckpt-every", "2"]
    straight, first = _launch_all([
        base + ["--steps", "4", "--ckpt-dir", "a"],
        base + ["--steps", "2", "--ckpt-dir", "b"]], tmp_path)
    assert sorted(os.listdir(tmp_path / "b" / "step_00000002")) == [
        "manifest_0.json", "manifest_1.json", "shard_0.npz", "shard_1.npz"]
    resumed, = _launch_all([base + ["--steps", "4", "--ckpt-dir", "b"]],
                           tmp_path)
    assert len(straight) == 4 and first + resumed == straight
    _, one = launcher.run(base + ["--steps", "4", "--device", "cpu",
                                  "--ckpt-dir", str(tmp_path / "c")])
    np.testing.assert_allclose(straight, one, **PRIM)
