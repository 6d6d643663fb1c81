"""xDeepFM training on the port against the reference on the CPU: the CIN
backward, the loss and its gradients, and an AdamW trajectory.

* ``cin_fused_bwd_plain`` (the einsums the backward kernels are held
  against on the card) against ``jax.vjp`` of the reference's oracle
  ``repro.kernels.ref.cin_fused_ref`` and against autograd of the port's
  ``cin_fused_plain``, at B = 33 (no tile multiple), F0 = 6, Fk in {6, 8},
  H = 8, D = 4, within 1e-5 + 1e-5 |x| (float32 sums in another order).
* ``xdeepfm_loss`` and every gradient leaf against ``jax.value_and_grad``
  of the reference's ``xdeepfm_loss`` on the SMOKE config, both started
  from the same numpy parameters. On CPU tensors each CIN layer runs
  through ``ops.cin_fused``'s ``autograd.Function`` with the plain
  versions of the kernels (forward and both backward halves), so the
  first layer's two input gradients (xk is x0) are summed by autograd
  there, as on the card. Loss within rtol 1e-5; gradients within 1e-6 +
  1e-4 |x| (the float32 sums of XLA and PyTorch in another order).
* Parameters and AdamW state after 3 steps of the port's
  ``make_recsys_train_step`` against the reference's ``make_train_step``
  over ``xdeepfm_loss``, leaf by leaf through ``tree_to_numpy``, within
  1e-5 + 1e-4 |x|.

The JAX references are computed once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import xdeepfm as RX
from repro.kernels.ref import cin_fused_ref
from repro.models import recsys as R
from repro.train import optim as RO
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import base as TCB, xdeepfm as TX
from repro_torch.core import convert
from repro_torch.kernels import ops
from repro_torch.kernels.cin_fused import cin_fused_bwd_plain, cin_fused_plain
from repro_torch.models import recsys as TR
from repro_torch.train import optim as TO
from repro_torch.train import recsys as TRT
from repro_torch.train.trainer import value_and_grad

STEPS, BATCH, LR = 3, 64, 1e-2


def numpy_params(rcfg, seed: int) -> dict:
    """The reference's parameter dict drawn with numpy under its init
    rules (normal x 0.02, scaled / sqrt(shape[-2]), zeros)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in sorted(R.xdeepfm_param_specs(rcfg).items()):
        x = rng.normal(size=spec.shape)
        if spec.init == "zeros":
            x = np.zeros(spec.shape)
        elif spec.init == "scaled":
            x /= np.sqrt(spec.shape[-2] if len(spec.shape) >= 2
                         else spec.shape[-1])
        else:
            x *= spec.scale
        out[name] = x.astype(np.float32)
    return out


def make_batch(cfg, b: int, seed: int) -> dict:
    """Hot ids or -1, cold ids where hot is -1, 0/1 labels."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(-1, cfg.n_hot, (b, cfg.n_sparse)).astype(np.int32)
    cold = np.where(hot < 0, rng.integers(0, cfg.n_cold, (b, cfg.n_sparse)),
                    -1).astype(np.int32)
    return {"hot_idx": hot, "cold_idx": cold,
            "labels": rng.integers(0, 2, b).astype(np.int32)}


def assert_leaves(got: dict, want: dict, atol: float, rtol: float) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("fk", [6, 8])
def test_cin_backward_plain_matches_reference_vjp_and_autograd(fk):
    rng = np.random.default_rng(fk)
    b, f0, h, d = 33, 6, 8, 4
    x0 = rng.normal(size=(b, f0, d)).astype(np.float32)
    xk = x0 if fk == f0 else rng.normal(size=(b, fk, d)).astype(np.float32)
    w = (rng.normal(size=(h, f0 * fk)) / np.sqrt(h)).astype(np.float32)
    g = rng.normal(size=(b, h, d)).astype(np.float32)
    _, vjp = jax.vjp(cin_fused_ref, jnp.asarray(x0), jnp.asarray(xk),
                     jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    got = cin_fused_bwd_plain(*(torch.from_numpy(a) for a in (x0, xk, w, g)))
    tx0, txk, tw = (torch.from_numpy(a).clone().requires_grad_()
                    for a in (x0, xk, w))
    auto = torch.autograd.grad(cin_fused_plain(tx0, txk, tw), (tx0, txk, tw),
                               torch.from_numpy(g))
    for name, mine, ref, ag in zip(("dx0", "dxk", "dw"), got, want, auto):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(mine.numpy(), ag.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def smoke():
    """The SMOKE config's numpy parameters, batches, and the reference's
    loss, gradients and 3-step AdamW trajectory on them."""
    rcfg, tcfg = RX.SMOKE, TX.SMOKE
    params = numpy_params(rcfg, 0)
    batches = [make_batch(rcfg, BATCH, s) for s in range(STEPS)]
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    jp = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(
        lambda p: R.xdeepfm_loss(rcfg, p, jb[0]))(jp)
    opt = RO.get_optimizer(RX.CONFIG.optimizer, lr=LR)
    step = jax.jit(ref_make_train_step(
        lambda p, bt: (R.xdeepfm_loss(rcfg, p, bt), {}), opt))
    p, st, losses = jp, opt.init(jp), []
    for bt in jb:
        p, st, m = step(p, st, bt)
        losses.append(float(m["loss"]))
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(cfg=tcfg, params=params, batches=batches, loss=float(loss),
                grads=as_np(grads), traj=(as_np(p), as_np(st), losses))


def test_xdeepfm_loss_and_grads_match_reference(smoke):
    params = convert.tree_from_numpy(smoke["params"], "cpu")
    batch = TRT.batch_to(smoke["batches"][0], "cpu")
    before = dict(ops.LAUNCHES)
    loss, grads = value_and_grad(
        lambda p: TR.xdeepfm_loss(smoke["cfg"], p, batch), params)
    assert ops.LAUNCHES == before                 # CPU: the plain versions
    np.testing.assert_allclose(float(loss), smoke["loss"], rtol=1e-5)
    assert_leaves(convert.tree_to_numpy(grads), smoke["grads"], atol=1e-6,
                  rtol=1e-4)
    assert all(np.abs(smoke["grads"][f"cin_w{i}"]).max() > 0
               for i in range(len(smoke["cfg"].cin_layers)))


def test_cin_function_gradients_equal_plain_autograd(smoke):
    """The whole model's gradient through the Function (plain backward
    halves) equals autograd of the plain CIN, leaf by leaf."""
    batch = TRT.batch_to(smoke["batches"][1], "cpu")
    params = convert.tree_from_numpy(smoke["params"], "cpu")
    got, want = (convert.tree_to_numpy(value_and_grad(
        lambda p: TR.xdeepfm_loss(smoke["cfg"], p, batch, op), params)[1])
        for op in (None, cin_fused_plain))
    assert_leaves(got, want, atol=1e-7, rtol=1e-5)


def test_adamw_trajectory_matches_reference(smoke):
    spec = TCB.get_arch("xdeepfm")
    assert spec.optimizer == RX.CONFIG.optimizer == "adamw"
    opt = TO.get_optimizer(spec.optimizer, lr=LR)
    step = TRT.make_recsys_train_step(smoke["cfg"], opt)
    params = convert.tree_from_numpy(smoke["params"], "cpu")
    state = opt.init(params)
    losses = []
    for b in smoke["batches"]:
        params, state, m = step(params, state, TRT.batch_to(b, "cpu"))
        losses.append(float(m["loss"]))
    want_p, want_st, want_losses = smoke["traj"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert_leaves(convert.tree_to_numpy(params), want_p, atol=1e-5,
                  rtol=1e-4)
    got_st = convert.tree_to_numpy(state)
    assert int(got_st["step"]) == int(want_st["step"]) == STEPS
    for moment in ("m", "v"):
        assert_leaves(got_st[moment], want_st[moment], atol=1e-5, rtol=1e-4)
    assert losses[-1] < losses[0]
