"""The port's MoE layer (``models/moe.py``) and the MoE smoke configs
(``kimi-k2-1t-a32b``, ``qwen2-moe-a2.7b``) against the JAX reference on
the CPU, with the reference's own parameters carried across.

Which tokens survive capacity must match the reference exactly: top-k
ties to the lower expert index (a zero row routes uniformly), the stable
dispatch sort and each pair's rank in its expert's queue; the cases below
tie, drop (``capacity_factor`` 0.5) and group (G = 2, 4: the reference's
``moe_apply`` with ``moe_groups=G`` and ``shard=no_shard``). Bounds are
``test_torch_lm.py``'s: outputs and aux within ``1e-5 + 1e-4 |want|``,
gradients within ``1e-3`` of each leaf's largest |g|."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import _torch_lm as L
from _torch_lm import LOGIT, grads_close, ref_config, ref_params, smoke
from repro.models import moe as RMOE
from repro.models.common import no_shard
from repro_torch.core import convert
from repro_torch.models import moe as TMOE
from repro_torch.train.trainer import value_and_grad

MOE_ARCHS = ["kimi-k2-1t-a32b", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch):
    L.check_forward(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    L.check_loss_and_gradients(arch)


@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch, last_only):
    L.check_prefill_and_decode(arch, last_only)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.5, 0.5, 0.1, 0.5], [0.1, 0.2, 0.2, 0.2]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 2)
    got_v, got_i = TMOE.top_k_lower_first(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0].tolist() == [0, 1]


def layer0(params: dict) -> dict:
    return {k: v[0] for k, v in params["layers"].items()}


def moe_case(cfg, t: int, seed: int, zero_rows=()):
    """One layer's reference weights and a [t, D] input (rows
    ``zero_rows`` zeroed), and the reference's output, aux and gradients
    (of ``sum(out * r) + aux`` with respect to the weights and ``x``)."""
    rcfg = ref_config(cfg)
    p = layer0(ref_params(cfg, seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, cfg.d_model)).astype(np.float32)
    x[list(zero_rows)] = 0.0
    r = rng.normal(size=(t, cfg.d_model)).astype(np.float32)

    def f(p, x):
        out, aux = RMOE.moe_apply(p, x, rcfg, no_shard)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (out, aux)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, x)
    return p, x, r, np.asarray(out), float(aux), jax.tree.map(np.asarray, grads)


def check_moe(cfg, t: int, seed: int, zero_rows=()) -> None:
    p, x, r, want, want_aux, (gp, gx) = moe_case(cfg, t, seed, zero_rows)
    tp = convert.tree_from_numpy(p, "cpu")
    rt = torch.from_numpy(r)

    def f(args):
        out, aux = TMOE.moe_apply(args["p"], args["x"], cfg)
        return (out * rt).sum() + aux, (out, aux)

    (_, (out, aux)), grads = value_and_grad(
        f, {"p": tp, "x": torch.from_numpy(x)}, has_aux=True)
    np.testing.assert_allclose(out.numpy(), want, **LOGIT)
    np.testing.assert_allclose(float(aux), want_aux, **LOGIT)
    grads_close(grads, {"p": gp, "x": gx})


def dropped(cfg, x: np.ndarray, p: dict) -> int:
    """(token, slot) pairs the port drops at capacity, over the groups."""
    g = max(cfg.moe_groups, 1)
    xs = torch.from_numpy(x).reshape(g, -1, x.shape[1])
    n = 0
    for xg in xs:
        probs = torch.softmax(xg @ torch.from_numpy(np.array(p["router"])), -1)
        w, i = TMOE.top_k_lower_first(probs, cfg.top_k)
        tok, _ = TMOE.dispatch(i, w, TMOE.capacity(xg.shape[0], cfg),
                               cfg.n_experts_pad)
        n += xg.shape[0] * cfg.top_k - int((tok >= 0).sum())
    return n


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ties_match_reference(arch):
    """Zero rows route uniformly: every expert ties."""
    check_moe(smoke(arch), 24, 1, zero_rows=(0, 3, 17))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_drops_match_reference(arch):
    cfg = dataclasses.replace(smoke(arch), capacity_factor=0.5)
    p, x, *_ = moe_case(cfg, 64, 2)
    assert dropped(cfg, x, p) > 0
    check_moe(cfg, 64, 2, zero_rows=(5,))


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grouped_matches_reference(arch, groups):
    cfg = dataclasses.replace(smoke(arch), moe_groups=groups,
                              capacity_factor=0.5)
    p, x, *_ = moe_case(cfg, 160, 3)
    assert dropped(cfg, x, p) > 0
    check_moe(cfg, 160, 3, zero_rows=(7,))
