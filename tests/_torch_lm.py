"""Shared helpers of the LM parity tests (``test_torch_lm.py``,
``test_torch_lm_moe.py``): the reference's config and parameters of a
port config, the JAX references of a smoke config (jitted, computed once
per process) and the checks of the port's forward, loss, gradients,
prefill and decode against them, at the bounds those files state."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import common as RM, lm as RL
from repro_torch.configs import base as TCB
from repro_torch.core import convert
from repro_torch.models import lm as TL
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import flatten_with_path

PRIM = dict(rtol=1e-5, atol=1e-6)
LOGIT = dict(rtol=1e-4, atol=1e-5)
GRAD_REL = 1e-3
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def ref_config(cfg: TL.LMConfig) -> RL.LMConfig:
    """The reference's ``LMConfig`` of a port config (same fields, the
    dtype as JAX's)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return RL.LMConfig(**{**kw, "dtype": DTYPES[cfg.dtype]})


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_params(cfg: TL.LMConfig, seed: int = 0) -> dict:
    return np_tree(RM.materialize(RL.lm_param_specs(ref_config(cfg)), seed))


def to_np(x) -> np.ndarray:
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def tokens_for(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def grads_close(got, want) -> None:
    want = dict(flatten_with_path(want))
    got = dict(flatten_with_path(convert.tree_to_numpy(got)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        top = float(np.abs(w).max())
        assert float(np.abs(got[k] - w).max()) <= GRAD_REL * max(top, 1e-30), k


def smoke(arch: str) -> TL.LMConfig:
    return TCB.get_arch(arch).smoke


@functools.lru_cache(maxsize=None)
def forward_case(arch: str) -> dict:
    """The reference's logits, loss, metrics and gradients of a smoke
    config at B = 2, S = 16 (window layers banded), and its parameters."""
    cfg = smoke(arch)
    rcfg = ref_config(cfg)
    params = ref_params(cfg)
    toks = tokens_for(cfg, 2, 17, 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    logits, aux = jax.jit(lambda p, t: RL.forward(rcfg, p, t))(params, batch["tokens"])
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RL.loss_fn(rcfg, p, b), has_aux=True))(params, batch)
    return dict(params=params, batch=batch, logits=np.asarray(logits),
                aux=float(aux), loss=float(loss), ce=float(metrics["ce"]),
                grads=np_tree(grads))


def copy_cache(cache: list) -> list:
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def caches_close(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in ("k", "v"):
            assert tuple(g[name].shape) == tuple(w[name].shape)
            np.testing.assert_allclose(g[name].numpy(), np.asarray(w[name]), **LOGIT)


@functools.lru_cache(maxsize=None)
def serve_case(arch: str, last_only: bool) -> dict:
    """The reference's prefill of a 12-token prompt (past gemma's window
    of 8) at max_seq 20 and 8 decode steps fed its own greedy tokens."""
    cfg = smoke(arch)
    rcfg = ref_config(cfg)
    params = ref_params(cfg, 2)
    prompts = tokens_for(cfg, 2, 12, 2)
    logits, cache = jax.jit(lambda p, t: RL.prefill(rcfg, p, t, max_seq=20,
                                                    last_only=last_only))(params, prompts)
    filled = np_tree(cache)     # the prefill's cache (last_only or not)
    step = jax.jit(lambda p, c, t, q: RL.decode_step(rcfg, p, c, t, q))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    steps = []
    for i in range(8):
        out, cache = step(params, cache, tok, jnp.int32(12 + i))
        steps.append((np.array(tok), np.asarray(out), np_tree(cache)))
        tok = jnp.argmax(out, -1).astype(jnp.int32)
    return dict(params=params, prompts=prompts, logits=np.asarray(logits),
                cache=filled,
                steps=steps)


def check_forward(arch: str) -> None:
    case = forward_case(arch)
    params = convert.tree_from_numpy(case["params"], "cpu")
    with torch.no_grad():
        logits, aux = TL.forward(smoke(arch), params,
                                 torch.from_numpy(case["batch"]["tokens"]))
    assert logits.dtype == torch.float32 and logits.shape == case["logits"].shape
    np.testing.assert_allclose(logits.numpy(), case["logits"], **LOGIT)
    np.testing.assert_allclose(float(aux), case["aux"], **LOGIT)


def check_loss_and_gradients(arch: str) -> None:
    case = forward_case(arch)
    cfg = smoke(arch)
    params = convert.tree_from_numpy(case["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    (loss, metrics), grads = value_and_grad(
        lambda p: TL.loss_fn(cfg, p, batch), params, has_aux=True)
    np.testing.assert_allclose(float(loss), case["loss"], **LOGIT)
    np.testing.assert_allclose(float(metrics["ce"]), case["ce"], **LOGIT)
    grads_close(grads, case["grads"])


def check_prefill_and_decode(arch: str, last_only: bool) -> None:
    case = serve_case(arch, last_only)
    cfg = smoke(arch)
    params = convert.tree_from_numpy(case["params"], "cpu")
    logits, cache = TL.prefill(cfg, params, torch.from_numpy(case["prompts"]),
                               max_seq=20, last_only=last_only)
    np.testing.assert_allclose(logits.numpy(), case["logits"], **LOGIT)
    caches_close(cache, case["cache"])
    for i, (tok, want, want_cache) in enumerate(case["steps"]):
        out, cache = TL.decode_step(cfg, params, copy_cache(cache),
                                    torch.from_numpy(tok), 12 + i)
        np.testing.assert_allclose(out.numpy(), want, **LOGIT)
        caches_close(cache, want_cache)
