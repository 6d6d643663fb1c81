"""The LM stack of the port (``models/{attention,lm,common}.py``,
``data/tokens.py``, the LM configs, ``launch/train.py``,
``examples/torch_lm_serving.py``, the bfloat16 carriers of
``core/convert.py`` and ``train/checkpoint.py``) against the JAX reference
on the CPU, with the reference's own parameters carried across
(``convert.tree_from_numpy``); the dense smoke configs here, the MoE
layer and the MoE smoke configs in ``test_torch_lm_moe.py``.

Tolerances (float32 sums in another order, XLA's against PyTorch's):
rope, norms and attention ``rtol=1e-5, atol=1e-6``; logits, losses and
KV caches within ``1e-5 + 1e-4 |want|``; gradients within ``1e-3`` of
each leaf's largest |g|. bfloat16: logits within ``n_layers * 2**-8``
of the largest |logit| (bfloat16's unit roundoff ``2**-8``, once a
layer); converted leaves bit for bit. Token streams and parameter counts
exact. The JAX references are jitted and computed once per module.

The port leaves the reference on purpose in one place (ROADMAP C3):
for a prompt no longer than the window, its prefill builds a window
layer's cache as the ``min(window, max_seq)`` ring, where the
reference's pads it to ``max_seq`` and its decode then attends past the
window; ``test_short_prompt_decode_equals_forward_past_the_window``
holds the port to its own and the reference's ``forward``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import _torch_lm as L
from _torch_lm import (DTYPES, LOGIT, PRIM, ref_config, ref_params, smoke,
                       to_np, tokens_for)
from repro.configs import base as RCB
from repro.data.tokens import TokenStream as RefTokenStream
from repro.models import attention as RA, common as RM, lm as RL
from repro.train import checkpoint as RC
from repro_torch.configs import base as TCB
from repro_torch.core import convert
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as launcher
from repro_torch.models import attention as TA, common as TM, lm as TL
from repro_torch.train import checkpoint as C
from repro_torch.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
#: the dense smoke configs (the MoE ones: test_torch_lm_moe.py)
DENSE_ARCHS = ["gemma3-1b", "granite-34b", "qwen2.5-14b"]
LM_ARCHS = DENSE_ARCHS + ["kimi-k2-1t-a32b", "qwen2-moe-a2.7b"]


# --------------------------------------------------------------- primitives
def qkv(seed: int, b=2, s=32, t=None, hq=4, hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return f(b, s, hq, dh), f(b, t, hkv, dh), f(b, t, hkv, dh)


def test_apply_rope_matches_reference():
    x, _, _ = qkv(0, s=24)
    pos = np.arange(24) * 37
    want = RA.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = TA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)
    pos2 = np.stack([pos, pos + 5])                          # [B, S]
    want = RA.apply_rope(jnp.asarray(x), jnp.asarray(pos2))
    got = TA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)


@pytest.mark.parametrize("window", [0, 5])
def test_full_causal_attention_matches_reference(window):
    q, k, v = qkv(1)
    want = RA.full_causal_attention(*map(jnp.asarray, (q, k, v)), window=window)
    got = TA.full_causal_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)


@pytest.mark.parametrize("qc,kc", [(8, 16), (16, 8), (32, 32)])
def test_chunked_causal_attention_matches_reference(qc, kc):
    q, k, v = qkv(2)
    want = RA.chunked_causal_attention(*map(jnp.asarray, (q, k, v)),
                                       q_chunk=qc, kv_chunk=kc)
    got = TA.chunked_causal_attention(*map(torch.from_numpy, (q, k, v)),
                                      q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)


def test_chunked_attention_takes_ragged_blocks():
    """The port's chunked path takes a sequence its chunks do not divide
    (the reference's reshape needs S % q_chunk == 0): equal to the full
    causal attention."""
    q, k, v = map(torch.from_numpy, qkv(3, s=37))
    got = TA.chunked_causal_attention(q, k, v, q_chunk=8, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(),
                               TA.full_causal_attention(q, k, v).numpy(), **PRIM)


@pytest.mark.parametrize("s,w", [(32, 8), (30, 8), (13, 4), (8, 8)])
def test_banded_window_attention_matches_reference(s, w):
    q, k, v = qkv(4, s=s)
    want = RA.banded_window_attention(*map(jnp.asarray, (q, k, v)), window=w)
    got = TA.banded_window_attention(*map(torch.from_numpy, (q, k, v)), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)
    # and the banded path is the windowed full attention
    full = TA.full_causal_attention(*map(torch.from_numpy, (q, k, v)), window=w)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **PRIM)


def test_decode_attention_matches_reference():
    q, k, v = qkv(5, s=1, t=20)
    valid = np.random.default_rng(5).random((2, 20)) < 0.6
    valid[1] = False                         # a fully masked row: uniform
    want = RA.decode_attention(*map(jnp.asarray, (q, k, v, valid)))
    got = TA.decode_attention(*map(torch.from_numpy, (q, k, v, valid)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm_and_swiglu_match_reference(dtype):
    rng = np.random.default_rng(6)
    x, g, u = (rng.normal(size=(4, 7, 32)).astype(np.float32) for _ in range(3))
    w = rng.normal(size=(32,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    J = lambda a: jnp.asarray(a, jdt)
    T = lambda a: torch.from_numpy(a).to(tdt)
    for want, got in ((RM.rms_norm(J(x), jnp.asarray(w)), TM.rms_norm(T(x), torch.from_numpy(w))),
                      (RM.swiglu(J(g), J(u)), TM.swiglu(T(g), T(u)))):
        assert got.dtype == tdt
        if dtype == "bfloat16":      # the same casts in the same order
            np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                                       rtol=2**-8, atol=0)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **PRIM)


# ------------------------------------------------------------ whole models
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_reference(arch):
    L.check_forward(arch)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    L.check_loss_and_gradients(arch)


def test_forward_through_the_chunked_path_matches_reference():
    """S = 2,560 > 2,048 with chunks of 512: the chunked path, where the
    reference's shapes divide."""
    cfg = dataclasses.replace(smoke("qwen2.5-14b"), n_layers=1, q_chunk=512,
                              kv_chunk=512)
    rcfg = ref_config(cfg)
    params = ref_params(cfg, 3)
    toks = tokens_for(cfg, 1, 2560, 3)
    want, _ = jax.jit(lambda p, t: RL.forward(rcfg, p, t))(params, toks)
    with torch.no_grad():
        got, _ = TL.forward(cfg, convert.tree_from_numpy(params, "cpu"),
                            torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT)


# ------------------------------------------------------- prefill and decode
@pytest.mark.parametrize("last_only", [False, True])
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_and_decode_match_reference(arch, last_only):
    L.check_prefill_and_decode(arch, last_only)


def test_init_cache_matches_reference_shapes():
    for arch in LM_ARCHS:
        cfg = smoke(arch)
        want = RL.init_cache_specs(ref_config(cfg), 3, 20)
        got = TL.init_cache(cfg, 3, 20, device="cpu")
        assert [{k: tuple(v.shape) for k, v in c.items()} for c in got] == \
            [{k: tuple(v.shape) for k, v in c.items()} for c in want]
        assert all(float(v.abs().sum()) == 0 for c in got for v in c.values())


def test_short_prompt_decode_equals_forward_past_the_window():
    """ROADMAP C3. Window 4, every second layer global, a prompt of 3
    (no longer than the window), max_seq 16: the port's decode logits
    equal its forward's and the reference's forward's at every position;
    the reference's own decode equals them up to position 3 and leaves
    them from position 4 (= the window) on."""
    cfg = dataclasses.replace(smoke("gemma3-1b"), n_layers=4, window=4,
                              global_period=2)
    rcfg = ref_config(cfg)
    params = ref_params(cfg, 4)
    seq = tokens_for(cfg, 2, 16, 4)
    want_fwd = np.asarray(jax.jit(lambda p, t: RL.forward(rcfg, p, t)[0])(params, seq))
    tparams = convert.tree_from_numpy(params, "cpu")
    with torch.no_grad():
        port_fwd = TL.forward(cfg, tparams, torch.from_numpy(seq))[0].numpy()
    np.testing.assert_allclose(port_fwd, want_fwd, **LOGIT)

    _, cache = TL.prefill(cfg, tparams, torch.from_numpy(seq[:, :3]), max_seq=16)
    assert [c["k"].shape[1] for c in cache] == [4, 16, 4, 16]
    _, rcache = RL.prefill(rcfg, params, seq[:, :3], max_seq=16)
    assert [c["k"].shape[1] for c in rcache] == [16, 16, 16, 16]   # the fault
    rstep = jax.jit(lambda p, c, t, q: RL.decode_step(rcfg, p, c, t, q))
    ref_err = []
    for pos in range(3, 16):
        got, cache = TL.decode_step(cfg, tparams, cache, torch.from_numpy(seq[:, pos]), pos)
        np.testing.assert_allclose(got.numpy(), want_fwd[:, pos], **LOGIT)
        rgot, rcache = rstep(params, rcache, seq[:, pos], jnp.int32(pos))
        ref_err.append(float(np.abs(np.asarray(rgot) - want_fwd[:, pos]).max()))
    scale = float(np.abs(want_fwd).max())
    assert max(ref_err[:1]) <= 1e-5 + 1e-4 * scale          # position 3
    assert min(ref_err[1:]) > 1e-2 * scale                   # positions 4..15


def test_bfloat16_forward_through_the_converter():
    """gemma's smoke config in bfloat16: the reference's bfloat16
    parameters carried bit for bit (``tree_from_numpy`` and back), and the
    logits within ``n_layers * 2**-8`` of the largest |logit|."""
    cfg = dataclasses.replace(smoke("gemma3-1b"), dtype=torch.bfloat16)
    rcfg = ref_config(cfg)
    params = ref_params(cfg, 5)
    assert params["embed"].dtype.name == "bfloat16"
    tparams = convert.tree_from_numpy(params, "cpu")
    assert tparams["embed"].dtype == torch.bfloat16
    back = dict(flatten_with_path(convert.tree_to_numpy(tparams)))
    for k, want in flatten_with_path(params):
        assert back[k].dtype == want.dtype
        np.testing.assert_array_equal(back[k].view(np.uint8), want.view(np.uint8))
    toks = tokens_for(cfg, 2, 16, 5)
    want = np.asarray(jax.jit(lambda p, t: RL.forward(rcfg, p, t)[0])(params, toks))
    with torch.no_grad():
        got = TL.forward(cfg, tparams, torch.from_numpy(toks))[0].numpy()
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= cfg.n_layers * 2**-8 * top


def test_bfloat16_checkpoint_round_trip_and_reference_bytes(tmp_path):
    """A bfloat16 tree through the port's checkpoint comes back bit for
    bit, and the file holds what the reference's ``save`` writes of the
    same tree (bfloat16 as raw 2-byte ``V2`` leaves, dtype ``bfloat16`` in
    the manifest)."""
    cfg = dataclasses.replace(smoke("qwen2.5-14b"), dtype=torch.bfloat16)
    params = ref_params(cfg, 6)
    tree = convert.tree_from_numpy(params, "cpu")
    C.save(str(tmp_path / "port"), 3, tree)
    RC.save(str(tmp_path / "ref"), 3, params)
    step, back = C.restore(str(tmp_path / "port"), tree)
    assert step == 3
    want = dict(flatten_with_path(tree))
    for k, got in flatten_with_path(back):
        assert got.dtype == want[k].dtype, k
        assert got.view(torch.uint8).equal(want[k].view(torch.uint8)), k
    mans = [json.load(open(tmp_path / w / "step_00000003" / "manifest.json"))
            for w in ("port", "ref")]
    assert mans[0]["names"] == mans[1]["names"]
    assert mans[0]["dtypes"] == mans[1]["dtypes"] and "bfloat16" in mans[0]["dtypes"]
    with np.load(tmp_path / "port" / "step_00000003" / "shard_0.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000003" / "shard_0.npz") as b:
        for name in b.files:
            assert a[name].dtype == b[name].dtype
            np.testing.assert_array_equal(a[name].view(np.uint8), b[name].view(np.uint8))


# --------------------------------------------------------- data and configs
@pytest.mark.parametrize("seed,shard,shards", [(0, 0, 1), (3, 1, 2), (7, 3, 4)])
def test_token_stream_identical(seed, shard, shards):
    ref = RefTokenStream(512, 33, 8, seed=seed, shard=shard, num_shards=shards)
    got = TokenStream(512, 33, 8, seed=seed, shard=shard, num_shards=shards)
    for step in (0, 1, 17):
        a, b = ref.batch(step), got.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_lm_configs_match_reference():
    """Every FULL and SMOKE field, both ``-opt`` variants, the parameter
    counts (exact integers) and the spec fields of the seven LM archs;
    ``all_archs()`` equal to the reference's."""
    assert TCB.all_archs() == RCB.all_archs()
    lm = [a for a in RCB.all_archs() if RCB.get_arch(a).family == "lm"]
    assert len(lm) == 7
    for name in lm:
        ref, got = RCB.get_arch(name), TCB.get_arch(name)
        for field in ("family", "skip", "rules_override", "optimizer",
                      "grad_accum", "notes"):
            assert getattr(got, field) == getattr(ref, field), (name, field)
        assert got.shapes == ref.shapes
        for which in ("model", "smoke"):
            assert ref_config(getattr(got, which)) == getattr(ref, which), (name, which)
        assert got.model.num_params() == ref.model.num_params()
        assert got.model.num_active_params() == ref.model.num_active_params()
    assert TCB.get_arch("gemma3-1b").model.num_params() == 999_751_680


def test_param_specs_match_reference():
    for arch in LM_ARCHS:
        for cfg in (TCB.get_arch(arch).model, smoke(arch)):
            want = dict(flatten_with_path(RL.lm_param_specs(ref_config(cfg))))
            got = dict(flatten_with_path(TL.lm_param_specs(cfg)))
            assert sorted(got) == sorted(want)
            for k, spec in got.items():
                assert (spec.shape, spec.axes, spec.init, DTYPES[spec.dtype]) == \
                    (want[k].shape, want[k].axes, want[k].init, want[k].dtype), k


# ------------------------------------------------------ launcher and example
def test_launcher_restart_gives_the_same_losses(tmp_path):
    """6 smoke steps straight against 3 steps, then a restart from that
    checkpoint to 6: the same losses, exactly (the data is a pure function
    of the step)."""
    base = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--device", "cpu",
            "--ckpt-every", "3"]
    report, straight = launcher.run(base + ["--steps", "6", "--ckpt-dir",
                                            str(tmp_path / "a")])
    assert report.final_step == 6 and len(straight) == 6
    _, first = launcher.run(base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    report, resumed = launcher.run(base + ["--steps", "6", "--ckpt-dir",
                                           str(tmp_path / "b")])
    assert report.final_step == 6 and len(resumed) == 3
    assert first + resumed == straight
    assert straight[-1] < straight[0]


def test_launcher_builds_the_reference_cell(tmp_path, monkeypatch):
    """``build_lm_step``: grouped routing resolved to one group, the smoke
    caps, the spec's accumulation and optimizer; ``--distributed`` trains
    (here a world of one gloo rank joined by the env:// variables; the
    mesh tests are in ``test_torch_lm_mesh.py``)."""
    spec = TCB.get_arch("kimi-k2-1t-a32b-opt")
    _, cfg, shape, opt = launcher.build_lm_step(spec, "train_4k")
    assert cfg.moe_groups == 1 and shape == (256, 4096)
    assert type(opt).__name__ == "Adafactor"
    _, cfg, shape, _ = launcher.build_lm_step(spec, "train_4k", smoke=True)
    assert cfg == spec.smoke and shape == (4, 64)
    with pytest.raises(ValueError, match="not a train shape"):
        launcher.build_lm_step(spec, "decode_32k")
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, LOCAL_WORLD_SIZE=1,
                     MASTER_ADDR="localhost", MASTER_PORT=port).items():
        monkeypatch.setenv(k, str(v))
    args = ["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps",
            "2", "--ckpt-dir"]
    report, losses = launcher.run(args + [str(tmp_path / "mesh"),
                                          "--distributed"])
    assert report.final_step == 2 and len(losses) == 2
    _, one = launcher.run(args + [str(tmp_path / "one")])
    np.testing.assert_allclose(losses, one, **PRIM)


def test_lm_serving_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "examples/torch_lm_serving.py",
                          "--device", "cpu", "--tokens", "8"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "determinism check: OK" in out.stdout
