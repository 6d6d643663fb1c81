"""The port's xDeepFM serving path against the reference ``repro.models.
recsys`` on the CPU.

The same parameters (drawn with numpy under the reference's init rules,
fed to the reference as its parameter dict and carried across by
``convert.xdeepfm_params_from_numpy``) and the same numpy-made indices go
through both; on CPU tensors the port's ``ops.cin_fused`` takes
its plain version, the reference's ``ops.cin_fused`` its jnp oracle (as
tests/test_recsys.py runs it). Tolerances: float32 sums taken in another
order by XLA and PyTorch -- rtol 1e-5, atol 1e-6 on embeddings, CIN
outputs, logits and scores (the CIN's longest sum is F0*Fk = 7,800
products at FULL widths). ``ClickStream`` is numpy on both sides, so its
batches are equal exactly.
"""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import base as RB
from repro.configs import xdeepfm as RX
from repro.data.recsys_data import ClickStream as RClickStream
from repro.models import recsys as R
from repro_torch.configs import xdeepfm as TX
from repro_torch.core import convert
from repro_torch.data.recsys_data import ClickStream as TClickStream
from repro_torch.models import recsys as TR

RTOL, ATOL = 1e-5, 1e-6
# SMOKE, and FULL widths (39 fields, D=10, CIN 200-200-200, MLP 400-400)
# with small tables
CONFIGS = {
    "smoke": (RX.SMOKE, TX.SMOKE),
    "full_widths": (replace(RX.FULL, n_hot=64, n_cold=512),
                    replace(TX.FULL, n_hot=64, n_cold=512)),
}


def numpy_params(rcfg, seed: int) -> dict:
    """The reference's parameter dict, drawn with numpy under its
    ``materialize`` rules (normal x 0.02, scaled / sqrt(shape[-2]), zeros)."""
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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(reference cfg, port cfg, reference params, port model)."""
    rcfg, tcfg = CONFIGS[request.param]
    params = numpy_params(rcfg, 0)
    return rcfg, tcfg, params, convert.xdeepfm_params_from_numpy(
        params, tcfg, "cpu")


def make_batch(cfg, b, seed=0):
    """tests/test_recsys.py's batch: hot ids or -1, cold ids where hot is -1."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(-1, cfg.n_hot, (b, cfg.n_sparse)).astype(np.int32)
    cold = np.where(hot < 0, rng.integers(0, cfg.n_cold, (b, cfg.n_sparse)),
                    -1).astype(np.int32)
    return hot, cold


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------------ configs
def test_configs_equal_reference():
    for rcfg, tcfg in ((RX.FULL, TX.FULL), (RX.SMOKE, TX.SMOKE)):
        want, got = asdict(rcfg), asdict(tcfg)
        assert want.pop("dtype") == jnp.float32
        assert got.pop("dtype") == torch.float32
        assert got == want
    assert TX.RECSYS_SHAPES == RB.RECSYS_SHAPES
    assert (TX.FULL.n_sparse, TX.FULL.embed_dim, TX.FULL.cin_layers,
            TX.FULL.mlp_layers) == (39, 10, (200, 200, 200), (400, 400))


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["full"])
def test_param_specs_equal_reference(name):
    rcfg, tcfg = (RX.FULL, TX.FULL) if name == "full" else CONFIGS[name]
    want = R.xdeepfm_param_specs(rcfg)
    got = TR.xdeepfm_param_specs(tcfg)
    assert sorted(got) == sorted(want)
    for k, (shape, init) in got.items():
        assert (shape, init) == (want[k].shape, want[k].init), k


def test_init_params_follow_materialize_rules():
    """normal x 0.02, scaled / sqrt(shape[-2]), zeros; seeded and
    deterministic (the bits differ from JAX's)."""
    cfg = replace(TX.SMOKE, n_hot=4096, n_cold=8192)
    a = TR.init_params(cfg, 0, torch.device("cpu"))
    b = TR.init_params(cfg, 0, torch.device("cpu"))
    c = TR.init_params(cfg, 1, torch.device("cpu"))
    for k, (shape, init) in TR.xdeepfm_param_specs(cfg).items():
        assert tuple(a[k].shape) == shape and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k]), k
        if init == "zeros":
            assert not a[k].any(), k
            continue
        assert not torch.equal(a[k], c[k]), k
        want = 0.02 if init == "normal" else 1 / np.sqrt(shape[-2])
        assert abs(float(a[k].std()) / want - 1) < 0.25, k
    assert abs(float(a["emb_cold"].std()) - 0.02) < 0.001


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,hot_fraction", [(0, 0.01), (3, 0.005)])
def test_click_stream_equals_reference(seed, hot_fraction):
    kw = dict(n_fields=8, total_vocab=1 << 14, hot_fraction=hot_fraction,
              seed=seed)
    r, t = RClickStream(**kw), TClickStream(**kw)
    np.testing.assert_array_equal(t.vocab_sizes, r.vocab_sizes)
    for f in ("field_offsets", "hot_of", "cold_of"):
        np.testing.assert_array_equal(getattr(t.hot_cold, f),
                                      getattr(r.hot_cold, f))
    assert (t.hot_cold.n_hot, t.hot_cold.n_cold) == (r.hot_cold.n_hot,
                                                     r.hot_cold.n_cold)
    assert t.hot_lookup_fraction == r.hot_lookup_fraction
    for step, size in ((0, 64), (1, 64), (7, 33)):
        want, got = r.batch(step, size), t.batch(step, size)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_utilities_equal_reference():
    np.testing.assert_array_equal(TR.make_vocab_sizes(13, 10_000, 4),
                                  R.make_vocab_sizes(13, 10_000, 4))
    rng = np.random.default_rng(2)
    sizes = np.array([5, 9, 4])
    freq = rng.random(int(sizes.sum()))
    rm, tm = R.HotColdMap.build(sizes, freq, 0.6), TR.HotColdMap.build(
        sizes, freq, 0.6)
    raw = np.stack([rng.integers(0, s, 10) for s in sizes], axis=1)
    for a, b in zip(tm.split(raw), rm.split(raw)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("table", ["emb", "lin"])
def test_embed_lookup_matches_reference(pair, table):
    rcfg, _, params, model = pair
    hot, cold = make_batch(rcfg, 6, seed=1)
    want = R.embed_lookup(params, jnp.asarray(hot), jnp.asarray(cold), table)
    got = TR.embed_lookup(model.params(), torch.from_numpy(hot),
                          torch.from_numpy(cold), table)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cin_apply_matches_reference(pair):
    rcfg, tcfg, params, model = pair
    x0 = np.random.default_rng(0).normal(
        size=(5, rcfg.n_sparse, rcfg.embed_dim)).astype(np.float32) * 0.02
    want = R.cin_apply(rcfg, params, jnp.asarray(x0))
    got = TR.cin_apply(tcfg, model.params(), torch.from_numpy(x0))
    assert got.shape == (5, 1)
    close(got, want)


def test_forward_matches_reference(pair):
    rcfg, _, params, model = pair
    b = 4
    hot, cold = make_batch(rcfg, b, seed=b)
    want = R.xdeepfm_logits(rcfg, params, {"hot_idx": jnp.asarray(hot),
                                           "cold_idx": jnp.asarray(cold)})
    got = model(torch.from_numpy(hot), torch.from_numpy(cold))
    assert got.shape == (b,) and got.dtype == torch.float32
    close(got, want)


def test_forward_on_click_stream_batch(pair):
    """A ClickStream batch whose table sizes fit the config (the port's
    own pipeline feeding the port's model) matches the reference too."""
    rcfg, _, params, model = pair
    cs = TClickStream(n_fields=rcfg.n_sparse, total_vocab=rcfg.n_cold // 2,
                      hot_fraction=0.05, seed=0)
    assert cs.hot_cold.n_hot <= rcfg.n_hot
    assert cs.hot_cold.n_cold <= rcfg.n_cold
    batch = cs.batch(0, 4)
    want = R.xdeepfm_logits(rcfg, params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    got = model(torch.from_numpy(batch["hot_idx"]),
                torch.from_numpy(batch["cold_idx"]))
    close(got, want)


def test_retrieval_scores_match_reference(pair):
    """Scores within tolerance; indices equal wherever the two scores at a
    rank are not tied within that tolerance."""
    rcfg, _, params, model = pair
    hot, cold = make_batch(rcfg, 2, seed=5)
    cands = np.random.default_rng(1).normal(
        size=(500, rcfg.d_query)).astype(np.float32)
    ws, wi = R.retrieval_scores(rcfg, params, {"hot_idx": jnp.asarray(hot),
                                               "cold_idx": jnp.asarray(cold)},
                                jnp.asarray(cands), top_k=10)
    gs, gi = TR.retrieval_scores(model, torch.from_numpy(hot),
                                 torch.from_numpy(cold),
                                 torch.from_numpy(cands), top_k=10)
    assert gs.shape == gi.shape == (2, 10)
    close(gs, ws)
    ws, wi = np.asarray(ws), np.asarray(wi)
    differ = gi.numpy() != wi
    full = np.asarray(jax.nn.relu(
        np.asarray(R.embed_lookup(params, hot, cold)).reshape(2, -1)
        @ params["q_w0"] + params["q_b0"]) @ params["q_w1"] @ cands.T)
    rows = np.nonzero(differ)[0]
    np.testing.assert_allclose(full[rows, gi.numpy()[differ]],
                               full[rows, wi[differ]], rtol=RTOL, atol=ATOL)
    assert (np.diff(gs.numpy(), axis=1) <= 0).all()


def test_model_rejects_bad_params():
    params = {k: np.zeros(shape, np.float32)
              for k, (shape, _) in TR.xdeepfm_param_specs(TX.SMOKE).items()}
    convert.xdeepfm_params_from_numpy(params, TX.SMOKE, "cpu")
    bad = dict(params, cin_w0=np.zeros((8, 35), np.float32))
    with pytest.raises(ValueError, match="cin_w0"):
        convert.xdeepfm_params_from_numpy(bad, TX.SMOKE, "cpu")
    with pytest.raises(ValueError, match="names"):
        convert.xdeepfm_params_from_numpy(
            {k: v for k, v in params.items() if k != "bias"}, TX.SMOKE, "cpu")


def test_model_parameters_need_no_grad():
    model = TR.XDeepFM(TX.SMOKE, device="cpu", seed=3)
    assert all(not p.requires_grad for p in model.parameters())
    assert sorted(model.params()) == sorted(TR.xdeepfm_param_specs(TX.SMOKE))
