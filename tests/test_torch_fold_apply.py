"""The fused delegate updates of the port's traversal steps against the
same steps composed from the reference package on the CPU: the
reference's Pallas folds (``repro.kernels.mask_reduce`` /
``payload_min_fold``, interpret mode, as the reference's own tests run
them), then its ``unpack_lanes``, ``where``, ``minimum`` and ``any``.
Exact equality throughout (every quantity is an integer or a bool)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import comm as RC
from repro.kernels.mask_reduce import mask_reduce as pallas_mask_reduce
from repro.kernels.mask_reduce import payload_min_fold as pallas_min_fold
from repro_torch.core import comm as TC
from repro_torch.kernels import ops

INF = 2**30


def or_apply_inputs(rng, k, p, d, w, track_levels):
    """Gathered lane words ``[k, d * nw]`` (uint32; padding lanes at or
    above ``w`` set at random, as a wire buffer may carry them), a level
    plane ``[p, d, w]`` (int32 with INF rows and already-visited lanes, or
    the matching bool visited plane), ``it [p]`` and a target plane."""
    nw = -(-w // 32)
    words = rng.integers(0, 2**32, (k, d, nw), dtype=np.uint64).astype(np.uint32)
    words &= rng.integers(0, 2**32, (k, d, nw), dtype=np.uint64).astype(np.uint32)
    words[..., 0] |= np.uint32(1 << 31)                 # lane 31: sign bit
    levels = rng.integers(0, 6, (p, d, w)).astype(np.int32)
    levels[rng.random((p, d, w)) < 0.6] = INF
    levels[:, ::3] = INF                                # whole delegates unvisited
    it = rng.integers(3, 9, p).astype(np.int32)
    target = rng.random((p, d, w)) < 0.2
    level = levels if track_levels else levels != INF
    return words.reshape(k, d * nw), level, it, target


def ref_or_apply(gathered, level, it, target, w):
    """The reference serving step's chain on its fold's output."""
    k, n = gathered.shape
    p, d, _ = level.shape
    folded, _ = pallas_mask_reduce(jnp.asarray(gathered),
                                   jnp.zeros(n, jnp.uint32), tile_words=256,
                                   interpret=True, with_count=False)
    lanes = RC.unpack_lanes(folded.reshape(d, -1), w)
    level = jnp.asarray(level)
    unvis = ~level if level.dtype == jnp.bool_ else level == INF
    newly = lanes[None] & unvis
    if level.dtype == jnp.bool_:
        new_level, frontier = level | newly, newly
    else:
        new_level = jnp.where(newly, jnp.asarray(it)[:, None, None] + 1, level)
        frontier = None
    unhit = (None if target is None
             else jnp.any(jnp.asarray(target) & unvis & ~newly, axis=1))
    return (new_level, frontier, jnp.any(newly, axis=1), unhit,
            jnp.any(newly, axis=(1, 2)))


def assert_same(got, want):
    for name, g, w in zip(got._fields, got, want):
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("w", [32, 40, 64])
@pytest.mark.parametrize("track_levels", [True, False])
@pytest.mark.parametrize("targets", [True, False])
def test_mask_reduce_apply_plain_matches_reference(k, w, track_levels,
                                                   targets):
    rng = np.random.default_rng(k * 1000 + w * 10 + track_levels)
    gathered, level, it, target = or_apply_inputs(rng, k, 3, 37, w,
                                                  track_levels)
    target = target if targets else None
    want = ref_or_apply(gathered, level, it, target, w)
    got = ops.mask_reduce_apply(
        torch.from_numpy(gathered.view(np.int32)), torch.from_numpy(level),
        torch.from_numpy(it), None if target is None else torch.from_numpy(target))
    assert_same(got, want)
    assert bool(got.any_new.all())
    if track_levels:
        assert got.level.dtype == torch.int32
    else:
        assert got.level.dtype == torch.bool


def min_apply_inputs(rng, k, p, d):
    """Candidate levels ``[k, d]`` (INF where nothing was found) and delegate
    levels ``prev [p, d]`` with INF rows and a row nothing improves."""
    gathered = rng.integers(1, 9, (k, d)).astype(np.int32)
    gathered[rng.random((k, d)) < 0.6] = INF
    prev = rng.integers(0, 9, (p, d)).astype(np.int32)
    prev[rng.random((p, d)) < 0.5] = INF
    prev[0, ::2] = INF
    prev[-1] = 0                                  # nothing improves here
    return gathered, prev


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("p,d", [(1, 1), (3, 37), (2, 257)])
def test_payload_min_fold_apply_plain_matches_reference(k, p, d):
    rng = np.random.default_rng(k * 100 + p * 10 + d)
    gathered, prev = min_apply_inputs(rng, k, p, d)
    folded, _ = pallas_min_fold(jnp.asarray(gathered),
                                jnp.full(d, INF, jnp.int32), tile_words=256,
                                interpret=True, with_count=False)
    want = jnp.minimum(jnp.asarray(prev), folded[None])
    want_any = jnp.any(want < jnp.asarray(prev), axis=1)
    got, got_any = ops.payload_min_fold_apply(torch.from_numpy(gathered),
                                              torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_any.numpy(), np.asarray(want_any))
    assert got_any.dtype == torch.bool and not bool(got_any[-1])


@pytest.mark.parametrize("delegate", ["auto", "allgather"])
@pytest.mark.parametrize("p,d", [(1, 7), (2, 9), (4, 33)])
def test_delegate_min_apply_matches_reference_vmap(delegate, p, d):
    """The single-source step's min combine and update through comm: the
    reference's ``delegate_combine`` under ``vmap``, then ``minimum`` and
    ``any``; bytes equal."""
    rng = np.random.default_rng(p * 7 + d)
    cand, prev = min_apply_inputs(rng, p, p, d)
    seen = {}

    def ref(x):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(delegate=delegate), "p"), x, "min")
        return out

    reduced = jax.vmap(ref, axis_name="p")(jnp.asarray(cand))
    want = jnp.minimum(jnp.asarray(prev), reduced)
    before = dict(ops.LAUNCHES)
    got, improved, nbytes = TC.delegate_min_apply(
        TC.plan_for(TC.CommConfig(delegate=delegate), p),
        torch.from_numpy(cand), torch.from_numpy(prev))
    assert ops.LAUNCHES == before                 # CPU: the plain versions
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        improved.numpy(), np.asarray(jnp.any(want < jnp.asarray(prev), 1)))
    assert nbytes == seen["bytes"]


@pytest.mark.parametrize("w", [32, 40])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_delegate_or_apply_matches_reference_vmap(w, p):
    """The lane-word step's OR combine and update through comm: the
    reference's ``delegate_combine`` under ``vmap``, then its unpack and
    update; bytes equal."""
    rng = np.random.default_rng(p * 3 + w)
    d = 11
    gathered, level, it, target = or_apply_inputs(rng, p, p, d, w, True)
    words = gathered.reshape(p, d, -1)
    seen = {}

    def ref(x):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(), "p"), x, "or")
        return out

    reduced = jax.vmap(ref, axis_name="p")(jnp.asarray(words))
    newly = RC.unpack_lanes(reduced, w) & (jnp.asarray(level) == INF)
    got, nbytes = TC.delegate_or_apply(
        TC.plan_for(TC.CommConfig(), p), torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(level), torch.from_numpy(it), torch.from_numpy(target))
    np.testing.assert_array_equal(
        got.level.numpy(),
        np.asarray(jnp.where(newly, jnp.asarray(it)[:, None, None] + 1,
                             jnp.asarray(level))))
    np.testing.assert_array_equal(got.lane_new.numpy(),
                                  np.asarray(jnp.any(newly, axis=1)))
    np.testing.assert_array_equal(got.any_new.numpy(),
                                  np.asarray(jnp.any(newly, axis=(1, 2))))
    assert nbytes == seen["bytes"]


def test_apply_wrappers_take_the_plain_versions_on_cpu():
    """CPU tensors never launch or count; mixed devices are refused."""
    before = dict(ops.LAUNCHES)
    z = torch.zeros((2, 3), dtype=torch.int32)
    ops.payload_min_fold_apply(z, z)
    ops.mask_reduce_apply(z, torch.zeros((2, 3, 32), dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32))
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError):
        ops.payload_min_fold_apply(z, z.to("meta"))
