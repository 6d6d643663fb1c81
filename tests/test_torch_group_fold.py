"""The delegate combine's prev-less folds against the reference, on the CPU
(the plain versions the card's kernels are held to): the K-way fold of a
gathered ``[K, n]`` (``kernels.ops.group_fold``) against
``repro.kernels.ref``'s folds; the group fold of the emulated stacked rows
over an axis group, read in place by stride, against the reference's
gather-fold over that group under a nested ``vmap``; ``delegate_combine``
and ``delegate_min_apply`` under ``hier`` on one and two emulated axes
against the reference's combine (then ``minimum`` and ``any``), bytes
equal; and a group of one member, which is the identity. Inputs come from
numpy seeds; every comparison is exact (integers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import comm as RC
from repro.kernels import ref as RK
from repro_torch.core import comm as TC
from repro_torch.core.comm import reduce as TR
from repro_torch.core.partition import partition_graph
from repro_torch.graphs.rmat import rmat_graph
from repro_torch.kernels import ops

INF = 2**30
#: the two-axis emulated plans, rows stacked row-major over (outer, inner)
TWO_AXES = [{"outer": 2, "inner": 2}, {"outer": 2, "inner": 3}]
AXES = [{"p": 4}] + TWO_AXES


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _ints(rng, shape):
    """int32 values over the whole range, a third of them the 2^30
    identity of the combine spec."""
    x = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    x[rng.random(shape) < 0.3] = INF
    return x


def _inputs(op, rng, shape):
    x = _words(rng, shape) if op == "or" else _ints(rng, shape)
    return x, torch.from_numpy(x.view(np.int32))


def _np(t, like):
    a = t.contiguous().numpy()
    return a.view(np.uint32) if like.dtype == np.uint32 else a


def ref_vmap(fn, x, axes: dict):
    """``fn(v)`` of each partition's row of ``x [p, n]`` under the
    reference's vmap over ``axes`` (nested for two axes) -> ``[p, n]``."""
    names, sizes = tuple(axes), tuple(axes.values())
    f = jax.vmap(fn, axis_name=names[-1])
    if len(names) == 2:
        f = jax.vmap(f, axis_name=names[0])
    out = np.asarray(f(jnp.asarray(x).reshape(sizes + x.shape[1:])))
    return out.reshape((-1,) + x.shape[1:])


# ------------------------------------------------- the prev-less K-way fold
@pytest.mark.parametrize("op", ["or", "min"])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [1, 7, 61])
def test_prevless_fold_matches_reference_folds(op, k, n):
    """``group_fold`` of a gathered ``[K, n]`` equals the reference's fold
    into the op's identity (``mask_reduce_ref`` into 0; for the min,
    ``payload_min_fold_ref`` into the int32 maximum, so no value is cut
    at 2^30)."""
    x, t = _inputs(op, np.random.default_rng(k * 100 + n), (k, n))
    if op == "or":
        want, _ = RK.mask_reduce_ref(jnp.asarray(x), jnp.zeros(n, jnp.uint32),
                                     with_count=False)
    else:
        want, _ = RK.payload_min_fold_ref(
            jnp.asarray(x), jnp.full(n, 2**31 - 1, jnp.int32),
            with_count=False)
    got = ops.group_fold(t, op, k)
    assert got.shape == (1, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got[0], x), np.asarray(want))


@pytest.mark.parametrize("args", [
    ("max", 2), ("or", 0), ("min", 5), ("or", 2, -1),
    ("or", 1, 1, 0), ("min", 2, 2, 3, 1)], ids=str)
def test_group_fold_refuses_a_bad_geometry(args):
    """An op without a kernel, no member, a member or group past the last
    row, or a negative stride raise ValueError on the CPU too."""
    with pytest.raises(ValueError):
        ops.group_fold(torch.zeros((4, 3), dtype=torch.int32), *args)


# ----------------------------------------- the group fold of stacked rows
@pytest.mark.parametrize("op", ["or", "min"])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("inner", [2, 3])
def test_group_fold_of_stacked_rows_matches_reference(op, k, inner):
    """The rows of (outer = K, inner) folded over ``"outer"`` in place
    (member ``i`` of group ``g`` is row ``i * inner + g``): row ``g`` of the
    result is group ``g``'s fold, the reference's gather-fold over
    ``"outer"`` alone at inner position ``g``."""
    n = 13
    x, t = _inputs(op, np.random.default_rng(k * 10 + inner), (k * inner, n))
    got = ops.group_fold(t, op, k, inner, inner, 1)
    cfg = RC.CommConfig(delegate="allgather")
    want = ref_vmap(lambda v: RC.delegate_combine(
        RC.CommPlan(cfg, ("outer",), (k,)), v, op)[0], x,
        {"outer": k, "inner": inner})
    np.testing.assert_array_equal(_np(got, x), want[:inner])
    members = x.reshape(k, inner, n)
    fold = (np.bitwise_or.reduce(members, 0) if op == "or"
            else members.min(0))
    np.testing.assert_array_equal(_np(got, x), fold)


@pytest.mark.parametrize("op", ["or", "min"])
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_hier_delegate_combine_matches_reference(op, axes):
    """``delegate_combine`` under ``hier`` (``hier_split`` 1): the group
    fold over ``"outer"``, then the fold of the rows it leaves; every row
    equals the reference's two-level gather-fold, bytes equal."""
    p = int(np.prod(list(axes.values())))
    x, t = _inputs(op, np.random.default_rng(p + len(op)), (p, 17))
    cfg = dict(delegate="hier", hier_split=1)
    seen = {}

    def ref(v):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(**cfg), tuple(axes)), v, op)
        return out

    want = ref_vmap(ref, x, axes)
    before = dict(ops.LAUNCHES)
    got, nbytes = TC.delegate_combine(TC.plan_for(TC.CommConfig(**cfg), axes),
                                      t, op)
    assert ops.LAUNCHES == before                 # CPU: the plain versions
    np.testing.assert_array_equal(_np(got, x), want)
    assert nbytes == seen["bytes"]


# ------------------------------------------------- the min update under hier
def _min_case(rng, p: int, n: int, payload: bool):
    """Candidates ``[p, n]`` and the replicated delegate state ``[p, n]``:
    single-source levels (``it + 1`` where a partition reached the
    delegate) or payload-plane values (min-plus distances), both with the
    2^30 identity."""
    if payload:
        cand = np.where(rng.random((p, n)) < 0.3,
                        rng.integers(0, 900, (p, n)), INF)
        prev = np.where(rng.random((1, n)) < 0.5,
                        rng.integers(0, 900, (1, n)), INF)
    else:
        cand = np.where(rng.random((p, n)) < 0.3, 4, INF)
        prev = np.where(rng.random((1, n)) < 0.4,
                        rng.integers(0, 4, (1, n)), INF)
    return (cand.astype(np.int32),
            np.broadcast_to(prev, (p, n)).astype(np.int32).copy())


@pytest.fixture(scope="module")
def delegates():
    """The delegate count of a scale-8 RMAT partition (th = 16)."""
    return partition_graph(rmat_graph(8, seed=11), th=16, p_rank=2,
                           p_gpu=2).d


@pytest.mark.parametrize("payload", [False, True], ids=["levels", "payload"])
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_hier_delegate_min_apply_matches_reference(axes, payload, delegates):
    """``delegate_min_apply`` under ``hier``: on one axis the fused apply
    over every partition's candidates, on two the group fold over
    ``"outer"`` and the apply over the rows it leaves. The single-source
    levels (``n = d``) and the payload plane (``n = d * W``, W = 8) equal
    the reference's combine followed by ``minimum`` and ``any``; bytes
    equal."""
    p = int(np.prod(list(axes.values())))
    n = delegates * (8 if payload else 1)
    cand, prev = _min_case(np.random.default_rng(p * 3 + payload), p, n,
                           payload)
    cfg = dict(delegate="hier", hier_split=1)
    seen = {}

    def ref(v):
        out, seen["bytes"] = RC.delegate_combine(
            RC.plan_for(RC.CommConfig(**cfg), tuple(axes)), v, "min")
        return out

    reduced = ref_vmap(ref, cand, axes)
    want = np.minimum(prev, reduced)
    got, improved, nbytes = TC.delegate_min_apply(
        TC.plan_for(TC.CommConfig(**cfg), axes), torch.from_numpy(cand),
        torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(improved.numpy(), (want < prev).any(1))
    assert improved.dtype == torch.bool and improved.any()
    assert nbytes == seen["bytes"]


# --------------------------------------------- a group of one member (K = 1)
@pytest.mark.parametrize("op", ["or", "min"])
def test_group_of_one_member_is_the_identity(op):
    """A group of one member folds nothing: ``hier``'s first level over
    ``"outer"`` of size 1 hands back its input rows themselves (nothing
    gathered, nothing launched, no copy), the K = 1 fold of a gathered
    row equals it, and the whole combine still equals the reference's."""
    x, t = _inputs(op, np.random.default_rng(5), (3, 11))
    plan = TC.plan_for(TC.CommConfig(delegate="hier"), {"outer": 1,
                                                        "inner": 3})
    assert TR._fold_groups(plan, t, (("outer",),), op) is t
    np.testing.assert_array_equal(_np(ops.group_fold(t[:1], op, 1), x),
                                  x[:1])
    want = ref_vmap(lambda v: RC.delegate_combine(
        RC.plan_for(RC.CommConfig(delegate="hier"), ("outer", "inner")), v,
        op)[0], x, {"outer": 1, "inner": 3})
    np.testing.assert_array_equal(_np(TC.delegate_combine(plan, t, op)[0], x),
                                  want)
