"""LM serving on a mesh: ``models/lm.py``'s ``prefill`` and
``decode_step`` with ``par``, the KV cache's decode layout
(``launch/sharding.py::cache_shardings``), split-KV decode attention
(``models/attention.py``) and the serving cells' wire count
(``launch/cells.py::lm_wire_bytes``), against the port's one-device path
and the JAX reference on the CPU.

One gloo world of 4 ranks (``_torch_lm_serve_world.py``) runs the five LM
specs' smoke configs at B = 2 on meshes ``(data 2, model 2)`` and ``(data
1, model 4)``, and gemma3 at B = 1 (its ``long_500k`` shape): a prefill
of 12 tokens at max_seq 20, then 8 decode steps. Together they take the
three cache layouts: qwen2-moe's n_kv 4 splits the kv heads on ``model``
2 and 4; gemma3's and granite's n_kv 1 split a global layer's slots over
``model`` (B = 2) or over every rank (B = 1); kimi's and qwen2.5's n_kv 2
split the kv heads on ``model`` 2 and the slots on ``model`` 4.

Bounds: each rank's block of every logits equals the one-device port's at
``rtol 1e-5`` and ``atol 1e-6`` times the largest |value| of the tensor
compared (float32 smoke configs; a tensor-parallel sum rounds at the
scale of the vector it sums, so a logit near 0 of a row whose largest is
3 carries about 1e-6 of absolute rounding), the logits put together
equal the reference's at the LM tests' ``LOGIT`` bound (the port's
one-device serving path against the reference), each rank's cache
equals its block of the one-device cache (``shard_tree``) at the same
bound as the logits, and the bytes each call's collectives counted equal
``cells.lm_wire_bytes`` exactly. The JAX references are jitted once per
module (``_torch_lm.serve_case``)."""
import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import _torch_lm_serve_world as W
from _torch_lm import LOGIT, PRIM, serve_case
from repro.configs import base as RCB
from repro_torch.configs import base as TCB
from repro_torch.core import comm as TC, convert
from repro_torch.launch import sharding as TS
from repro_torch.models import lm as TL
from repro_torch.tree import flatten_with_path

# the reference loads its registry only while it is empty
RCB._load_all()

KEYS = [(m, a, b) for m in W.MESHES for a, b in W.CASES]


def inputs() -> dict:
    """Per case: the reference's parameters (numpy), prompts and the
    greedy tokens it fed its decode steps (B = 1: row 0 of B = 2; gemma3
    is dense, so its rows do not interact). The references are computed
    in a pool of threads (XLA compiles with the GIL released)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda a: serve_case(a, True), W.ARCHS))
    out = {}
    for arch, b in W.CASES:
        case = serve_case(arch, True)
        out[arch, b] = {"params": case["params"],
                        "prompts": case["prompts"][:b],
                        "tokens": [tok[:b] for tok, _, _ in case["steps"]]}
    return out


@pytest.fixture(scope="module")
def world():
    return TC.dist.spawn(W.serve_world, W.WORLD, (inputs(),), timeout=300.0)


def one_device(arch: str, b: int) -> dict:
    """The port's one-device prefill and decode steps on the same
    inputs: logits, the cache after the prefill and after the last
    step."""
    cfg = TCB.get_arch(arch).smoke
    case = inputs()[arch, b]
    p = convert.tree_from_numpy(case["params"], "cpu")
    logits, cache = TL.prefill(cfg, p, torch.from_numpy(case["prompts"]),
                               W.MAX_SEQ, last_only=True)
    out = {"prefill": logits.numpy(),
           "cache_prefill": convert.tree_to_numpy(cache), "steps": []}
    for i, tok in enumerate(case["tokens"]):
        logits, cache = TL.decode_step(cfg, p, cache, torch.from_numpy(tok),
                                       W.PROMPT + i)
        out["steps"].append(logits.numpy())
    out["cache"] = convert.tree_to_numpy(cache)
    return out


_ONE = {}


def one(arch: str, b: int) -> dict:
    if (arch, b) not in _ONE:
        _ONE[arch, b] = one_device(arch, b)
    return _ONE[arch, b]


def close(got: np.ndarray, want: np.ndarray, msg: str = "") -> None:
    """``rtol 1e-5``, ``atol 1e-6`` at the scale of ``want``."""
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=PRIM["rtol"],
                               atol=PRIM["atol"] * scale, err_msg=msg)


def block(x: np.ndarray, r: dict) -> np.ndarray:
    """A rank's block (its rows, its vocabulary) of whole logits."""
    return x[slice(*r["rows"]), ..., slice(*r["vocab"])]


@pytest.mark.parametrize("mesh,arch,b", KEYS)
def test_serve_logits_equal_one_device(world, mesh, arch, b):
    want = one(arch, b)
    for r in world:
        got = r[mesh, arch, b]
        close(got["prefill"], block(want["prefill"], got))
        for g, w in zip(got["steps"], want["steps"]):
            close(g, block(w, got))


@pytest.mark.parametrize("mesh,arch,b", KEYS)
def test_serve_logits_equal_reference(world, mesh, arch, b):
    """The ranks' blocks put together equal the reference's prefill and
    decode logits."""
    case = serve_case(arch, True)
    want = [case["logits"][:b]] + [out[:b] for _, out, _ in case["steps"]]
    for j, w in enumerate(want):
        whole = np.full(w.shape, np.nan, np.float32)
        for r in world:
            got = r[mesh, arch, b]
            whole[slice(*got["rows"]), ..., slice(*got["vocab"])] = (
                got["prefill"] if j == 0 else got["steps"][j - 1])
        np.testing.assert_allclose(whole, w, **LOGIT)


@pytest.mark.parametrize("mesh,arch,b", KEYS)
def test_rank_cache_is_its_block_of_the_whole(world, mesh, arch, b):
    """After the prefill and after the last step each rank holds exactly
    its blocks (``shard_tree``) of the one-device cache."""
    axes, sizes = W.MESHES[mesh]
    cfg = TCB.get_arch(arch).smoke
    sh = TS.cache_shardings(cfg, types.SimpleNamespace(axes=axes, sizes=sizes),
                            b, W.MAX_SEQ)
    want = one(arch, b)
    for rank, r in enumerate(world):
        lay = TS.MeshLayout.of(axes, sizes, rank)
        for key in ("cache_prefill", "cache"):
            blocks = dict(flatten_with_path(TS.shard_tree(want[key], sh, lay)))
            got = dict(flatten_with_path(r[mesh, arch, b][key]))
            assert sorted(got) == sorted(blocks)
            for k in blocks:
                assert got[k].shape == blocks[k].shape, (key, k)
                close(got[k], blocks[k], f"{key} {k}")


@pytest.mark.parametrize("mesh,arch,b", KEYS)
def test_serve_wire_equals_the_count_from_shapes(world, mesh, arch, b):
    for r in world:
        got = r[mesh, arch, b]
        assert got["wire"] == got["reckoned"]


def test_layouts_take_every_case(world):
    """The cases split the kv heads, a global layer's slots over ``model``
    and over every rank; the split-KV combine puts bytes on the wire,
    and no cache is gathered whole (the attention's bytes a step stay
    below the cache's)."""
    seen = set()
    for mesh, arch, b in KEYS:
        axes, sizes = W.MESHES[mesh]
        cfg = TCB.get_arch(arch).smoke
        for layer in TS.cache_shardings(
                cfg, types.SimpleNamespace(axes=axes, sizes=sizes), b,
                W.MAX_SEQ):
            dims = layer["k"].dims
            seen.add(("heads" if dims[2] else "slots", dims[1]))
        decode = world[0][mesh, arch, b]["wire"][1]
        if any(sh["k"].dims[1] for sh in TS.cache_shardings(
                cfg, types.SimpleNamespace(axes=axes, sizes=sizes), b,
                W.MAX_SEQ)):
            assert decode.get("split_kv", 0) > 0, (mesh, arch, b)
        whole = sum(np.prod(c[k].shape) * 4 for c in one(arch, b)["cache"]
                    for k in ("k", "v"))
        attention = decode.get("split_kv", 0) + decode.get("cache", 0)
        assert attention < whole, (mesh, arch, b)
    assert ("heads", ()) in seen
    assert ("slots", ("model",)) in seen
    assert ("slots", ("data", "model")) in seen
