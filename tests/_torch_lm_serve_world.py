"""World function of the LM-serving-on-a-mesh tests
(``test_torch_lm_serve_mesh.py``), and the inputs it shares with the
parent.

One world of ``WORLD`` gloo ranks builds the meshes of ``MESHES`` (every
rank in the same order) and, on each, the prefill and decode cells
(``launch.cells``' ``LMServeCell``, smoke configs, max_seq ``MAX_SEQ``) of
every spec of ``ARCHS`` at the batch of ``CASES``: the prefill of the
parent's prompts (each rank its rows), then ``STEPS`` decode steps fed the
parent's tokens. Each rank returns its vocabulary block of every logits,
its cache blocks after the prefill and after the last step, and the wire
bytes each call counted beside ``cells.lm_wire_bytes``. Port imports
only: a spawned rank imports no JAX."""
import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core import convert
from repro_torch.launch import cells, mesh as M
from repro_torch.launch.sharding import rules_for

WORLD = 4
MESHES = {"2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4))}
ARCHS = ("gemma3-1b", "granite-34b", "qwen2.5-14b", "kimi-k2-1t-a32b",
         "qwen2-moe-a2.7b")
#: (arch, batch) of every case on every mesh: the five specs at B = 2 and
#: gemma3's long_500k shape, one sequence (its global layers' slots over
#: every rank)
CASES = tuple((a, 2) for a in ARCHS) + (("gemma3-1b", 1),)
PROMPT, MAX_SEQ, STEPS = 12, 20, 8


def serve_cells(arch: str, batch: int, mesh):
    """The prefill and decode cells of ``arch``'s smoke config at
    ``batch`` x ``MAX_SEQ`` on ``mesh``."""
    spec = get_arch(arch)
    cfg = cells.resolve_config(spec, mesh, smoke=True)
    rules = rules_for(mesh, spec.rules_override)
    return tuple(cells.lm_serve_cell(
        {"kind": kind, "global_batch": batch, "seq_len": MAX_SEQ}, cfg,
        rules, mesh) for kind in ("prefill", "decode"))


def _np(tree):
    return convert.tree_to_numpy(tree)


def run_case(pre, dec, params: dict, prompts: np.ndarray,
             tokens: list) -> dict:
    """Prefill then the decode steps on this rank's shards and rows."""
    p = pre.shard_params(convert.tree_from_numpy(params, "cpu"))
    rows = pre.rows(torch.from_numpy(prompts))
    before = dict(pre.par.tally)
    logits, cache = pre.step(p, rows)
    wire = [_since(pre.par.tally, before)]
    reckoned = [cells.lm_wire_bytes(pre, rows.shape[0], PROMPT)]
    out = {"prefill": logits.numpy(), "cache_prefill": _np(cache), "steps": []}
    for i, tok in enumerate(tokens):
        before = dict(dec.par.tally)
        t = dec.rows(torch.from_numpy(tok))
        logits, cache = dec.step(p, cache, t, PROMPT + i)
        wire.append(_since(dec.par.tally, before))
        reckoned.append(cells.lm_wire_bytes(dec, t.shape[0], 1))
        out["steps"].append(logits.numpy())
    out.update(cache=_np(cache), wire=wire, reckoned=reckoned,
               rows=pre.row_span(), vocab=pre.par.span("vocab", pre.cfg.vocab))
    return out


def _since(tally: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in tally.items()
            if v != before.get(k, 0)}


def serve_world(rank: int, world: int, inputs: dict) -> dict:
    """Every case on every mesh; ``inputs[arch, batch]``: the parameters
    (numpy), the prompts and the tokens of each decode step."""
    out = {}
    for name, (axes, sizes) in MESHES.items():
        mesh = M.make_test_mesh(sizes, axes)
        for arch, b in CASES:
            pre, dec = serve_cells(arch, b, mesh)
            case = inputs[arch, b]
            out[name, arch, b] = run_case(pre, dec, case["params"],
                                          case["prompts"], case["tokens"])
    return out


def one_rank_cells(rank: int, world: int) -> dict:
    """On the card (``tests/test_torch_cuda.py``): gemma3-1b's smoke
    ``prefill_32k`` and ``decode_32k`` cells on a world of one rank under
    NCCL (``launch.cells.build_cell``), each step against the one-card
    path (``models.lm`` without ``par``) on the same drawn arguments,
    float32, TF32 off."""
    from repro_torch.models import lm as LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = M.make_test_mesh((1, 1))
    out = {}
    for shape in ("prefill_32k", "decode_32k"):
        cell = cells.build_cell("gemma3-1b", shape, mesh, smoke=True)
        cfg, s = cell.cfg, cell.shape[1]
        args = cell.args(0, dev)
        if cell.kind == "prefill":
            got = cell.step(*args)
            want = LM.prefill(cfg, args[0], args[1], s, last_only=True)
        else:
            params, cache, token, pos = args
            copy = [{k: v.clone() for k, v in c.items()} for c in cache]
            got = cell.step(params, cache, token, pos)
            want = LM.decode_step(cfg, params, copy, token, pos)
        out[shape] = {"cell": _np(got), "one": _np(want)}
    return out
