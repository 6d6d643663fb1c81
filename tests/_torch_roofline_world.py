"""World function of the dry-run tests (``test_torch_roofline.py``): the
real rank whose step the dry run counts.

Every rank of a gloo world of ``WORLD`` builds the ``(data 2, model 2)``
mesh and, for each cell of ``CELLS`` (smoke), draws its arguments from
seed 0 on the CPU and runs the step under ``launch.dryrun.StepCounter``
(real tensors: it only counts), then once more under
``torch.utils.flop_counter.FlopCounterMode``. Rank 0 returns what it
counted: the arguments' bytes, flops by dtype, collectives by kind and by
mesh axes, the model's own tally by key, and FlopCounterMode's total.
Port imports only: a spawned rank imports no JAX."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import cells, dryrun, mesh as M

WORLD, SIZES = 4, (2, 2)
#: cells whose arguments and collectives are the same real or fake: the
#: LM train, prefill and decode steps (split-KV on gemma3) and a batched
#: GNN step (the data-parallel gradient sum)
CELLS = ("qwen2.5-14b/train_4k", "qwen2-moe-a2.7b/prefill_32k",
         "gemma3-1b/decode_32k", "meshgraphnet/molecule")


def count_world(rank: int, world: int) -> dict:
    mesh = M.make_test_mesh(SIZES)
    out = {}
    for name in CELLS:
        arch, shape = name.split("/")
        cell = cells.build_cell(arch, shape, mesh, smoke=True)
        args = cell.args(0, "cpu")
        par = getattr(cell, "par", None)
        before = dict(par.tally) if par is not None else {}
        counter = dryrun.StepCounter(mesh)
        arg_bytes = dryrun.tree_bytes(args)
        with counter:
            cell.step(*args)
        rec = counter.record()
        rec["argument_size_in_bytes"] = arg_bytes
        if par is not None:
            rec["tally"] = {k: v - before.get(k, 0) for k, v in
                            par.tally.items() if v != before.get(k, 0)}
        again = cell.args(0, "cpu")
        with FlopCounterMode(display=False) as fc:
            cell.step(*again)
        rec["flop_counter"] = fc.get_total_flops()
        out[name] = rec
    return out if rank == 0 else {}
