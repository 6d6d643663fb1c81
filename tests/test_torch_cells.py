"""The cells (``launch/cells.py``: ``build_cell``, ``all_cells``, the LM
train / prefill / decode cells, ``build_recsys_cell``,
``build_bfs_cell``) against the reference's ``build_cell`` on the CPU --
the twin of ``tests/test_arch_smoke.py``; the GNN cells are in
``test_torch_cells_gnn.py``.

Every LM, recsys and BFS arch's primary cell, the LM archs'
``decode_32k`` and ``prefill_32k``, xDeepFM's ``serve_p99`` and
``retrieval_cand`` and the BFS ``rmat_weak`` cell run at smoke on a
one-rank mesh (one spawned gloo rank, ``_torch_cells_world.py``). The rank
draws the arguments from a seed (``cell.args``) and returns them with the
outputs; the reference's cell runs on the same arguments (the BFS
partition rebuilt by the reference's partitioner from the same seeded
graph; ``_torch_cells_ref.py``).

Bounds: losses, recsys logits and scores at ``rtol 1e-5, atol 1e-6``
(float32 smoke configs); the LM prefill and decode logits and caches at
the LM tests' ``LOGIT`` bound (``rtol 1e-4, atol 1e-5``: what the port's
one-device serving path holds against the reference,
``tests/_torch_lm.py``); the parameters after a step within 1e-3 of each
leaf's change in the L2 norm (AdamW's ``m / sqrt(v)`` amplifies float32
rounding where ``m`` is near 0, as in ``test_torch_lm_mesh.py``);
retrieval ids, BFS levels and every BFS counter exactly. The reference's
cells are jitted once per module."""
import pytest
torch = pytest.importorskip("torch")

import _torch_cells_ref as R
from repro.configs import all_archs as ref_all_archs
from repro.launch import cells as RC
from repro_torch.configs.base import all_archs, get_arch
from repro_torch.launch import cells as TCL

PRIMARY = {"lm": "train_4k", "recsys": "train_batch", "bfs": "rmat_s30"}
LM_ARCHS = ["gemma3-1b", "granite-34b", "qwen2.5-14b", "kimi-k2-1t-a32b",
            "qwen2-moe-a2.7b"]
CASES = sorted({(a, PRIMARY[get_arch(a).family]) for a in all_archs()
                if get_arch(a).family in PRIMARY}
               | {(a, s) for a in LM_ARCHS for s in ("decode_32k", "prefill_32k")}
               | {("xdeepfm", "serve_p99"), ("xdeepfm", "retrieval_cand"),
                  ("bfs-rmat", "rmat_weak")})


@pytest.fixture(scope="module")
def outputs():
    return R.world_and_reference(CASES)


def test_all_cells_equal_the_references():
    assert TCL.all_cells(include_skipped=True) == RC.all_cells(include_skipped=True)
    assert TCL.all_cells() == RC.all_cells()
    assert all_archs() == ref_all_archs()


def test_build_cell_refuses_a_skipped_shape():
    with pytest.raises(ValueError, match="skipped"):
        TCL.build_cell("qwen2.5-14b", "long_500k", None)


@pytest.mark.parametrize("arch,shape", CASES)
def test_cell_equals_reference(outputs, arch, shape):
    world, reference = outputs
    R.check_cell(world[arch, shape], reference[arch, shape], arch, shape)
