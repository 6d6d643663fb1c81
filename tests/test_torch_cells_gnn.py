"""The GNN cells (``launch/cells.py::build_gnn_cell``) against the
reference's ``build_cell`` on the CPU: every GNN arch's primary cell
(``molecule``) and each GNN's ``full_graph_sm`` (``dist_full``, the
degree-separated engine's step on the rank's partition) and
``minibatch_lg`` at smoke, on a one-rank mesh (one spawned gloo rank,
``_torch_cells_world.py``). The rank draws the arguments from a seed; the
reference runs on the same ones (a ``dist_full`` partition rebuilt by the
reference's partitioner from the same seeded graph, ``_torch_cells_ref``).
Bounds: the loss at ``rtol 1e-5, atol 1e-6`` (float32), the parameters
after the step within 1e-3 of each leaf's change in the L2 norm. The
reference's cells are jitted once per module."""
import pytest
torch = pytest.importorskip("torch")

import _torch_cells_ref as R
from repro_torch.configs.base import all_archs, get_arch

GNN_ARCHS = ["gcn-cora", "meshgraphnet", "graphcast", "mace"]
CASES = sorted({(a, "molecule") for a in all_archs()
                if get_arch(a).family == "gnn"}
               | {(a, s) for a in GNN_ARCHS
                  for s in ("full_graph_sm", "minibatch_lg")})


@pytest.fixture(scope="module")
def outputs():
    return R.world_and_reference(CASES)


@pytest.mark.parametrize("arch,shape", CASES)
def test_gnn_cell_equals_reference(outputs, arch, shape):
    world, reference = outputs
    R.check_cell(world[arch, shape], reference[arch, shape], arch, shape)
