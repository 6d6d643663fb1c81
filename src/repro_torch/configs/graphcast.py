"""graphcast: encoder-processor-decoder mesh GNN, 16L d_hidden=512,
n_vars=227. [arXiv:2212.12794; unverified]

The multimesh topology is the graph's, not the config's: ``mesh_batch``
(``multimesh_levels``) builds it."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES, register
from repro_torch.models.gnn import GraphCastConfig


def model_for_shape(shape: dict) -> GraphCastConfig:
    return GraphCastConfig(name="graphcast", n_layers=16, d_hidden=512,
                           n_vars=shape.get("d_feat", 227))


SMOKE = GraphCastConfig(name="graphcast-smoke", n_layers=2, d_hidden=16, n_vars=5)

CONFIG = register(ArchSpec(
    name="graphcast", family="gnn", model=model_for_shape, smoke=SMOKE,
    shapes=GNN_SHAPES, optimizer="adamw",
    notes="multimesh coarse-level hubs are high-degree -> delegates engage "
          "there; n_vars plays the d_feat role on the generic graph shapes",
))
