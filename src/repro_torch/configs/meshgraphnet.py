"""meshgraphnet: 15L d_hidden=128, sum aggregator, 2-layer MLPs.
[arXiv:2010.03409; unverified]"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES, register
from repro_torch.models.gnn import MGNConfig


def model_for_shape(shape: dict) -> MGNConfig:
    return MGNConfig(name="meshgraphnet", n_layers=15, d_hidden=128, mlp_layers=2,
                     d_node_in=shape.get("d_feat", 12), d_edge_in=4, d_out=3)


SMOKE = MGNConfig(name="mgn-smoke", n_layers=3, d_hidden=16, mlp_layers=2,
                  d_node_in=8, d_edge_in=4, d_out=3)

CONFIG = register(ArchSpec(
    name="meshgraphnet", family="gnn", model=model_for_shape, smoke=SMOKE,
    shapes=GNN_SHAPES, optimizer="adamw",
    notes="bounded-degree mesh graphs: degree separation is degenerate "
          "(few/no delegates) but the engine path is identical",
))
