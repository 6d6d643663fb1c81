"""gcn-cora: 2L d_hidden=16, sym normalization. [arXiv:1609.02907; paper]"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES, register
from repro_torch.models.gnn import GCNConfig


def model_for_shape(shape: dict) -> GCNConfig:
    return GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16,
                     d_in=shape.get("d_feat", 16), n_classes=7, norm="sym")


SMOKE = GCNConfig(name="gcn-smoke", n_layers=2, d_hidden=8, d_in=12, n_classes=7)

CONFIG = register(ArchSpec(
    name="gcn-cora", family="gnn", model=model_for_shape, smoke=SMOKE,
    shapes=GNN_SHAPES, optimizer="adamw",
    notes="full-graph cells run on the degree-separated engine (paper path)",
))
