"""mace: 2L d_hidden=128 l_max=2 correlation=3 n_rbf=8 E(3)-equivariant.
[arXiv:2206.07697; paper]

The port's copies of ``repro.configs.mace``: ``mace``, its communication
variant ``mace-opt`` (positions-only nn fetch, bfloat16 messages) and
``SMOKE``.
"""
import torch

from repro_torch.configs.base import ArchSpec, GNN_SHAPES, register
from repro_torch.models.equivariant import MACEConfig


def model_for_shape(shape: dict) -> MACEConfig:
    return MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                      correlation=3, n_rbf=8, n_species=10)


SMOKE = MACEConfig(name="mace-smoke", n_layers=2, d_hidden=8, n_rbf=4,
                   n_species=5)

CONFIG = register(ArchSpec(
    name="mace", family="gnn", model=model_for_shape, smoke=SMOKE,
    shapes=GNN_SHAPES, optimizer="adamw",
    notes="direct l<=2 Gaunt contraction (eSCN trick only pays at L>=4); "
          "node payload for the distributed path = positions + irreps",
))


def model_for_shape_opt(shape: dict) -> MACEConfig:
    return MACEConfig(name="mace-opt", n_layers=2, d_hidden=128, l_max=2,
                      correlation=3, n_rbf=8, n_species=10,
                      dist_fetch_pos_only=True, dist_msg_dtype=torch.bfloat16)


CONFIG_OPT = register(ArchSpec(
    name="mace-opt", family="gnn", model=model_for_shape_opt, smoke=SMOKE,
    shapes=GNN_SHAPES, optimizer="adamw",
    notes="communication variant of mace: positions-only nn fetch + "
          "bfloat16 messages",
))

__all__ = ["CONFIG", "CONFIG_OPT", "GNN_SHAPES", "SMOKE", "model_for_shape",
           "model_for_shape_opt"]
