"""xdeepfm: 39 sparse fields, embed_dim=10, CIN 200-200-200, MLP 400-400.
[arXiv:1803.05170; paper]

The port's copies of ``repro.configs.xdeepfm`` ``FULL`` / ``SMOKE`` and its
registry entry, with the reference's rule that shards the cold rows
(``table_rows``) over the mesh (``RECSYS_SHAPES``, the recsys shape set,
is re-exported from :mod:`repro_torch.configs.base`).
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.recsys import XDeepFMConfig

FULL = XDeepFMConfig(
    name="xdeepfm", n_sparse=39, embed_dim=10, cin_layers=(200, 200, 200),
    mlp_layers=(400, 400),
    n_hot=1 << 18,    # frequency delegates: replicated
    n_cold=1 << 25,   # ~33.5M Criteo-scale rows: mod-p sharded
)

SMOKE = XDeepFMConfig(
    name="xdeepfm-smoke", n_sparse=6, embed_dim=4, cin_layers=(8, 8),
    mlp_layers=(16,), n_hot=64, n_cold=512,
)

CONFIG = register(ArchSpec(
    name="xdeepfm", family="recsys", model=FULL, smoke=SMOKE,
    shapes=RECSYS_SHAPES, optimizer="adamw",
    rules_override={"table_rows": ("data", "model")},
    notes="hot/cold embedding split == the paper's delegate/normal classes",
))

__all__ = ["CONFIG", "FULL", "RECSYS_SHAPES", "SMOKE"]
