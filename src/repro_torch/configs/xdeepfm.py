"""xdeepfm: 39 sparse fields, embed_dim=10, CIN 200-200-200, MLP 400-400.
[arXiv:1803.05170; paper]

The port's copies of ``repro.configs.xdeepfm`` ``FULL`` / ``SMOKE`` and of
``repro.configs.base.RECSYS_SHAPES`` (the recsys shape set).
"""
from repro_torch.models.recsys import XDeepFMConfig

FULL = XDeepFMConfig(
    name="xdeepfm", n_sparse=39, embed_dim=10, cin_layers=(200, 200, 200),
    mlp_layers=(400, 400),
    n_hot=1 << 18,    # frequency delegates: replicated
    n_cold=1 << 25,   # ~33.5M Criteo-scale rows
)

SMOKE = XDeepFMConfig(
    name="xdeepfm-smoke", n_sparse=6, embed_dim=4, cin_layers=(8, 8),
    mlp_layers=(16,), n_hot=64, n_cold=512,
)

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1000000),
}
