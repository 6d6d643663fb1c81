"""gemma3-1b: 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, 5:1
local:global sliding window (w=1024), 128k-class rope.
[hf:google/gemma-3-1b-pt; unverified]

The port's copy of ``repro.configs.gemma3_1b``."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4, n_kv=1, d_head=256,
    d_ff=6912, vocab=262144, window=1024, global_period=6, rope_theta=1_000_000.0,
    scan_layers=False,  # heterogeneous local/global pattern
)

SMOKE = LMConfig(
    name="gemma3-1b-smoke", n_layers=6, d_model=64, n_heads=4, n_kv=1, d_head=16,
    d_ff=128, vocab=512, window=8, global_period=6, scan_layers=False,
    dtype=torch.float32,
)

CONFIG = register(ArchSpec(
    name="gemma3-1b", family="lm", model=FULL, smoke=SMOKE, shapes=LM_SHAPES,
    # 4 q-heads / 1 kv-head cannot split 16-way: attention stays replicated
    # over "model"; TP lives on ffn + vocab. long_500k RUNS (hybrid
    # sliding-window arch: local layers hold w-sized ring caches).
    rules_override={"heads": None, "kv_heads": None},
    optimizer="adamw",
))
