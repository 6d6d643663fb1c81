"""qwen2-moe-a2.7b: 24L d=2048 16H (kv=16) expert d_ff=1408 vocab=151936,
MoE 60 routed top-4 + 4 shared experts. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The port's copies of ``repro.configs.qwen2_moe_a2_7b``: ``qwen2-moe-a2.7b``
and its grouped-routing variant ``qwen2-moe-a2.7b-opt``."""
import dataclasses as _dc

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16, n_kv=16, d_head=128,
    d_ff=0, vocab=151936, n_experts=60, n_experts_pad=64, top_k=4,
    d_ff_expert=1408, n_shared_experts=4, qkv_bias=True,
)

SMOKE = LMConfig(
    name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16,
    d_ff=0, vocab=512, n_experts=6, n_experts_pad=8, top_k=2, d_ff_expert=32,
    n_shared_experts=2, qkv_bias=True, dtype=torch.float32,
)

CONFIG = register(ArchSpec(
    name="qwen2-moe-a2.7b", family="lm", model=FULL, smoke=SMOKE, shapes=LM_SHAPES,
    skip={"long_500k": "pure full-attention arch; 500k decode needs "
          "sub-quadratic attention (DESIGN.md Section 5)"},
    optimizer="adamw",
))

# grouped routing (moe_groups = the data-axis size, resolved by the
# launcher): the reference's variant that removes the per-layer token
# all-gather a global argsort forces under auto-sharding
CONFIG_OPT = register(ArchSpec(
    name="qwen2-moe-a2.7b-opt", family="lm",
    model=_dc.replace(FULL, moe_groups=-1), smoke=SMOKE, shapes=LM_SHAPES,
    skip=CONFIG.skip, optimizer="adamw",
    notes="grouped-dispatch MoE variant (SPerf hillclimb)",
))
