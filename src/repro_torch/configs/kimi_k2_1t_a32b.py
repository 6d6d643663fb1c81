"""kimi-k2-1t-a32b: 61L d=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared, per the K2 report) -- trillion-param MoE.
[arXiv:2501.kimi2; unverified]

The port's copies of ``repro.configs.kimi_k2_1t_a32b``: ``kimi-k2-1t-a32b``
and its grouped-routing variant ``kimi-k2-1t-a32b-opt``."""
import dataclasses as _dc

import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64, n_kv=8, d_head=112,
    d_ff=0, vocab=163840, n_experts=384, n_experts_pad=384, top_k=8,
    d_ff_expert=2048, n_shared_experts=1, capacity_factor=1.25,
)

SMOKE = LMConfig(
    name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16,
    d_ff=0, vocab=512, n_experts=8, n_experts_pad=8, top_k=2, d_ff_expert=32,
    n_shared_experts=1, dtype=torch.float32,
)

CONFIG = register(ArchSpec(
    name="kimi-k2-1t-a32b", family="lm", model=FULL, smoke=SMOKE, shapes=LM_SHAPES,
    skip={"long_500k": "pure full-attention arch; 500k decode needs "
          "sub-quadratic attention (DESIGN.md Section 5)"},
    # EP over model x FSDP over data for the 1T expert bank:
    # 2.08TB bf16 / (16 EP x 16 FSDP) = 8.1 GB/device instead of 130 GB
    rules_override={"kv_heads": None, "moe_embed": "data"},
    # 1T params: factored-moment optimizer + microbatching are what make the
    # single-pod memory budget feasible (DESIGN.md Section 4)
    optimizer="adafactor",
    grad_accum={"train_4k": 8},
))

# grouped (shard-local) MoE dispatch on top of EPxFSDP
CONFIG_OPT = register(ArchSpec(
    name="kimi-k2-1t-a32b-opt", family="lm",
    model=_dc.replace(FULL, moe_groups=-1), smoke=SMOKE, shapes=LM_SHAPES,
    skip=CONFIG.skip,
    rules_override={"kv_heads": None, "moe_embed": "data"},
    optimizer="adafactor", grad_accum={"train_4k": 8},
    notes="grouped-dispatch MoE variant of kimi (SPerf hillclimb)",
))
