"""qwen2.5-14b: 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias.
[hf:Qwen/Qwen2.5-14B; hf]

The port's copy of ``repro.configs.qwen2_5_14b``."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_head=128,
    d_ff=13824, vocab=152064, qkv_bias=True, tie_embeddings=False,
)

SMOKE = LMConfig(
    name="qwen2.5-14b-smoke", n_layers=3, d_model=64, n_heads=8, n_kv=2, d_head=8,
    d_ff=128, vocab=512, qkv_bias=True, tie_embeddings=False, dtype=torch.float32,
)

CONFIG = register(ArchSpec(
    name="qwen2.5-14b", family="lm", model=FULL, smoke=SMOKE, shapes=LM_SHAPES,
    skip={"long_500k": "pure full-attention arch; 500k decode needs "
          "sub-quadratic attention (DESIGN.md Section 5)"},
    # 40 heads over 16-way model axis: GSPMD pads the ragged final shards
    rules_override={"kv_heads": None},
    optimizer="adamw",
))
