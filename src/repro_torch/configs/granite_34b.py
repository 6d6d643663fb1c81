"""granite-34b: 88L d=6144 48H (GQA kv=1/MQA) d_ff=24576 vocab=49152,
llama-arch code model. [arXiv:2405.04324; hf]

The port's copy of ``repro.configs.granite_34b``."""
import torch

from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.lm import LMConfig

FULL = LMConfig(
    name="granite-34b", n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_head=128,
    d_ff=24576, vocab=49152, tie_embeddings=False, mlp="gelu",
)

SMOKE = LMConfig(
    name="granite-34b-smoke", n_layers=3, d_model=96, n_heads=6, n_kv=1, d_head=16,
    d_ff=192, vocab=512, tie_embeddings=False, mlp="gelu", dtype=torch.float32,
)

CONFIG = register(ArchSpec(
    name="granite-34b", family="lm", model=FULL, smoke=SMOKE, shapes=LM_SHAPES,
    skip={"long_500k": "pure full-attention arch; 500k decode needs "
          "sub-quadratic attention (DESIGN.md Section 5)"},
    rules_override={"kv_heads": None},   # MQA: single kv head replicated
    optimizer="adafactor",
    grad_accum={"train_4k": 2},
))
