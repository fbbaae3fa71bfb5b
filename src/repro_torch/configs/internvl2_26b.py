"""internvl2-26b [vlm] — arXiv:2404.16821 (InternViT frontend stub + InternLM2).

The InternViT vision tower is a STUB per the assignment: ``input_specs()``
provides precomputed patch embeddings already projected to d_model.
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92553, head_dim=128,
    mlp_activation="swiglu",
    frontend="vit_stub", frontend_tokens=256,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="internvl2-26b-smoke",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512, frontend_tokens=8,
)
