"""phi3-medium-14b [dense] — arXiv:2404.14219 (RoPE SwiGLU GQA)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=100352, head_dim=128,
    mlp_activation="swiglu",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="phi3-medium-14b-smoke",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
)
