"""llama3.2-3b [dense] — hf:meta-llama (small llama3)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=128,
    mlp_activation="swiglu", rope_theta=500000.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="llama3.2-3b-smoke",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512,
)
