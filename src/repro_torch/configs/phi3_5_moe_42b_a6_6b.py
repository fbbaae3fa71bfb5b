"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE (16 experts top-2)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=6400, vocab_size=32064, head_dim=128,
    mlp_activation="swiglu", num_experts=16, experts_per_token=2,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="phi3.5-moe-42b-a6.6b-smoke",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=512, num_experts=4, experts_per_token=2,
)
