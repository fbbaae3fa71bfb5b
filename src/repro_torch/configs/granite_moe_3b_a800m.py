"""granite-moe-3b-a800m [moe] — hf:ibm-granite (40 experts top-8)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, head_dim=64,
    mlp_activation="swiglu", num_experts=40, experts_per_token=8,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="granite-moe-3b-a800m-smoke",
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=512, num_experts=4, experts_per_token=2,
)
