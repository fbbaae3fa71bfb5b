"""zamba2-1.2b [hybrid] — arXiv:2411.15242 (Mamba2 + shared attn blocks)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    mlp_activation="swiglu",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    hybrid_attn_every=6, scan_layers=False,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="zamba2-1.2b-smoke",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, ssm_state=16, ssm_head_dim=16,
    hybrid_attn_every=2, ssm_chunk=16,
)
