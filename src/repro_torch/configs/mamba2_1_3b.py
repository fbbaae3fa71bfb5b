"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD, attention-free)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=0,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="mamba2-1.3b-smoke",
    num_layers=3, d_model=64, vocab_size=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
)
