"""qwen2-7b [dense] — arXiv:2407.10671 (GQA, QKV bias)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    mlp_activation="swiglu", qkv_bias=True,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="qwen2-7b-smoke",
    num_layers=2, d_model=112, num_heads=7, num_kv_heads=1, head_dim=16,
    d_ff=224, vocab_size=512,
)
