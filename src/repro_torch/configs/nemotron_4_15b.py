"""nemotron-4-15b [dense] — arXiv:2402.16819 (GQA, squared-ReLU)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000, head_dim=128,
    mlp_activation="sq_relu",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="nemotron-4-15b-smoke",
    num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
    d_ff=256, vocab_size=512,
)
