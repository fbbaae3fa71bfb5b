"""seamless-m4t-medium [audio] — arXiv:2308.11596 (enc-dec, frontend stub).

Backbone only: 12 encoder + 12 decoder layers at the listed width; the speech
frontend is a STUB (``input_specs()`` provides precomputed frame embeddings).
"""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    mlp_activation="gelu", num_encoder_layers=12,
    frontend="audio_stub",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="seamless-m4t-medium-smoke",
    num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
)
