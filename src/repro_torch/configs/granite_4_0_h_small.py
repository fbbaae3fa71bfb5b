"""granite-4.0-h-small [hybrid_moe] — hf:ibm-granite/granite-4.0-h-small
(``granitemoehybrid``: 36 Mamba2 and 4 NoPE GQA layers, each followed by a
dropless 72-expert top-10 MoE and a shared expert).

``PUBLISHED`` is the published model; ``CONFIG`` one card's share of a
deployment in which 8 cards share each layer (9 of the 72 experts and an
eighth of the tied vocabulary on each) and the 40 layers lie on 4 pipeline
stages: the first stage's 10 layers, ``layer_types[0:10]``.  No width is
cut.  The scan's chunk is 128, not the published 256: the tensor-core scan
routes take chunks of 64 and 128, and the chunking changes the order of
the arithmetic, not the result."""
import dataclasses

from repro_torch.configs.base import HybridMoEConfig

PUBLISHED = HybridMoEConfig(
    name="granite-4.0-h-small", family="hybrid_moe",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=768, vocab_size=100352, head_dim=128,
    mlp_activation="swiglu", num_experts=72, experts_per_token=10,
    capacity_factor=0.0,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_conv_width=4, ssm_chunk=256, tie_embeddings=True,
    layer_types=tuple("attention" if i % 10 == 5 else "mamba"
                      for i in range(40)),
    experts_held=72, shared_d_ff=1536, embedding_multiplier=12.0,
    residual_multiplier=0.22, attention_multiplier=0.0078125,
    logits_scaling=16.0,
)

CONFIG = dataclasses.replace(
    PUBLISHED, name="granite-4.0-h-small-ep8",
    num_layers=10, layer_types=PUBLISHED.layer_types[:10],
    experts_held=9, vocab_size=100352 // 8, ssm_chunk=128,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="granite-4.0-h-small-smoke",
    num_layers=4, layer_types=("mamba", "attention", "mamba", "mamba"),
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32,
    shared_d_ff=48, num_experts=8, experts_per_token=3, experts_held=4,
    vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
)
