"""Model/shape configuration system.

One ``ModelConfig`` covers all assigned families (dense / MoE / SSM / hybrid /
enc-dec / VLM-backbone).  ``ShapeConfig`` defines the four assigned input
shapes.  ``MeshPlan`` records how an architecture maps the production mesh's
``model=16`` axis onto logical ``tp x sp`` sub-axes (see DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "hybrid_moe", "vlm",
                 "audio"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # MLP
    mlp_activation: str = "swiglu"  # swiglu | sq_relu | gelu
    qkv_bias: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    # Hybrid (zamba2-style): one shared attention block applied every k layers
    hybrid_attn_every: int = 0
    # Encoder-decoder
    num_encoder_layers: int = 0
    # Modality frontend stub (vlm/audio): embeddings are precomputed inputs
    frontend: str | None = None  # vit_stub | audio_stub
    frontend_tokens: int = 256
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    scan_layers: bool = True  # homogeneous stacks lower via lax.scan
    attention_impl: str = "auto"  # auto | chunked | pallas | ref | einsum
    attention_kv_chunk: int = 1024
    fuse_qkv: bool = False  # beyond-paper perf: merged QKV / gate-up projections
    dtype: str = "bfloat16"

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic memory path exists (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def num_params(self) -> int:
        """Exact parameter count (used for 6ND model-FLOPs and memory)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, hd = self.num_heads, self.num_kv_heads, self.head_dim
        embed = V * D + (0 if self.tie_embeddings else V * D)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if self.qkv_bias:
            attn += (H + 2 * KV) * hd
        if self.mlp_activation == "swiglu":
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        if self.num_experts:
            mlp_total = self.num_experts * mlp + D * self.num_experts
        else:
            mlp_total = mlp
        norms = 2 * D
        if self.family == "ssm":
            per_layer = self._mamba_block_params() + D
            return embed + self.num_layers * per_layer + D
        if self.family == "hybrid":
            ssm_layers = self.num_layers * (self._mamba_block_params() + D)
            n_attn_applications = self.num_layers // max(self.hybrid_attn_every, 1)
            shared_attn = attn + mlp_total + norms  # ONE shared block (reused)
            return embed + ssm_layers + shared_attn + D
        per_layer = attn + mlp_total + norms
        total = embed + self.num_layers * per_layer + D
        if self.num_encoder_layers:
            enc_attn = attn  # encoder self-attention
            total += self.num_encoder_layers * (enc_attn + mlp_total + norms) + D
            total += self.num_layers * (attn + D)  # decoder cross-attn + its norm
        return total

    def _mamba_block_params(self) -> int:
        D, di = self.d_model, self.d_inner
        g, n, h = self.ssm_groups, self.ssm_state, self.ssm_heads
        conv_dim = di + 2 * g * n
        in_proj = D * (2 * di + 2 * g * n + h)  # split z/x/BC/dt, same total
        conv = conv_dim * self.ssm_conv_width + conv_dim
        extra = h * 3  # A_log, dt_bias, D skip
        out_proj = di * D + di  # + gated-norm weight
        return in_proj + conv + extra + out_proj

    def active_params(self) -> int:
        """Active parameters per token (MoE uses topk/E of expert weights)."""
        if not self.num_experts:
            return self.num_params()
        D, F = self.d_model, self.d_ff
        mlp = (3 if self.mlp_activation == "swiglu" else 2) * D * F
        inactive = (self.num_experts - self.experts_per_token) * mlp
        return self.num_params() - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """The ``hybrid_moe`` family (``granitemoehybrid``): each layer is a
    Mamba2 or an attention mixer, as ``layer_types`` says, followed by a
    dropless MoE and a shared SwiGLU expert.

    ``num_experts`` is the router's width and ``experts_per_token`` its
    top-k; this card holds the first ``experts_held`` of them (``d_ff``
    wide) and computes only the pairs routed there (an expert-parallel
    deployment's share).  The routing is dropless: no capacity
    (``capacity_factor`` is unused).  The attention has no positional
    embedding (NoPE) and takes ``attention_multiplier`` as its softmax
    scale; the embedding is scaled by ``embedding_multiplier``, each
    mixer's and FFN's output by ``residual_multiplier`` before the
    residual add, and the logits divided by ``logits_scaling``."""

    layer_types: tuple[str, ...] = ()  # "mamba" | "attention" per layer
    experts_held: int = 0
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        if len(self.layer_types) != self.num_layers or not set(
                self.layer_types) <= {"mamba", "attention"}:
            raise ValueError(f"{self.name}: layer_types must name mamba or "
                             f"attention for each of {self.num_layers} layers")
        if not 1 <= self.experts_held <= self.num_experts:
            raise ValueError(f"{self.name}: {self.experts_held} experts held "
                             f"of the router's {self.num_experts}")

    def _layer_counts(self) -> tuple[int, int]:
        mamba = sum(t == "mamba" for t in self.layer_types)
        return mamba, self.num_layers - mamba

    def _ffn_params(self, experts: int) -> int:
        D = self.d_model
        return (D * self.num_experts + experts * 3 * D * self.d_ff
                + 3 * D * self.shared_d_ff + D)  # router, experts, shared, norm

    def num_params(self) -> int:
        """Parameters held here: the held experts, every mixer, the shared
        experts and the tied embedding of the (sliced) vocabulary."""
        D, H, KV, hd = self.d_model, self.num_heads, self.num_kv_heads, \
            self.head_dim
        mamba, attn = self._layer_counts()
        attn_p = D + D * (H + 2 * KV) * hd + H * hd * D
        return (self.vocab_size * D + D
                + mamba * (self._mamba_block_params() + D) + attn * attn_p
                + self.num_layers * self._ffn_params(self.experts_held))

    def active_params(self) -> int:
        """Parameters a token uses: ``experts_per_token`` experts a layer
        in place of the held ones."""
        return self.num_params() - self.num_layers * (
            self._ffn_params(self.experts_held)
            - self._ffn_params(self.experts_per_token))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]
    microbatches: int = 1  # gradient-accumulation steps (train only)


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", microbatches=8),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Logical factoring of the production mesh for one architecture.

    The physical mesh is always ``(pod?, data=16, model=16)``.  ``tp * sp``
    must equal the model-axis size; ``tp`` shards heads / d_ff / experts /
    vocab, ``sp`` shards the sequence (context parallelism).  ``kv_dup`` is
    the Megatron-style KV-head duplication factor when ``tp > num_kv_heads``.
    """

    tp: int
    sp: int
    kv_dup: int = 1
    fsdp: bool = True  # shard params+opt state over the data axis for training

    def __post_init__(self):
        if self.tp * self.sp <= 0:
            raise ValueError("tp and sp must be positive")


def choose_mesh_plan(cfg: ModelConfig, model_axis: int = 16) -> MeshPlan:
    """Pick the largest tp | model_axis compatible with the head counts."""
    if cfg.family == "ssm":
        h = cfg.ssm_heads
        for tp in _descending_divisors(model_axis):
            if h % tp == 0:
                return MeshPlan(tp=tp, sp=model_axis // tp)
        return MeshPlan(tp=1, sp=model_axis)
    H, KV = cfg.num_heads, cfg.num_kv_heads
    for tp in _descending_divisors(model_axis):
        if H % tp != 0:
            continue
        if KV % tp == 0:
            return MeshPlan(tp=tp, sp=model_axis // tp, kv_dup=1)
        if tp % KV == 0:
            return MeshPlan(tp=tp, sp=model_axis // tp, kv_dup=tp // KV)
    raise ValueError(f"no valid tp factoring for {cfg.name} (H={H}, KV={KV})")


def _descending_divisors(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def padded_vocab(vocab_size: int, multiple: int = 2048) -> int:
    """Pad vocab so each tp shard is lane-aligned (multiple = tp*128)."""
    return int(math.ceil(vocab_size / multiple) * multiple)
