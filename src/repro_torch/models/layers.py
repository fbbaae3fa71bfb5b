"""Shared neural building blocks (plain PyTorch, init/apply style).

Conventions, as in the reference package:

* params are nested dicts of tensors; init functions take a
  ``torch.Generator`` and a config;
* compute dtype follows the input (bf16 end to end), with f32 inside
  softmax, normalization and logits;
* every block is shape-polymorphic over batch and sequence, so the same
  code serves prefill and decode.

Attention routes to the port's kernels: ``_attend`` to ``flash_attention``
(the CUDA kernel on a card, the shapes-only route on the meta device;
:class:`FlashAttention`, with the backward kernel, when gradients flow)
and ``attention_decode`` to ``decode_attention``.
``cfg.attention_impl="einsum"`` (or ``"ref"``) asks for the plain versions
of both, on any device; ``"pallas"`` for the kernels' wrappers on any
device, on the CPU too, where they run their plain versions (as the
reference's ``"pallas"`` runs its kernel in interpret mode).

The reference's ``constrain`` calls stand at its places
(``distribution/ctx.py``); they are no-ops outside a sharding context.
Inside one, the sharded steps (``distribution/steps.py``) run each layer on
the rank's shards and the calls do the tensor-parallel collectives:
``tp_in`` before a column-parallel product, ``tp_out`` after a row-parallel
one, ``act_kv`` gathers the sequence of k and v, ``kv_heads`` picks the kv
heads of the rank's q heads; the kernels always take the rank's plain
tensors.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import ctx as shard_ctx
from repro_torch.distribution.ctx import constrain
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import (
    FlashAttention,
    flash_attention,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_chunked,
    attention_ref,
)

Params = Any

_PLAIN = ("einsum", "ref")  # attention_impl values that ask for the plain op


def truncated_normal_init(generator: torch.Generator, shape, dtype,
                          device, scale: float = 0.02) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, in ``dtype``
    (drawn in f32 on ``device`` from ``generator``, which must live
    there)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * scale).to(dtype)


# --------------------------------------------------------------------------- #
# Normalization
# --------------------------------------------------------------------------- #
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rmsnorm_gated(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Mamba2 gated RMSNorm: norm(x * silu(z)) * w."""
    xf = (x * F.silu(z.float()).to(x.dtype)).float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# --------------------------------------------------------------------------- #
# Rotary position embeddings
# --------------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# Attention block (GQA + RoPE)
# --------------------------------------------------------------------------- #
def attention_init(generator, cfg: ModelConfig, dtype, device) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def tn(shape, scale=0.02):
        return truncated_normal_init(generator, shape, dtype, device, scale)

    p = {}
    if cfg.fuse_qkv:
        p["wqkv"] = tn((D, (H + 2 * KV) * hd))
    else:
        p["wq"] = tn((D, H * hd))
        p["wk"] = tn((D, KV * hd))
        p["wv"] = tn((D, KV * hd))
    p["wo"] = tn((H * hd, D), 0.02 / (2 * cfg.num_layers) ** 0.5)
    if cfg.qkv_bias:
        def zeros(n):
            return torch.zeros((n * hd,), dtype=dtype, device=device)
        if cfg.fuse_qkv:
            p["bqkv"] = zeros(H + 2 * KV)
        else:
            p["bq"], p["bk"], p["bv"] = zeros(H), zeros(KV), zeros(KV)
    return p


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = constrain(x, "tp_in")
    if cfg.fuse_qkv:
        qkv = x @ p["wqkv"]
        if cfg.qkv_bias:
            qkv = qkv + p["bqkv"]
        q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
    else:
        q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, H, hd), k.reshape(b, s, KV, hd),
            v.reshape(b, s, KV, hd))


def _attend(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset: int = 0):
    """Full-sequence attention.  On a card (and on the meta device) every
    impl but the plain ones goes through the flash kernel's wrapper, through
    :class:`FlashAttention` (forward and backward kernels) when a gradient
    flows; so does ``"pallas"`` on the CPU, where the wrapper runs its plain
    versions.  Otherwise on the CPU the reference's rule holds (``"auto"``:
    the oracle for short sequences, chunked above 2048^2), differentiated
    by autograd through the plain ops, as the reference differentiates its
    lowerable paths."""
    impl = cfg.attention_impl
    if impl in _PLAIN:
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cpu" or impl == "pallas":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, q_offset,
                                        q.shape[-1] ** -0.5)[0]
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, q_offset=q_offset, impl="auto")
    if impl == "auto":
        if q.shape[1] * k.shape[1] <= 2048 * 2048:
            return attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    return attention_chunked(
        q, k, v, causal=causal, q_offset=q_offset, q_chunk=q.shape[1],
        kv_chunk=8 * min(cfg.attention_kv_chunk, k.shape[1]))


def attention_apply(
    p: Params,
    x: torch.Tensor,  # (b, s, d)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (b, s)
    *,
    causal: bool = True,
    use_rope: bool = True,
    kv_override: "tuple[torch.Tensor, torch.Tensor] | None" = None,
) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if kv_override is not None:
        k, v = kv_override
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if kv_override is None:
            k = rope(k, positions, cfg.rope_theta)
    # Context parallelism: q stays sequence-sharded; k/v are gathered to the
    # whole sequence (the reference's constrain to sequence-replicated).
    q = constrain(q, "act_q")
    k = constrain(k, "act_kv")
    v = constrain(v, "act_kv")
    o = _attend(q, constrain(k, "kv_heads"), constrain(v, "kv_heads"), cfg,
                causal=causal, q_offset=shard_ctx.seq_offset())
    out = o.reshape(b, s, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return constrain(out, "tp_out")


def attention_decode(
    p: Params,
    x: torch.Tensor,  # (b, 1, d) — one new token
    cfg: ModelConfig,
    cache: dict,  # {"k": (b, S, KV, hd), "v": ..., "pos": int}
    *,
    use_rope: bool = True,
) -> tuple[torch.Tensor, dict]:
    """One-token attention against the layer's cache.  The new token's K/V
    row is written at ``pos`` *in place* (the reference's one-hot
    ``where`` rewrites the whole cache); ``pos`` is a host int shared by the
    batch.  Returns ``(out, {"k", "v", "pos": pos + 1})``."""
    b = x.shape[0]
    H, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg)
    pos = int(cache["pos"])
    if use_rope:
        pos2d = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, pos2d, cfg.rope_theta)
        k = rope(k, pos2d, cfg.rope_theta)
    k_cache = constrain(cache["k"], "cache_kv")
    v_cache = constrain(cache["v"], "cache_kv")
    impl = "ref" if cfg.attention_impl in _PLAIN else "auto"
    write = shard_ctx.override("cache_write")
    attend = shard_ctx.override("decode_attention")
    if write is not None:  # the cache's sequence split over ranks
        write(k_cache, k[:, 0], pos)
        write(v_cache, v[:, 0], pos)
    else:
        k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    if attend is not None:
        o = attend(q[:, 0].contiguous(), k_cache, v_cache, pos, impl)
    else:
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
        o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths,
                             impl=impl)
    out = constrain(o.reshape(b, 1, H * hd) @ p["wo"], "tp_out")
    return out, {"k": k_cache, "v": v_cache, "pos": pos + 1}


# --------------------------------------------------------------------------- #
# MLP block (dense)
# --------------------------------------------------------------------------- #
def mlp_init(generator, cfg: ModelConfig, dtype, device) -> Params:
    D, F_ = cfg.d_model, cfg.d_ff
    down_scale = 0.02 / (2 * cfg.num_layers) ** 0.5

    def tn(shape, scale=0.02):
        return truncated_normal_init(generator, shape, dtype, device, scale)

    if cfg.mlp_activation == "swiglu":
        if cfg.fuse_qkv:
            return {"w_gate_up": tn((D, 2 * F_)),
                    "w_down": tn((F_, D), down_scale)}
        return {"w_gate": tn((D, F_)), "w_up": tn((D, F_)),
                "w_down": tn((F_, D), down_scale)}
    return {"w_up": tn((D, F_)), "w_down": tn((F_, D), down_scale)}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = constrain(x, "tp_in")
    if cfg.mlp_activation == "swiglu":
        if "w_gate_up" in p:
            gate, up = torch.chunk(x @ p["w_gate_up"], 2, dim=-1)
        else:
            gate, up = x @ p["w_gate"], x @ p["w_up"]
        h = F.silu(gate.float()).to(x.dtype) * up
    elif cfg.mlp_activation == "sq_relu":
        h = torch.square(torch.relu(x @ p["w_up"]))
    elif cfg.mlp_activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    else:
        raise ValueError(f"unknown activation {cfg.mlp_activation}")
    return constrain(h @ p["w_down"], "tp_out")


# --------------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------------- #
def embed_init(generator, cfg: ModelConfig, dtype, padded_vocab_size: int,
               device) -> Params:
    p = {"embedding": truncated_normal_init(
        generator, (padded_vocab_size, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = truncated_normal_init(
            generator, (cfg.d_model, padded_vocab_size), dtype, device)
    return p


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens.long()]


def unembed_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    fn = shard_ctx.override("unembed")
    if fn is not None:  # tp-sharded vocab or features
        return fn(p, x)
    w = p["lm_head"] if "lm_head" in p else p["embedding"].T
    return (x @ w).float()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Token-mean CE in f32; padded vocab tail columns are masked out."""
    fn = shard_ctx.override("cross_entropy")
    if fn is not None:  # vocab-sharded logits, tokens over ranks
        return fn(logits, targets, mask, vocab_size)
    logits = logits.float()
    if logits.shape[-1] > vocab_size:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < vocab_size, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)
