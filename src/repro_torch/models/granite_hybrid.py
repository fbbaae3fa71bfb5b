"""Granite 4.0-H (``granitemoehybrid``): Mamba2 and NoPE GQA mixers, each
followed by a dropless MoE plus a shared SwiGLU expert (the ``hybrid_moe``
family, :class:`~repro_torch.configs.base.HybridMoEConfig`).

The layer equations, as in the upstream model::

    x = E[tok] * embedding_multiplier
    x = x + residual_multiplier * mixer(x)    # Mamba2 (norm to out_proj) or
                                              # rmsnorm, attention
    h = rmsnorm(x)
    x = x + residual_multiplier * (moe(h) + shared(h))
    logits = rmsnorm(x) E^T / logits_scaling  # tied embedding

The Mamba2 mixer is ``models/mamba2.py``'s (its scan and conv kernels on a
card); the attention is GQA with no positional embedding and softmax scale
``attention_multiplier`` through the flash kernels (the decode kernel when
serving); the MoE is ``models/moe.py``'s dropless route over the experts
this card holds, and the shared expert the port's SwiGLU MLP.  The params
are ``{"embed": {"embedding"}, "ln_f", "layers": [...]}``, a Mamba2 layer
``{"mamba", "ln2", "moe", "shared"}`` and an attention layer ``{"ln1",
"attn", "ln2", "moe", "shared"}``.  The serving cache holds one entry per
layer: a Mamba2 layer's ``{"conv_x", "conv_BC", "ssm"}``, an attention
layer's ``{"k", "v", "pos"}`` (decode writes its K/V row in place).

Under a profiler each layer is a ``model.block`` span (a recomputation
included) and its FFN half a ``model.moe`` span inside it
(``runtime/tracing.py``).  With ``remat`` each layer is checkpointed.
Only the one-card path exists: the sharded steps refuse this family.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import HybridMoEConfig, padded_vocab
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    _PLAIN,
    _attend,
    _project_qkv,
    attention_decode,
    attention_init,
    cross_entropy,
    embed_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
)
from repro_torch.models.moe import dropless_apply, dropless_init
from repro_torch.runtime import tracing

Params = Any


def _shared_cfg(cfg: HybridMoEConfig) -> HybridMoEConfig:
    return dataclasses.replace(cfg, d_ff=cfg.shared_d_ff)


def layer_init(generator, cfg: HybridMoEConfig, kind: str, device) -> Params:
    dt = tfm.dtype_of(cfg)
    if kind == "mamba":
        p = {"mamba": m2.block_init(generator, cfg, device)}
    else:
        p = {"ln1": torch.ones((cfg.d_model,), dtype=dt, device=device),
             "attn": attention_init(generator, cfg, dt, device)}
    p["ln2"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    p["moe"] = dropless_init(generator, cfg, dt, device)
    p["shared"] = mlp_init(generator, _shared_cfg(cfg), dt, device)
    return p


def init(generator, cfg: HybridMoEConfig, *, device="cuda") -> Params:
    """Random params from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed)."""
    dev = resolve_device(device)
    gen = tfm._generator(generator, dev)
    dt = tfm.dtype_of(cfg)
    return {
        "embed": embed_init(gen, cfg, dt, padded_vocab(cfg.vocab_size), dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": [layer_init(gen, cfg, kind, dev)
                   for kind in cfg.layer_types],
    }


def _impl(cfg: HybridMoEConfig) -> str:
    """The expert products' route: the plain one when the config asks for
    plain ops."""
    return "plain" if cfg.attention_impl in _PLAIN else "auto"


def _scale(cfg: HybridMoEConfig) -> "float | None":
    return cfg.attention_multiplier or None


@tracing.spanned("model.moe")
def ffn_apply(p: Params, x: torch.Tensor, cfg: HybridMoEConfig
              ) -> torch.Tensor:
    """The layer's FFN half: what it adds to ``x``, before the residual
    multiplier."""
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return (dropless_apply(p["moe"], h, cfg, impl=_impl(cfg))
            + mlp_apply(p["shared"], h, _shared_cfg(cfg)))


def _attention(p: Params, x: torch.Tensor, cfg: HybridMoEConfig
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention mixer over a whole sequence: (out, k, v)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                           cfg)
    o = _attend(q, k, v, cfg, causal=True, scale=_scale(cfg))
    return o.reshape(b, s, -1) @ p["attn"]["wo"], k, v


def _residual(x: torch.Tensor, out: torch.Tensor, cfg: HybridMoEConfig):
    return x + out * cfg.residual_multiplier


@tracing.spanned("model.block")
def layer_apply(p: Params, x: torch.Tensor, cfg: HybridMoEConfig
                ) -> torch.Tensor:
    if "mamba" in p:
        out = m2.mixer_apply(p["mamba"], x, cfg, impl=m2.scan_impl(cfg))
    else:
        out = _attention(p, x, cfg)[0]
    x = _residual(x, out, cfg)
    return _residual(x, ffn_apply(p, x, cfg), cfg)


class _Lookup(torch.autograd.Function):
    """The embedding's rows of ``tokens``.  The backward sums each row's
    gradient over its tokens in f32 and rounds once: summed in the table's
    bf16, a frequent token's thousands of terms in a large microbatch
    would be rounded away."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table_shape = table.shape
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        acc = torch.zeros(ctx.table_shape, dtype=torch.float32,
                          device=g.device)
        acc.index_put_((tokens.reshape(-1),),
                       g.reshape(-1, g.shape[-1]).float(), accumulate=True)
        return acc.to(g.dtype), None


def _embed(params: Params, tokens: torch.Tensor, cfg: HybridMoEConfig):
    return _Lookup.apply(params["embed"]["embedding"], tokens.long()) \
        * cfg.embedding_multiplier


def _logits(params: Params, x: torch.Tensor, cfg: HybridMoEConfig):
    """f32 logits (..., padded_vocab) of the final hidden states."""
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (x @ params["embed"]["embedding"].T).float() / cfg.logits_scaling


def apply(params: Params, tokens: torch.Tensor, cfg: HybridMoEConfig, *,
          remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, padded_vocab) f32, aux_loss = 0)."""
    x = _embed(params, tokens, cfg)
    layer = m2.rematerialized(layer_apply, remat)
    for lp in params["layers"]:
        x = layer(lp, x, cfg)
    return (_logits(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params: Params, batch: dict, cfg: HybridMoEConfig, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Token-mean cross-entropy of ``batch["targets"]`` under
    ``batch["mask"]`` over the vocabulary (its pad columns masked); no
    load-balancing term.  Returns ``(loss, {"ce"})``."""
    logits, _ = apply(params, batch["tokens"], cfg, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["mask"],
                       cfg.vocab_size)
    return ce, {"ce": ce}


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: HybridMoEConfig, batch: int, max_len: int, *,
               device="cuda") -> list:
    dev = resolve_device(device)
    dt = tfm.dtype_of(cfg)
    mamba = iter(m2.init_cache(cfg, batch, device=dev))
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return [next(mamba) if kind == "mamba" else
            {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev), "pos": 0}
            for kind in cfg.layer_types]


@tracing.spanned("model.block")
def layer_prefill(p: Params, x: torch.Tensor, cfg: HybridMoEConfig,
                  max_len: int) -> tuple[torch.Tensor, dict]:
    if "mamba" in p:
        out, cache = m2.mixer_prefill(p["mamba"], x, cfg,
                                      impl=m2.scan_impl(cfg))
    else:
        b, s, _ = x.shape
        out, k, v = _attention(p, x, cfg)
        shape = (b, max_len, cfg.num_kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=k.dtype, device=x.device),
                 "v": torch.zeros(shape, dtype=v.dtype, device=x.device),
                 "pos": s}
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    x = _residual(x, out, cfg)
    return _residual(x, ffn_apply(p, x, cfg), cfg), cache


def prefill(params: Params, tokens: torch.Tensor, cfg: HybridMoEConfig,
            max_len: int) -> tuple[torch.Tensor, list]:
    """Returns (last-position logits (b, padded_vocab), per-layer
    caches)."""
    if tokens.shape[1] > max_len:
        raise ValueError(f"prompt of {tokens.shape[1]} tokens does not fit "
                         f"max_len {max_len}")
    x = _embed(params, tokens, cfg)
    caches = []
    for lp in params["layers"]:
        x, c = layer_prefill(lp, x, cfg, max_len)
        caches.append(c)
    return _logits(params, x[:, -1], cfg), caches


@tracing.spanned("model.block")
def layer_decode(p: Params, x: torch.Tensor, cfg: HybridMoEConfig,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    if "mamba" in p:
        out, cache = m2.mixer_decode(p["mamba"], x, cfg, cache)
    else:
        if int(cache["pos"]) >= cache["k"].shape[1]:
            raise ValueError(f"cache of {cache['k'].shape[1]} positions is "
                             f"full")
        out, cache = attention_decode(
            p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, cache,
            use_rope=False, scale=_scale(cfg))
    x = _residual(x, out, cfg)
    return _residual(x, ffn_apply(p, x, cfg), cfg), cache


def decode_step(params: Params, token: torch.Tensor, cfg: HybridMoEConfig,
                caches: list) -> tuple[torch.Tensor, list]:
    """One-token decode: returns (logits (b, padded_vocab), caches)."""
    x = _embed(params, token[:, None], cfg)
    new = []
    for lp, cache in zip(params["layers"], caches):
        x, c = layer_decode(lp, x, cfg, cache)
        new.append(c)
    return _logits(params, x[:, 0], cfg), new
