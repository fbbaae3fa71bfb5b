"""Zamba2-style hybrid model: Mamba2 backbone + one *shared* attention block.

Zamba2's signature trick is parameter sharing: a single global
attention+MLP transformer block is applied every ``hybrid_attn_every`` Mamba2
layers, reusing the same weights at each application (activations — and hence
KV caches — differ per application).  As in the reference, the
concatenation-with-embedding input of the original is simplified to a
residual application.

The shared block is the port's transformer layer (``transformer.layer_init``
/ ``layer_apply`` / ``layer_decode``): its prefill attention goes to the
``flash_attention`` kernel and its decode attention to ``decode_attention``
on a card.  The cache is ``{"mamba": [per-layer Mamba2 caches], "attn":
[{"k", "v", "pos": host int} per application]}``; decode writes each
application's K/V row in place.

``loss_fn`` trains through both kernels' backwards (``SsdScan`` in every
Mamba2 block, ``FlashAttention`` in each application of the shared block);
the shared weights collect their gradient from every application.  Under
``remat`` each Mamba2 block and each application is checkpointed on its
own, as the reference wraps each in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.device import resolve_device
from repro_torch.distribution import ctx as shard_ctx
from repro_torch.distribution.ctx import constrain
from repro_torch.models import mamba2 as m2
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    _attend,
    _project_qkv,
    cross_entropy,
    embed_apply,
    embed_init,
    mlp_apply,
    rmsnorm,
    rope,
    unembed_apply,
)

Params = Any


def _attn_positions(cfg: ModelConfig) -> list[int]:
    k = cfg.hybrid_attn_every
    return [i for i in range(cfg.num_layers) if i % k == 0] if k else []


def init(generator, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random params from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed): the reference's recipe, not its bits."""
    dev = resolve_device(device)
    gen = tfm._generator(generator, dev)
    dt = tfm.dtype_of(cfg)
    return {
        "embed": embed_init(gen, cfg, dt, padded_vocab(cfg.vocab_size), dev),
        "mamba_layers": [m2.block_init(gen, cfg, dev)
                         for _ in range(cfg.num_layers)],
        "shared_attn": tfm.layer_init(gen, cfg, dev),  # ONE block, reused
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
          remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, padded_vocab) f32, aux_loss = 0)."""
    x = constrain(embed_apply(params["embed"], tokens), "act_btd")
    positions = _positions(x)
    attn_at = set(_attn_positions(cfg))
    mb = m2.rematerialized(m2.block_apply, remat)
    ab = m2.rematerialized(tfm.layer_apply, remat)
    for i, lp in enumerate(params["mamba_layers"]):
        if i in attn_at:
            x, _ = ab(params["shared_attn"], x, cfg, positions)
        x = mb(lp, x, cfg, impl=m2.scan_impl(cfg))
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (unembed_apply(params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Token-mean cross-entropy of ``batch["targets"]`` under
    ``batch["mask"]`` over the padded vocabulary; returns ``(loss,
    {"ce"})``."""
    logits, _ = apply(params, batch["tokens"], cfg, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["mask"],
                       cfg.vocab_size)
    return ce, {"ce": ce}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    dev = resolve_device(device)
    dt = tfm.dtype_of(cfg)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "mamba": m2.init_cache(cfg, batch, device=dev),
        "attn": [{"k": torch.zeros(shape, dtype=dt, device=dev),
                  "v": torch.zeros(shape, dtype=dt, device=dev),
                  "pos": 0}
                 for _ in _attn_positions(cfg)],
    }


def attention_prefill(sp: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, max_len: int
                      ) -> tuple[torch.Tensor, dict]:
    """One application of the shared block over a prompt: returns (x, its
    KV cache ``{"k", "v"}`` of ``max_len`` rows (the rank's block of them
    where the cache's sequence is split over ranks), ``"pos"``: prompt
    length)."""
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit max_len "
                         f"{max_len}")
    hn = rmsnorm(x, sp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(sp["attn"], hn, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attend(q, constrain(k, "kv_heads"), constrain(v, "kv_heads"), cfg,
                causal=True)
    x = x + constrain(o.reshape(b, s, -1) @ sp["attn"]["wo"], "tp_out")
    hn = rmsnorm(x, sp["ln2"], cfg.norm_eps)
    x = x + mlp_apply(sp["mlp"], hn, cfg)
    dt = tfm.dtype_of(cfg)
    rows = shard_ctx.override("cache_rows")
    shape = (b, rows(max_len) if rows else max_len, cfg.num_kv_heads,
             cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dt, device=x.device),
             "v": torch.zeros(shape, dtype=dt, device=x.device), "pos": s}
    fill = shard_ctx.override("cache_fill")
    if fill is not None:
        fill(cache["k"], k)
        fill(cache["v"], v)
    else:
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    return x, cache


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int) -> tuple[torch.Tensor, dict]:
    """Returns (last-position logits (b, padded_vocab), cache)."""
    x = constrain(embed_apply(params["embed"], tokens), "act_btd")
    positions = _positions(x)
    attn_at = set(_attn_positions(cfg))
    caches = {"mamba": [], "attn": []}
    for i, lp in enumerate(params["mamba_layers"]):
        if i in attn_at:
            x, ac = attention_prefill(params["shared_attn"], x, cfg,
                                      positions, max_len)
            caches["attn"].append(ac)
        x, mc = m2.block_prefill(lp, x, cfg)
        caches["mamba"].append(mc)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed_apply(params["embed"], x[:, -1]), caches


def decode_step(params: Params, token: torch.Tensor, cfg: ModelConfig,
                caches: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode: returns (logits (b, padded_vocab), cache); each
    application's K/V row is written in place."""
    x = constrain(embed_apply(params["embed"], token[:, None]), "act_btd")
    attn_at = _attn_positions(cfg)
    cache_len = shard_ctx.override("cache_len")
    new = {"mamba": [], "attn": []}
    ai = 0
    for i, lp in enumerate(params["mamba_layers"]):
        if i in attn_at:
            cache = caches["attn"][ai]
            max_len = cache_len() if cache_len else cache["k"].shape[1]
            if int(cache["pos"]) >= max_len:
                raise ValueError(f"cache of {max_len} positions is full")
            x, c = tfm.layer_decode(params["shared_attn"], x, cfg, cache)
            new["attn"].append(c)
            ai += 1
        x, mc = m2.block_decode(lp, x, cfg, caches["mamba"][i])
        new["mamba"].append(mc)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed_apply(params["embed"], x[:, 0]), new


# --------------------------------------------------------------------------- #
# Params to and from the reference package (through numpy)
# --------------------------------------------------------------------------- #
def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Params:
    """The reference package's params (nested dicts and lists of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, params)``) as the port's tensors
    on ``device``.  The reference keeps the Mamba2 layers as a list
    whatever ``cfg.scan_layers`` says, so nothing is unstacked."""
    dev = resolve_device(device)
    return tfm._tree_map(lambda a: tfm._to_tensor(a, dev), tree)


def params_to_numpy(params: Params, cfg: ModelConfig) -> dict:
    """Host numpy copy of the port's params in the reference layout (bf16
    widened to f32)."""
    return tfm._tree_map(tfm._to_numpy, params)
