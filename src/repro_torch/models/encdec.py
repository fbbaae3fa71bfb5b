"""Encoder-decoder transformer (seamless-m4t-medium backbone).

The speech/text frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``(b, s_src, d)``.  Decoder layers add
cross-attention against the encoder memory; serving computes the cross K/V
once at prefill (the standard enc-dec serving layout).

Attention goes to the port's kernels on a card: the encoder (bidirectional),
the decoder's causal self-attention and its cross-attention (``sq != sk``)
to ``flash_attention`` through ``layers._attend``; decode's self-attention
to ``decode_attention`` through ``layers.attention_decode``, and its
cross-attention to ``decode_attention`` with every length equal to the
number of source frames (the reference calls the plain version there, the
same function).

Layers are Python lists of per-layer param dicts (:func:`params_from_numpy`
unstacks the reference's scanned layers).  The cache follows the port's
transformer: stacked ``(num_layers, b, max_len, kv, hd)`` K/V written in
place at a host int ``pos``, plus stacked ``(num_layers, b, s_src, kv, hd)``
cross K/V (``xk``/``xv``).  ``loss_fn`` is the teacher-forced
cross-entropy; with ``remat`` every encoder and decoder layer is
checkpointed (``torch.utils.checkpoint``, non-reentrant), as the reference
wraps them in ``jax.checkpoint``.  Its attention is non-causal in the
encoder and, with ``sq != sk``, in the cross-attention, so training runs
the flash backward off the causal path too.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (
    _PLAIN,
    _attend,
    _project_qkv,
    attention_decode,
    attention_init,
    cross_entropy,
    embed_apply,
    embed_init,
    mlp_apply,
    rmsnorm,
    rope,
    unembed_apply,
)

Params = Any


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def init(generator, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random params from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed): the reference's recipe, not its bits."""
    dev = resolve_device(device)
    gen = tfm._generator(generator, dev)
    dt = tfm.dtype_of(cfg)
    # Cross-attention has self-attention's projections, never fused: its
    # K/V come from the encoder memory at another time.
    xcfg = dataclasses.replace(cfg, fuse_qkv=False, qkv_bias=False)

    def dec_layer():
        p = tfm.layer_init(gen, cfg, dev)
        p["ln_x"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
        p["cross"] = attention_init(gen, xcfg, dt, dev)
        return p

    return {
        "embed": embed_init(gen, cfg, dt, padded_vocab(cfg.vocab_size), dev),
        "ln_enc": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "encoder": [tfm.layer_init(gen, cfg, dev)
                    for _ in range(cfg.num_encoder_layers)],
        "decoder": [dec_layer() for _ in range(cfg.num_layers)],
    }


def _enc_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    hn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(lp["attn"], hn, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attend(q, k, v, cfg, causal=False)  # bidirectional
    x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
    return x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)


def encode(params: Params, src_embeds: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False) -> torch.Tensor:
    """src_embeds: (b, s_src, d) precomputed frontend embeddings."""
    x = src_embeds.to(tfm.dtype_of(cfg))
    positions = _positions(x)
    for lp in params["encoder"]:
        if remat:
            x = checkpoint(_enc_layer, lp, x, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _enc_layer(lp, x, cfg, positions)
    return rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _cross_kv(lp: Params, memory: torch.Tensor, cfg: ModelConfig):
    b, s_src, _ = memory.shape
    shape = (b, s_src, cfg.num_kv_heads, cfg.head_dim)
    return ((memory @ lp["cross"]["wk"]).reshape(shape),
            (memory @ lp["cross"]["wv"]).reshape(shape))


def _dec_layer(lp: Params, x: torch.Tensor, memory: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor):
    """One decoder layer over the whole sequence; returns (x, k, v, mk, mv)
    with the self-attention K/V and the cross K/V for the cache."""
    b, s, _ = x.shape
    hn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(lp["attn"], hn, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = _attend(q, k, v, cfg, causal=True)
    x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
    # Cross-attention: no RoPE, the whole memory.
    hn = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
    qc = (hn @ lp["cross"]["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    mk, mv = _cross_kv(lp, memory, cfg)
    oc = _attend(qc, mk, mv, cfg, causal=False)
    x = x + oc.reshape(b, s, -1) @ lp["cross"]["wo"]
    x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x, k, v, mk, mv


def _dec_layer_x(lp: Params, x: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    return _dec_layer(lp, x, memory, cfg, positions)[0]


def decode_train(params: Params, tokens: torch.Tensor, memory: torch.Tensor,
                 cfg: ModelConfig, *, remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder forward: logits (b, s, padded_vocab) f32."""
    x = embed_apply(params["embed"], tokens)
    positions = _positions(x)
    for lp in params["decoder"]:
        if remat:
            x = checkpoint(_dec_layer_x, lp, x, memory, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _dec_layer_x(lp, x, memory, cfg, positions)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed_apply(params["embed"], x)


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Cross-entropy of the decoder's teacher-forced logits against
    ``batch["targets"]`` under ``batch["mask"]``, the source frames
    ``batch["src_embeds"]`` encoded first; returns ``(ce, {"ce"})``."""
    memory = encode(params, batch["src_embeds"], cfg, remat=remat)
    logits = decode_train(params, batch["tokens"], memory, cfg, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["mask"],
                       cfg.vocab_size)
    return ce, {"ce": ce}


# --------------------------------------------------------------------------- #
# Serving: cross K/V computed at prefill, self K/V cached per decoder layer
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int, *,
               device="cuda") -> dict:
    dev = resolve_device(device)
    dt = tfm.dtype_of(cfg)
    head = (cfg.num_kv_heads, cfg.head_dim)
    self_shape = (cfg.num_layers, batch, max_len) + head
    cross_shape = (cfg.num_layers, batch, src_len) + head
    return {"k": torch.zeros(self_shape, dtype=dt, device=dev),
            "v": torch.zeros(self_shape, dtype=dt, device=dev),
            "pos": 0,
            "xk": torch.zeros(cross_shape, dtype=dt, device=dev),
            "xv": torch.zeros(cross_shape, dtype=dt, device=dev)}


def prefill(params: Params, src_embeds: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, max_len: int) -> tuple[torch.Tensor, dict]:
    """Encode the source, run the decoder prompt, fill every cache.

    Returns (last-position logits (b, padded_vocab), cache).
    """
    memory = encode(params, src_embeds, cfg)
    x = embed_apply(params["embed"], tokens)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit max_len "
                         f"{max_len}")
    positions = _positions(x)
    cache = init_cache(cfg, b, max_len, memory.shape[1], device=x.device)
    for i, lp in enumerate(params["decoder"]):
        x, k, v, mk, mv = _dec_layer(lp, x, memory, cfg, positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["xk"][i] = mk
        cache["xv"][i] = mv
    cache["pos"] = s
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed_apply(params["embed"], x[:, -1]), cache


def decode_step(params: Params, token: torch.Tensor, cfg: ModelConfig,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode: returns (logits (b, padded_vocab), cache).  Writes
    the token's self K/V into ``cache`` in place; the returned cache shares
    its tensors and carries ``pos + 1``."""
    pos = int(cache["pos"])
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"cache of {cache['k'].shape[2]} positions is full")
    x = embed_apply(params["embed"], token[:, None])
    b = x.shape[0]
    s_src = cache["xk"].shape[2]
    lengths = torch.full((b,), s_src, dtype=torch.int32, device=x.device)
    impl = "ref" if cfg.attention_impl in _PLAIN else "auto"
    for i, lp in enumerate(params["decoder"]):
        h, _ = attention_decode(
            lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), cfg,
            {"k": cache["k"][i], "v": cache["v"][i], "pos": pos})
        x = x + h
        hn = rmsnorm(x, lp["ln_x"], cfg.norm_eps)
        qc = (hn @ lp["cross"]["wq"]).reshape(b, cfg.num_heads, cfg.head_dim)
        oc = decode_attention(qc.contiguous(), cache["xk"][i],
                              cache["xv"][i], lengths, impl=impl)
        x = x + oc.reshape(b, 1, -1) @ lp["cross"]["wo"]
        x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (unembed_apply(params["embed"], x[:, 0]),
            dict(cache, pos=pos + 1))


# --------------------------------------------------------------------------- #
# Params to and from the reference package (through numpy)
# --------------------------------------------------------------------------- #
_STACKS = ("encoder", "decoder")


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Params:
    """The reference package's params (nested dicts of numpy arrays) as the
    port's tensors on ``device``; with ``cfg.scan_layers`` the encoder and
    decoder stacks are unstacked into per-layer lists."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in _STACKS and cfg.scan_layers:
            n = (cfg.num_encoder_layers if k == "encoder"
                 else cfg.num_layers)
            v = [tfm._tree_map(lambda a, i=i: np.asarray(a)[i], v)
                 for i in range(n)]
        out[k] = tfm._tree_map(lambda a: tfm._to_tensor(a, dev), v)
    return out


def params_to_numpy(params: Params, cfg: ModelConfig) -> dict:
    """Host numpy copy in the reference layout (stacks restacked when
    ``cfg.scan_layers``; bf16 widened to f32)."""
    out = {}
    for k, v in params.items():
        v = tfm._tree_map(tfm._to_numpy, v)
        if k in _STACKS and cfg.scan_layers:
            v = tfm._stack(v)
        out[k] = v
    return out
