"""Decoder-only transformer LM (the dense, MoE and VLM-backbone families).

init/apply in the reference's style, with the layers as a Python list of
per-layer param dicts (the reference stacks them for ``lax.scan``;
:func:`params_from_numpy` unstacks its params).  The same layer code serves
full-sequence forward, prefill and cached decode.  The serving cache is one
stacked ``(num_layers, b, max_len, kv, hd)`` tensor per K and V plus a host
int ``pos``; decode writes into it in place.

A layer of an MoE config carries ``p["moe"]`` (``models/moe.py``) in place
of ``p["mlp"]``; ``apply`` returns the summed Switch auxiliary loss.
``loss_fn`` is the training loss (token-mean cross-entropy plus the
weighted auxiliary loss); with ``remat`` each layer is checkpointed
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps
``layer_apply`` in ``jax.checkpoint``: the backward reruns each layer's
forward, flash kernel included.  The layers draw no random numbers, so
the checkpoint does not stash and restore the RNG state
(``preserve_rng_state=False``): the recompute runs the same aten ops on
every device, and an analyzer counts the same step on each.
``torch.utils.checkpoint`` does not run under ``torch.func`` transforms,
so callers there pass ``remat=False`` (the same numbers).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.device import resolve_device
from repro_torch.distribution import ctx as shard_ctx
from repro_torch.distribution.ctx import constrain
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (
    _attend,
    _project_qkv,
    attention_apply,
    attention_decode,
    attention_init,
    cross_entropy,
    embed_apply,
    embed_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rope,
    unembed_apply,
)

Params = Any


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _generator(generator, device: torch.device) -> "torch.Generator | None":
    if device.type == "meta":  # shapes only: nothing is drawn
        return None
    if isinstance(generator, torch.Generator):
        if generator.device.type != device.type:
            raise ValueError(f"generator lives on {generator.device}, the "
                             f"params on {device}")
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def layer_init(generator, cfg: ModelConfig, device) -> Params:
    dt = dtype_of(cfg)
    p = {
        "ln1": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "attn": attention_init(generator, cfg, dt, device),
        "ln2": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.num_experts:
        p["moe"] = moe_lib.moe_init(generator, cfg, dt, device)
    else:
        p["mlp"] = mlp_init(generator, cfg, dt, device)
    return p


def ffn_apply(p: Params, hn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's MLP or MoE block with its auxiliary loss dropped (the
    serving paths; ``layer_apply`` keeps it)."""
    if cfg.num_experts:
        impl = shard_ctx.moe_impl() or moe_lib.moe_apply
        return impl(p["moe"], hn, cfg)[0]
    return mlp_apply(p["mlp"], hn, cfg)


def init(generator, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random params from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed): the reference's truncated-normal recipe,
    not its bits (torch cannot replay ``jax.random``)."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    dt = dtype_of(cfg)
    return {
        "embed": embed_init(gen, cfg, dt, padded_vocab(cfg.vocab_size), dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": [layer_init(gen, cfg, dev) for _ in range(cfg.num_layers)],
    }


def layer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss)."""
    h = attention_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                        positions, causal=True)
    x = x + h
    hn = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.num_experts:
        impl = shard_ctx.moe_impl() or moe_lib.moe_apply
        h, aux = impl(p["moe"], hn, cfg)
    else:
        h = mlp_apply(p["mlp"], hn, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return constrain(x + h, "act_btd"), aux


def layer_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    h, cache = attention_decode(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                                cfg, cache)
    x = x + h
    return x + ffn_apply(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg), cache


def _embed(params, tokens, prefix_embeds):
    x = constrain(embed_apply(params["embed"], tokens), "act_btd")
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return constrain(x, "act_btd")


def _positions(b: int, s: int, device) -> torch.Tensor:
    """Global positions of the rank's ``s`` rows (offset under sequence
    parallelism)."""
    off = shard_ctx.seq_offset()
    return torch.arange(off, off + s, dtype=torch.int32,
                        device=device).expand(b, s)


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
          prefix_embeds: "torch.Tensor | None" = None, remat: bool = False
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s_total, padded_vocab) f32, aux_loss)."""
    x = _embed(params, tokens, prefix_embeds)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = shard_ctx.bind(layer_apply)
    for lp in params["layers"]:
        if remat:
            x, a = checkpoint(layer, lp, x, cfg, positions,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = layer_apply(lp, x, cfg, positions)
        aux = aux + a
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return constrain(unembed_apply(params["embed"], x), "logits"), aux


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            remat: bool = True, aux_weight: float = 0.01
            ) -> tuple[torch.Tensor, dict]:
    """Token-mean cross-entropy of ``batch["targets"]`` under
    ``batch["mask"]`` plus ``aux_weight`` times the MoE auxiliary loss;
    returns ``(loss, {"ce", "aux"})``.  A VLM batch's ``prefix_embeds``
    lead the sequence and their positions carry no loss."""
    prefix = batch.get("prefix_embeds")
    logits, aux = apply(params, batch["tokens"], cfg, prefix_embeds=prefix,
                        remat=remat)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    ce = cross_entropy(logits, batch["targets"], batch["mask"],
                       cfg.vocab_size)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
            "pos": 0}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int, *, prefix_embeds: "torch.Tensor | None" = None
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also fills the KV cache.

    Returns (last-position logits (b, padded_vocab), cache).
    """
    x = _embed(params, tokens, prefix_embeds)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit max_len "
                         f"{max_len}")
    positions = _positions(b, s, x.device)
    rows = shard_ctx.override("cache_rows")  # the rank's block of max_len
    cache = init_cache(cfg, b, rows(max_len) if rows else max_len,
                       device=x.device)
    fill = shard_ctx.override("cache_fill")
    for i, lp in enumerate(params["layers"]):
        hn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], hn, cfg)
        q = constrain(rope(q, positions, cfg.rope_theta), "act_q")
        k = constrain(rope(k, positions, cfg.rope_theta), "act_kv")
        v = constrain(v, "act_kv")
        o = _attend(q, constrain(k, "kv_heads"), constrain(v, "kv_heads"),
                    cfg, causal=True, q_offset=shard_ctx.seq_offset())
        x = x + constrain(o.reshape(b, s, -1) @ lp["attn"]["wo"], "tp_out")
        hn = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        if fill is not None:  # the cache's sequence split over ranks
            fill(cache["k"][i], k)
            fill(cache["v"][i], v)
        else:
            cache["k"][i, :, :k.shape[1]] = k
            cache["v"][i, :, :v.shape[1]] = v
        x = constrain(x + ffn_apply(lp, hn, cfg), "act_btd")
    cache["pos"] = k.shape[1]
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    last = shard_ctx.override("last_position")
    x = last(x) if last is not None else x[:, -1]
    return unembed_apply(params["embed"], x), cache


def decode_step(params: Params, token: torch.Tensor, cfg: ModelConfig,
                cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token decode: returns (logits (b, padded_vocab), cache).  Writes
    the token's K/V into ``cache`` in place; the returned cache shares its
    tensors and carries ``pos + 1``."""
    pos = int(cache["pos"])
    cache_len = shard_ctx.override("cache_len")
    max_len = cache_len() if cache_len is not None else cache["k"].shape[2]
    if pos >= max_len:
        raise ValueError(f"cache of {max_len} positions is full")
    x = constrain(embed_apply(params["embed"], token[:, None]), "act_btd")
    for i, lp in enumerate(params["layers"]):
        x, _ = layer_decode(lp, x, cfg, {"k": cache["k"][i],
                                          "v": cache["v"][i], "pos": pos})
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (unembed_apply(params["embed"], x[:, 0]),
            {"k": cache["k"], "v": cache["v"], "pos": pos + 1})


# --------------------------------------------------------------------------- #
# Params to and from the reference package (through numpy)
# --------------------------------------------------------------------------- #
def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a.copy(), device=device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Params:
    """The reference package's params (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device``.  With ``cfg.scan_layers`` the reference stacks every layer
    leaf on a leading ``num_layers`` axis; it is unstacked into the port's
    list of per-layer dicts."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if cfg.scan_layers:
        layers = [_tree_map(lambda a, i=i: np.asarray(a)[i], layers)
                  for i in range(cfg.num_layers)]
    out = {k: _tree_map(lambda a: _to_tensor(a, dev), v)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_tree_map(lambda a: _to_tensor(a, dev), lp)
                     for lp in layers]
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: widen (exact)
        t = t.float()
    return t.numpy().copy()


def params_to_numpy(params: Params, cfg: ModelConfig) -> dict:
    """Host numpy copy of the port's params in the reference layout (layer
    leaves restacked when ``cfg.scan_layers``; bf16 widened to f32)."""
    out = {k: _tree_map(_to_numpy, v) for k, v in params.items()
           if k != "layers"}
    layers = [_tree_map(_to_numpy, lp) for lp in params["layers"]]
    out["layers"] = _stack(layers) if cfg.scan_layers else layers
    return out


def _stack(layers: list) -> dict:
    """Per-layer numpy dicts restacked on a leading layer axis (the
    reference's scanned layout)."""
    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(lf[k] for lf in leaves)) for k in leaves[0]}
        return np.stack(leaves)
    return stack(*layers)
