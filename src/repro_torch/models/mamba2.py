"""Mamba2 (SSD — state-space duality) language model.

Block layout follows the Mamba2 reference: projections producing ``[z, x,
B, C, dt]``, short causal depthwise conv + bias + SiLU over x and over
``[B, C]`` (the ``causal_conv`` kernel on a card, its plain chain on the
CPU), SSD scan (the ``ssd_scan`` kernel on a card, its chunked plain version
on the CPU), gated RMSNorm, ``out_proj``.  Decode carries an O(1) recurrent
state per layer and keeps its own one-token conv.

init/apply in the reference's style, with the layers as a Python list of
per-layer param dicts and the decode cache as a list of per-layer dicts
``{"conv_x", "conv_BC", "ssm"}`` (the reference stacks both for
``lax.scan`` when ``cfg.scan_layers``; :func:`params_from_numpy` unstacks
its params).  The reference's ``constrain`` calls stand at its places
(``distribution/ctx.py``; no-ops outside a sharding context); under tensor
parallelism a block runs on the rank's SSM heads, which it reads off its
params' shapes (:func:`_heads`).  ``loss_fn`` trains through the
scan's backward (``kernels/ssd_scan/ops.py::SsdScan``: the hand-written
backward on a card), each block rematerialized under ``remat``
(``torch.utils.checkpoint``, non-reentrant, as ``transformer.loss_fn``).
Under a profiler each call of a block is a ``model.block`` span
(``runtime/tracing.py``), a recomputation included: the span is opened
inside the function ``checkpoint`` runs again.  The block is its mixer
(``mixer_apply``, ``mixer_prefill``, ``mixer_decode``: norm to
``out_proj``) plus the residual, so that a model that scales what a mixer
adds (``models/granite_hybrid.py``) shares it.
``cfg.attention_impl`` ``"einsum"`` or ``"ref"`` asks for the plain scan
and conv (forward and backward) on any device, as it asks for the plain
attention; the block's ``impl`` routes both.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.device import resolve_device
from repro_torch.distribution import ctx as shard_ctx
from repro_torch.distribution.ctx import constrain
from repro_torch.kernels.causal_conv.ops import causal_conv
from repro_torch.kernels.ssd_scan.ops import ssd_decode_step, ssd_scan
from repro_torch.models.layers import (
    _PLAIN,
    cross_entropy,
    embed_apply,
    embed_init,
    rmsnorm,
    rmsnorm_gated,
    truncated_normal_init,
    unembed_apply,
)
from repro_torch.models.transformer import (
    _generator,
    _to_numpy,
    _to_tensor,
    _tree_map,
    dtype_of,
)
from repro_torch.runtime import tracing

Params = Any


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_heads
    conv_dim = di + 2 * g * n
    return di, g, n, h, conv_dim


def block_init(generator, cfg: ModelConfig, device) -> Params:
    dt = dtype_of(cfg)
    D = cfg.d_model
    di, g, n, h, conv_dim = _dims(cfg)

    def tn(shape, scale=0.02):
        return truncated_normal_init(generator, shape, dt, device, scale)

    # dt bias init so softplus(dt_bias) spans [1e-3, 1e-1] (mamba2 default).
    u = torch.rand((h,), generator=generator, dtype=torch.float32,
                   device=device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    width = cfg.ssm_conv_width
    return {
        "ln": torch.ones((D,), dtype=dt, device=device),
        "in_z": tn((D, di)),
        "in_x": tn((D, di)),
        "in_BC": tn((D, 2 * g * n)),
        "in_dt": tn((D, h)),
        "conv_x_w": tn((width, di), 0.5 / width),
        "conv_x_b": torch.zeros((di,), dtype=dt, device=device),
        "conv_BC_w": tn((width, 2 * g * n), 0.5 / width),
        "conv_BC_b": torch.zeros((2 * g * n,), dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": dt_bias,
        "D_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm_w": torch.ones((di,), dtype=dt, device=device),
        "out_proj": tn((di, D), 0.02 / (2 * cfg.num_layers) ** 0.5),
    }


def _project(p: Params, hn: torch.Tensor):
    return hn @ p["in_z"], hn @ p["in_x"], hn @ p["in_BC"], hn @ p["in_dt"]


def _dt(dt_raw: torch.Tensor, p: Params) -> torch.Tensor:
    # F.softplus returns its input above 20 where jax.nn.softplus computes
    # log1p(exp(-x)) + x: the two differ by under 2e-9 relative there.
    return F.softplus(dt_raw.float() + p["dt_bias"])


def _heads(p: Params, cfg: ModelConfig) -> tuple[int, int]:
    """(heads, d_inner) of the block's params: the rank's share under
    tensor parallelism, else the config's."""
    h = p["in_dt"].shape[-1]
    return h, h * cfg.ssm_head_dim


def _scan(p: Params, x: torch.Tensor, xs, BC, dt_raw, cfg: ModelConfig,
          impl: str):
    """The SSD scan of a block over the conv outputs, with the D skip.
    Returns (y (b, l, di) in x's dtype, final state)."""
    b, l, _ = x.shape
    g, n, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    h, di = _heads(p, cfg)
    B, C = torch.split(BC, g * n, dim=-1)  # strided views: the kernel
    dt = _dt(dt_raw, p)                    # takes contiguous tensors only
    A = -torch.exp(p["A_log"])
    y, state = ssd_scan(
        xs.reshape(b, l, h, hd), dt, A,
        B.reshape(b, l, g, n).contiguous(), C.reshape(b, l, g, n).contiguous(),
        chunk=min(cfg.ssm_chunk, l), impl=impl)
    y = y + p["D_skip"][None, None, :, None] * xs.reshape(b, l, h, hd).float()
    return y.reshape(b, l, di).to(x.dtype), state


def scan_impl(cfg: ModelConfig) -> str:
    """The scan a model with ``cfg`` runs: ``"chunked"`` (the plain
    version) when ``cfg.attention_impl`` asks for the plain ops, else
    ``"auto"`` (the kernels on a card)."""
    return "chunked" if cfg.attention_impl in _PLAIN else "auto"


def mixer_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                *, impl: str = "auto") -> torch.Tensor:
    """The block's mixer, from its norm to ``out_proj``: what the block
    adds to the residual stream ``x``."""
    hn = constrain(rmsnorm(x, p["ln"], cfg.norm_eps), "tp_in")
    z, xp, BC_raw, dt_raw = _project(p, hn)
    z, xp = constrain(z, "ssm_inner"), constrain(xp, "ssm_inner")
    BC_raw = constrain(BC_raw, "ssm_bc")
    xs = causal_conv(xp, p["conv_x_w"], p["conv_x_b"], impl=impl)
    BC = causal_conv(BC_raw, p["conv_BC_w"], p["conv_BC_b"], impl=impl)
    y, _ = _scan(p, x, xs, BC, dt_raw, cfg, impl)
    y = rmsnorm_gated(constrain(y, "ssm_inner"), z, p["norm_w"],
                      cfg.norm_eps)
    return constrain(y @ p["out_proj"], "tp_out")


@tracing.spanned("model.block")
def block_apply(p: Params, x: torch.Tensor, cfg: ModelConfig,
                *, impl: str = "auto") -> torch.Tensor:
    return constrain(x + mixer_apply(p, x, cfg, impl=impl), "act_btd")


def mixer_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  *, impl: str = "auto") -> tuple[torch.Tensor, dict]:
    """Like :func:`mixer_apply` but also returns the decode cache (conv
    tail + ssm state)."""
    l = x.shape[1]
    width = cfg.ssm_conv_width
    hn = constrain(rmsnorm(x, p["ln"], cfg.norm_eps), "tp_in")
    z, xp, BC_raw, dt_raw = _project(p, hn)
    xs = causal_conv(xp, p["conv_x_w"], p["conv_x_b"], impl=impl)
    BC = causal_conv(BC_raw, p["conv_BC_w"], p["conv_BC_b"], impl=impl)
    y, state = _scan(p, x, xs, BC, dt_raw, cfg, impl)
    y = rmsnorm_gated(y, z, p["norm_w"], cfg.norm_eps)
    # Copies: a view of the last width-1 steps would keep the whole
    # (b, l, ·) projection alive for as long as the cache lives.
    cache = {
        "conv_x": xp[:, l - (width - 1):].to(x.dtype, copy=True),
        "conv_BC": BC_raw[:, l - (width - 1):].to(x.dtype, copy=True),
        "ssm": state,
    }
    return constrain(y @ p["out_proj"], "tp_out"), cache


@tracing.spanned("model.block")
def block_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  *, impl: str = "auto") -> tuple[torch.Tensor, dict]:
    """Like block_apply but returns the decode cache (conv tail + ssm state)."""
    out, cache = mixer_prefill(p, x, cfg, impl=impl)
    return x + out, cache


def mixer_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """The mixer's one-token recurrent update: x (b, 1, d)."""
    b = x.shape[0]
    g, n, hd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    h, di = _heads(p, cfg)
    hn = constrain(rmsnorm(x, p["ln"], cfg.norm_eps), "tp_in")
    z, xp, BC_raw, dt_raw = _project(p, hn)
    conv_x_in = torch.cat([cache["conv_x"], xp], dim=1)  # (b, width, di)
    conv_BC_in = torch.cat([cache["conv_BC"], BC_raw], dim=1)
    cx = (conv_x_in * p["conv_x_w"]).sum(dim=1, keepdim=True) + p["conv_x_b"]
    cbc = ((conv_BC_in * p["conv_BC_w"]).sum(dim=1, keepdim=True)
           + p["conv_BC_b"])
    xs = F.silu(cx.float()).to(x.dtype)[:, 0]
    BC = F.silu(cbc.float()).to(x.dtype)[:, 0]
    B, C = torch.split(BC, g * n, dim=-1)
    dt = _dt(dt_raw[:, 0], p)
    A = -torch.exp(p["A_log"])
    y, state = ssd_decode_step(
        xs.reshape(b, h, hd), dt, A,
        B.reshape(b, g, n), C.reshape(b, g, n), cache["ssm"])
    y = y + p["D_skip"][None, :, None] * xs.reshape(b, h, hd).float()
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm_gated(y, z, p["norm_w"], cfg.norm_eps)
    new_cache = {"conv_x": conv_x_in[:, 1:], "conv_BC": conv_BC_in[:, 1:],
                 "ssm": state}
    return constrain(y @ p["out_proj"], "tp_out"), new_cache


@tracing.spanned("model.block")
def block_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token recurrent update: x (b, 1, d)."""
    out, cache = mixer_decode(p, x, cfg, cache)
    return x + out, cache


# --------------------------------------------------------------------------- #
# Full model
# --------------------------------------------------------------------------- #
def init(generator, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random params from ``generator`` (a ``torch.Generator`` on
    ``device``, or an int seed): the reference's recipe, not its bits."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    dt = dtype_of(cfg)
    return {
        "embed": embed_init(gen, cfg, dt, padded_vocab(cfg.vocab_size), dev),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": [block_init(gen, cfg, dev) for _ in range(cfg.num_layers)],
    }


def rematerialized(f, remat: bool):
    """``f`` checkpointed (non-reentrant) when ``remat``, as the reference
    wraps a block in ``jax.checkpoint``; else ``f``."""
    if not remat:
        return f
    f = shard_ctx.bind(f)
    return lambda *a, **kw: checkpoint(f, *a, use_reentrant=False,
                                       preserve_rng_state=False, **kw)


def apply(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
          remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (b, s, padded_vocab) f32, aux_loss = 0)."""
    x = constrain(embed_apply(params["embed"], tokens), "act_btd")
    block = rematerialized(block_apply, remat)
    for lp in params["layers"]:
        x = block(lp, x, cfg, impl=scan_impl(cfg))
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return (constrain(unembed_apply(params["embed"], x), "logits"),
            torch.zeros((), dtype=torch.float32, device=x.device))


def loss_fn(params: Params, batch: dict, cfg: ModelConfig, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Token-mean cross-entropy of ``batch["targets"]`` under
    ``batch["mask"]`` over the padded vocabulary (its pad never a target);
    returns ``(loss, {"ce"})``."""
    logits, _ = apply(params, batch["tokens"], cfg, remat=remat)
    ce = cross_entropy(logits, batch["targets"], batch["mask"],
                       cfg.vocab_size)
    return ce, {"ce": ce}


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, *,
               device="cuda") -> list:
    """One ``{"conv_x", "conv_BC", "ssm"}`` per layer; max_len unused (SSM
    decode state is O(1))."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    di, g, n, h, _ = _dims(cfg)
    w = cfg.ssm_conv_width - 1
    return [{"conv_x": torch.zeros((batch, w, di), dtype=dt, device=dev),
             "conv_BC": torch.zeros((batch, w, 2 * g * n), dtype=dt,
                                    device=dev),
             "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, n),
                                dtype=torch.float32, device=dev)}
            for _ in range(cfg.num_layers)]


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int = 0) -> tuple[torch.Tensor, list]:
    """Returns (last-position logits (b, padded_vocab), per-layer caches)."""
    x = constrain(embed_apply(params["embed"], tokens), "act_btd")
    caches = []
    for lp in params["layers"]:
        x, c = block_prefill(lp, x, cfg)
        caches.append(c)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed_apply(params["embed"], x[:, -1]), caches


def decode_step(params: Params, token: torch.Tensor, cfg: ModelConfig,
                caches: list) -> tuple[torch.Tensor, list]:
    x = constrain(embed_apply(params["embed"], token[:, None]), "act_btd")
    new = []
    for lp, cache in zip(params["layers"], caches):
        x, c = block_decode(lp, x, cfg, cache)
        new.append(c)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    return unembed_apply(params["embed"], x[:, 0]), new


# --------------------------------------------------------------------------- #
# Params to and from the reference package (through numpy)
# --------------------------------------------------------------------------- #
def _unstack_layers(layers, cfg: ModelConfig) -> list:
    """The reference's layer params (or caches) as a list of per-layer
    dicts: with ``cfg.scan_layers`` it stacks every leaf on a leading
    ``num_layers`` axis."""
    if not cfg.scan_layers:
        return list(layers)
    return [_tree_map(lambda a, i=i: np.asarray(a)[i], layers)
            for i in range(cfg.num_layers)]


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> Params:
    """The reference package's params (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tensors on
    ``device``; scanned layers are unstacked.  ``A_log``, ``dt_bias`` and
    ``D_skip`` keep their f32."""
    dev = resolve_device(device)
    out = {k: _tree_map(lambda a: _to_tensor(a, dev), v)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_tree_map(lambda a: _to_tensor(a, dev), lp)
                     for lp in _unstack_layers(tree["layers"], cfg)]
    return out


def params_to_numpy(params: Params, cfg: ModelConfig) -> dict:
    """Host numpy copy of the port's params in the reference layout (layer
    leaves restacked when ``cfg.scan_layers``; bf16 widened to f32)."""
    out = {k: _tree_map(_to_numpy, v) for k, v in params.items()
           if k != "layers"}
    layers = [_tree_map(_to_numpy, lp) for lp in params["layers"]]
    if cfg.scan_layers:
        layers = {k: np.stack([lp[k] for lp in layers]) for k in layers[0]}
    out["layers"] = layers
    return out
