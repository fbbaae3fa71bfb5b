"""Sharding context: models call ``constrain(x, role)``; the distribution
layer installs a role -> rule map.  Outside a context every call is a
no-op, so model code runs unmodified on a single device.

A rule is a :class:`~repro_torch.distribution.sharding.Sharding` or a
callable.  ``constrain`` redistributes a ``DTensor`` to a ``Sharding``'s
placements and passes a plain tensor through a callable rule: the sharded
steps run each layer on the rank's own shards as plain tensors, and their
callables are the explicit collectives that move a tensor into the role's
placement (an all-gather of the sequence for ``act_kv``, say).  A plain
tensor under a ``Sharding`` rule is left as it is.

Roles (the reference's):
  act_btd    — residual-stream activations (batch, seq, d_model)
  act_q      — query tensor (batch, seq, heads, head_dim)
  act_kv     — key/value tensors (batch, seq, kv_heads, head_dim)
  logits     — (batch, seq, padded_vocab)
  ssm_inner  — mamba inner activations (batch, seq, d_inner)
  ssm_bc     — mamba B/C projections (batch, seq, 2*g*n)
  cache_kv   — a layer's KV cache (batch, max_len, kv_heads, head_dim)
  moe_impl   — callable override for the MoE block (expert-parallel)

The port's own, at the products and the attention call of its tensor
parallel layers:
  tp_in      — a replicated activation entering a tp-sharded product
  tp_out     — a product's tp partials, summed
  kv_heads   — the kv heads of the rank's q heads (kv heads replicated)

Callable overrides (``override(name)``), for steps that need more than a
change of placement: ``moe_impl``, ``unembed``, ``cross_entropy``,
``norm_var`` (the gated norm's mean of squares over features split across
ranks), ``seq_offset`` (the global position of the rank's first sequence
row), and for serving ``last_position`` and, where a cache's sequence is
split over ranks, ``cache_rows`` (the rank's rows of a cache of
``max_len``), ``cache_fill``, ``cache_write``, ``cache_len`` and
``decode_attention``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable

import torch

_CTX: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "sharding_ctx", default=None
)


@contextlib.contextmanager
def sharding_context(rules: dict[str, Any]):
    token = _CTX.set(rules)
    try:
        yield
    finally:
        _CTX.reset(token)


def constrain(x: torch.Tensor, role: str) -> torch.Tensor:
    rules = _CTX.get()
    if not rules:
        return x
    rule = rules.get(role)
    if rule is None:
        return x
    if callable(rule):
        return rule(x)
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.redistribute(rule.mesh, rule.placements)
    return x


def override(name: str) -> Callable | None:
    rules = _CTX.get()
    return rules.get(name) if rules else None


def moe_impl() -> Callable | None:
    return override("moe_impl")


def seq_offset() -> int:
    """Global index of the rank's first sequence position (0 unsharded)."""
    fn = override("seq_offset")
    return int(fn()) if fn is not None else 0


def bind(fn: Callable) -> Callable:
    """``fn`` run under the rules active now — for a function that runs
    again later, as a rematerialized layer's forward does in the backward
    (which may run on another thread, outside this context)."""
    rules = _CTX.get()
    if rules is None:
        return fn

    def bound(*args, **kwargs):
        with sharding_context(rules):
            return fn(*args, **kwargs)

    return bound


def active() -> bool:
    return _CTX.get() is not None
