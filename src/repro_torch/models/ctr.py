"""CTR models for the paper's federated experiments (§VI.A.1).

Logistic regression on hashed features — the paper's benchmark model for
device-cloud CTR prediction — plus the client-local SGD step used by both
simulation tiers.  A tiny MLP variant is included for heavier-client
ablations.  Parameters are plain ``dict[str, Tensor]``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.func import grad

from repro_torch.device import resolve_device

Params = dict  # dict[str, Tensor]


def lr_init(dim: int, *, dtype=torch.float32, device="cuda") -> Params:
    dev = resolve_device(device)
    return {
        "w": torch.zeros((dim,), dtype=dtype, device=dev),
        "b": torch.zeros((), dtype=dtype, device=dev),
    }


def params_from_numpy(tree: "dict[str, Any]", device="cuda") -> Params:
    """The reference package's params (as numpy arrays, e.g.
    ``{"w": (dim,), "b": ()}``) as the port's tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev)
            for k, v in tree.items()}


def params_to_numpy(params: Params) -> "dict[str, np.ndarray]":
    """Host numpy copy of the port's params (same keys and shapes)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def lr_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"] + params["b"]


def bce_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
             mask: "torch.Tensor | None" = None) -> torch.Tensor:
    logits = lr_logits(params, x).to(torch.float32)
    # ``relu`` and not ``maximum``/``clamp``: at a logit of exactly 0 (every
    # logit on the first step from zero params) the reference's gradient of
    # max(logits, 0) is 0; torch.maximum would give 0.5 and clamp 1.
    per = (torch.relu(logits) - logits * y
           + torch.log1p(torch.exp(-torch.abs(logits))))
    if mask is None:
        return per.mean()
    return (per * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor,
             mask: "torch.Tensor | None" = None) -> torch.Tensor:
    pred = (lr_logits(params, x) > 0).to(torch.float32)
    correct = (pred == y).to(torch.float32)
    if mask is None:
        return correct.mean()
    return (correct * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def make_local_train_fn(*, lr: float = 1e-3, epochs: int = 10):
    """Client-local SGD: the paper's per-device training operator.

    Returns ``f(params, batch, rng) -> (params, metrics)``; ``batch`` is
    ``{"x": (n, dim), "y": (n,), "mask": (n,)}`` (mask handles per-device
    padding in the vectorized cohort layout).  The tiers run it per device
    under ``torch.func.vmap``; ``rng`` (a per-device int64 seed) is unused
    by this model.
    """
    loss_grad = grad(bce_loss)

    def local_train(params: Params, batch: dict, rng):
        x, y, mask = batch["x"], batch["y"], batch.get("mask")
        p = params
        for _ in range(epochs):
            g = loss_grad(p, x, y, mask)
            p = {k: p[k] - lr * g[k] for k in p}
        metrics = {
            "loss": bce_loss(p, x, y, mask),
            "acc": accuracy(p, x, y, mask),
        }
        return p, metrics

    return local_train


def mlp_init(dim: int, hidden: int = 64, *, generator=None,
             dtype=torch.float32, device="cuda") -> Params:
    dev = resolve_device(device)
    w1 = torch.randn((dim, hidden), generator=generator, dtype=dtype)
    w2 = torch.randn((hidden,), generator=generator, dtype=dtype)
    return {
        "w1": (w1 * (2.0 / dim) ** 0.5).to(dev),
        "b1": torch.zeros((hidden,), dtype=dtype, device=dev),
        "w2": (w2 * (2.0 / hidden) ** 0.5).to(dev),
        "b2": torch.zeros((), dtype=dtype, device=dev),
    }


def mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]
