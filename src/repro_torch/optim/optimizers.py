"""From-scratch optimizers (no ``torch.optim``): AdamW with f32 master
weights, and SGD, as plain functions on nested dicts (and lists) of
tensors.

Mixed precision as in the reference (``src/repro/optim/optimizers.py``):
the working params are what the model consumes (bf16 in the published
configs); the optimizer keeps an f32 ``master`` copy and f32 moments ``m``
and ``v``, and an int32 ``step``.  Global-norm clipping and bias correction
follow the reference's arithmetic order.

Unlike the reference, :func:`adamw_update` works in place: it writes the
new moments and master into ``opt_state``, the new working params into
``params`` and clobbers ``grads`` (its f32 scratch), leaf by leaf, so the
temporaries stay at about one leaf.  At llama3.2-3b's width the largest
leaf (the 129 024 x 3 072 embedding) is 1.59 GB in f32; a tree of
out-of-place temporaries would be ~15 GB per temporary.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def tree_leaves(tree: Params) -> list:
    """The tensors of a nested dict/list/tuple tree in JAX's order (dict
    keys sorted; ``None`` is an empty subtree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decay)


def adamw_init(params: Params) -> dict:
    """f32 master copy and zero moments on each param's device."""
    leaf = tree_leaves(params)[0]
    return {
        "master": tree_map(lambda p: p.detach().to(torch.float32).clone(),
                           params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree: Params) -> torch.Tensor:
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, opt_state: dict,
                 params: Params) -> tuple[Params, dict, dict]:
    """One AdamW step, in place (see the module docstring): returns
    ``(params, opt_state, {"lr", "grad_norm"})`` with ``params`` and
    ``opt_state`` the updated inputs.  ``grads`` must be f32 leaves the
    caller gives up (they are overwritten)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    for g, m, v, master, p in zip(
            tree_leaves(grads), tree_leaves(opt_state["m"]),
            tree_leaves(opt_state["v"]), tree_leaves(opt_state["master"]),
            tree_leaves(params)):
        if g.dtype != torch.float32:
            raise TypeError(f"adamw_update takes f32 grads, got {g.dtype}")
        g.mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1.0 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1.0 - cfg.b2)
        denom = torch.div(v, b2c).sqrt_().add_(cfg.eps)
        upd = torch.div(m, b1c, out=g).div_(denom)
        upd.add_(master, alpha=cfg.weight_decay).mul_(lr)
        master.sub_(upd)
        p.copy_(master)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def sgd_update(grads: Params, params: Params, lr: float) -> Params:
    return tree_map(
        lambda p, g: (p.to(torch.float32) - lr * g.to(torch.float32)
                      ).to(p.dtype), params, grads)


def opt_state_from_numpy(tree: dict, params_from_numpy: Callable,
                         device="cuda") -> dict:
    """The reference's AdamW state (``adamw_init``'s dict as numpy arrays,
    e.g. ``jax.tree.map(np.asarray, opt)``) as the port's tensors:
    ``params_from_numpy(tree, device)`` converts each of master, m and v (a
    model's ``params_from_numpy`` with its config bound)."""
    out = {k: params_from_numpy(tree[k], device)
           for k in ("master", "m", "v")}
    leaf = tree_leaves(out["master"])[0]
    out["step"] = torch.tensor(int(tree["step"]), dtype=torch.int32,
                               device=leaf.device)
    return out
