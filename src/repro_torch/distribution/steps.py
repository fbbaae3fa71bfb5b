"""The training step on one card.

``build_train_step(cfg, lmesh, shape, opt_cfg)`` keeps the reference's
signature (``src/repro/distribution/steps.py``) and semantics: a loop over
the step's microbatches adds each microbatch's gradients, cast to f32, into
one f32 buffer; the sum is divided by the microbatch count and AdamW
(``optim/optimizers.py``) updates the f32 master and the working params.
Each layer is rematerialized (``loss_fn(remat=True)``).

What differs on one card:

* Only ``lmesh=None`` is taken.  A mesh (the reference's ``LogicalMesh``)
  raises: sharding, ``ctx.py``, ``moe_parallel.py`` and ``launch/mesh.py``
  come with the distribution slice (ROADMAP).
* It returns ``(train_step, state_shape, batch_specs)``, not shardings:
  ``state_shape`` is the state's tree on the ``meta`` device (shapes and
  dtypes, nothing allocated) and ``batch_specs`` maps each batch field to
  ``(shape, dtype)``.
* Each leaf's gradient is added into the f32 buffer as soon as backward
  has produced it (``Tensor.register_post_accumulate_grad_hook``) and then
  freed: the same arithmetic as the reference's ``acc + g.astype(f32)``
  without a whole bf16 gradient tree per microbatch (7.2 GB at
  llama3.2-3b's width).  The buffer lives with the step function
  (``train_step.accumulator``), is zeroed at each step's start and serves
  as AdamW's scratch.
* ``train_step(state, batch)`` updates ``state`` in place and returns it
  with ``{"loss", "lr", "grad_norm"}`` as 0-d tensors on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, hybrid, mamba2, transformer
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizers import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    opt_state_from_numpy,
    tree_leaves,
    tree_map,
)

_NO_MESH = ("the port's training step runs on one card (lmesh=None); "
            "sharded training comes with the distribution slice (ROADMAP "
            "Step 5: sharding.py, ctx.py, moe_parallel.py, launch/mesh.py)")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Each batch field's ``(shape, dtype)``, leading ``(microbatches,
    per-microbatch batch)``, as the reference's ``train_batch_specs``."""
    n, mb = shape.microbatches, shape.global_batch // shape.microbatches
    s = shape.seq_len
    text = s - cfg.frontend_tokens if cfg.family == "vlm" else s
    specs = {
        "tokens": ((n, mb, text), torch.int32),
        "targets": ((n, mb, text), torch.int32),
        "mask": ((n, mb, text), torch.float32),
    }
    if cfg.family == "vlm":
        # Patch embeddings replace the first frontend_tokens positions.
        specs["prefix_embeds"] = ((n, mb, cfg.frontend_tokens, cfg.d_model),
                                  torch.bfloat16)
    if cfg.family == "audio":
        specs["src_embeds"] = ((n, mb, s, cfg.d_model), torch.bfloat16)
    return specs


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     device="cuda") -> dict:
    """Seeded params (the model's ``init``) and their AdamW state."""
    params = get_model(cfg).init(seed, cfg, device=device)
    return {"params": params, "opt": adamw_init(params)}


def train_state_from_numpy(tree: dict, cfg: ModelConfig,
                           device="cuda") -> dict:
    """The reference's ``{"params", "opt"}`` train state (numpy leaves) as
    the port's (layer stacks unstacked)."""
    mod = {"audio": encdec, "ssm": mamba2, "hybrid": hybrid}.get(
        cfg.family, transformer)

    def convert(t, dev):
        return mod.params_from_numpy(t, cfg, dev)

    return {"params": convert(tree["params"], device),
            "opt": opt_state_from_numpy(tree["opt"], convert, device)}


def build_train_step(cfg: ModelConfig, lmesh, shape: ShapeConfig,
                     opt_cfg: AdamWConfig = AdamWConfig()):
    """``(train_step, state_shape, batch_specs)`` for one card (see the
    module docstring)."""
    if lmesh is not None:
        raise NotImplementedError(_NO_MESH)
    api = get_model(cfg)
    n = shape.microbatches

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        acc = train_step.accumulator
        if acc is None or any(a.shape != p.shape or a.device != p.device
                              for a, p in zip(tree_leaves(acc), leaves)):
            acc = train_step.accumulator = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
        else:
            for a in tree_leaves(acc):
                a.zero_()

        def fold(p, a):
            def hook(t):
                a.add_(t.grad)
                t.grad = None
            return p.register_post_accumulate_grad_hook(hook)

        hooks = [fold(p.requires_grad_(True), a)
                 for p, a in zip(leaves, tree_leaves(acc))]
        try:
            loss_sum = None
            for i in range(n):
                mb = {k: v[i] for k, v in batch.items()}
                loss, _ = api.loss_fn(params, mb, cfg)
                loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            for h in hooks:
                h.remove()
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        with torch.no_grad():
            for a in tree_leaves(acc):
                a.div_(n)
        _, opt, om = adamw_update(opt_cfg, acc, state["opt"], params)
        state["opt"] = opt
        return state, {"loss": loss_sum / n, **om}

    train_step.accumulator = None
    meta = torch.device("meta")
    pshape = api.init(0, cfg, device=meta)
    state_shape = {"params": pshape, "opt": adamw_init(pshape)}
    return train_step, state_shape, train_batch_specs(cfg, shape)

