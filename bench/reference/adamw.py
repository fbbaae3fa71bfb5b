"""AdamW (Loshchilov and Hutter) with global-norm clipping, bias correction
and decoupled weight decay, on flat lists of f32 tensors; the learning rate
warms up linearly over ``warmup_steps`` and then decays by a cosine to
``min_lr_ratio`` of its peak.  ``hp`` is the traffic file's ``adamw``."""
from __future__ import annotations

import math

import torch


def lr_at(hp: dict, step: int) -> float:
    if step < hp["warmup_steps"]:
        return hp["lr"] * step / max(hp["warmup_steps"], 1)
    prog = min(max((step - hp["warmup_steps"])
                   / max(hp["total_steps"] - hp["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return hp["lr"] * (hp["min_lr_ratio"] + (1.0 - hp["min_lr_ratio"]) * cos)


class AdamW:
    def __init__(self, params: list, hp: dict):
        self.params, self.hp = params, hp
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.step = 0

    @torch.no_grad()
    def update(self, grads: list) -> float:
        """One step; returns the gradients' global norm before clipping."""
        hp = self.hp
        self.step += 1
        t = self.step
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(hp["grad_clip"] / torch.clamp_min(norm, 1e-9),
                            max=1.0)
        lr = lr_at(hp, t)
        b1c, b2c = 1.0 - hp["b1"] ** t, 1.0 - hp["b2"] ** t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g * scale
            m.mul_(hp["b1"]).add_(g, alpha=1.0 - hp["b1"])
            v.mul_(hp["b2"]).addcmul_(g, g, value=1.0 - hp["b2"])
            upd = (m / b1c) / ((v / b2c).sqrt() + hp["eps"])
            p.sub_(lr * (upd + hp["weight_decay"] * p))
        return float(norm)
