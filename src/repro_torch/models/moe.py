"""Mixture-of-Experts MLP block (GShard/Switch-style capacity dispatch).

The reference writes routing as dense one-hot dispatch and combine tensors
of shape ``(tokens, top-k, experts, capacity)`` contracted by einsums (one
pair of all-to-alls under GSPMD).  At granite-moe's serving prefill that
tensor alone would hold 5.4e9 elements, so the port computes the same
function with indices and never builds it:

* each kept ``(token, k)`` pair writes its token's row into an
  ``(experts, capacity + 1, d)`` buffer at ``(expert, position)``; pairs over
  capacity go to the trash row ``capacity`` (the reference's
  ``where(keep, pos, C)``, whose one-hot row is all zeros);
* the experts run as batched products over ``(experts, capacity, .)``;
* each pair gathers its expert's output row back, weighted by its gate
  rounded to the activations' dtype (the reference's
  ``comb.astype(x.dtype)``; 0 for a dropped pair), and the K rows of a
  token are summed in f32.

The capacity, the positions (a cumulative count in token-major ``(t, k)``
order), the gate normalization and the Switch auxiliary loss are the
reference's.  The router runs in f32 at full precision (no TF32), so expert
choices match.  Dropped tokens (over capacity) fall through the residual
connection, standard for capacity-factor routing.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import truncated_normal_init

Params = Any


def moe_init(generator, cfg: ModelConfig, dtype, device) -> Params:
    """The reference's recipe (truncated normal, f32 router, ``(E, ...)``
    expert weights), drawn from ``generator`` on ``device``."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    down_scale = 0.02 / (2 * cfg.num_layers) ** 0.5

    def tn(shape, dt=dtype, scale=0.02):
        return truncated_normal_init(generator, shape, dt, device, scale)

    p = {"router": tn((D, E), torch.float32)}
    if cfg.mlp_activation == "swiglu":
        p["w_gate"] = tn((E, D, F_))
    p["w_up"] = tn((E, D, F_))
    p["w_down"] = tn((E, F_, D), scale=down_scale)
    return p


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``max(int(T * K * capacity_factor / E), K)``."""
    cap = int(num_tokens * cfg.experts_per_token * cfg.capacity_factor
              / cfg.num_experts)
    return max(cap, cfg.experts_per_token)


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products at full precision inside the block: on a card TF32
    would round the router's inputs and could flip an expert choice."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


class Routing(NamedTuple):
    """Where each ``(token, k)`` pair goes, flattened token-major."""

    expert: torch.Tensor  # (T*K,) int64 expert of each pair
    slot: torch.Tensor  # (T*K,) int64 position in the expert, C if dropped
    gate: torch.Tensor  # (T*K,) f32 normalized gate, 0 where dropped
    capacity: int
    aux_loss: torch.Tensor  # () f32, Switch load-balancing loss


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig
          ) -> Routing:
    """Top-K routing of the ``(T, d)`` tokens with capacity
    :func:`capacity` (T)."""
    T = xt.shape[0]
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(T, cfg)
    with _full_f32_matmul():
        logits = xt.float() @ router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)  # (T, K)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    # Rank of each pair within its expert, in token-major order: a stable
    # sort groups the pairs by expert and keeps their token-major order
    # inside each group (the reference's running count; nothing here waits
    # for the card).
    flat = expert_idx.reshape(-1)  # (T*K,) token-major
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.empty_like(flat)
    pos[order] = (torch.arange(flat.shape[0], device=flat.device)
                  - starts[flat[order]])
    # Load-balancing auxiliary loss (Switch): E * sum_e f_e * P_e.
    fe = counts.float() / (T * K)
    aux = E * torch.sum(fe * probs.mean(dim=0))
    keep = pos < C
    slot = torch.where(keep, pos, C)
    gate = gate_vals.reshape(-1) * keep
    return Routing(flat, slot, gate, C, aux)


def _experts(p: Params, ein: torch.Tensor, cfg: ModelConfig,
             dtype: torch.dtype) -> torch.Tensor:
    """Every expert's MLP over its ``(E, C, d)`` slots."""
    if cfg.mlp_activation == "swiglu":
        gate = torch.bmm(ein, p["w_gate"])
        up = torch.bmm(ein, p["w_up"])
        h = F.silu(gate.float()).to(dtype) * up
    elif cfg.mlp_activation == "sq_relu":
        h = torch.square(torch.relu(torch.bmm(ein, p["w_up"])))
    elif cfg.mlp_activation == "gelu":
        h = F.gelu(torch.bmm(ein, p["w_up"]), approximate="tanh")
    else:
        raise ValueError(f"unknown activation {cfg.mlp_activation}")
    return torch.bmm(h.to(dtype), p["w_down"])


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (b, s, d), aux_loss scalar)."""
    b, s, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(b * s, D)
    r = route(p["router"], xt, cfg)
    C = r.capacity
    tok = torch.arange(b * s * K, device=x.device) // K  # pair -> token
    # Dispatch: one row per kept pair; dropped pairs land in the trash row
    # C (several may, in any order: the row is never read).
    ein = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    ein[r.expert, r.slot] = xt[tok]
    eout = _experts(p, ein[:, :C], cfg, x.dtype)  # (E, C, D)
    # Combine: gate (rounded to x.dtype) times the expert's row, summed
    # over the token's K pairs in f32; a dropped pair's gate is 0.
    rows = (eout[r.expert, r.slot.clamp_max(C - 1)].float()
            * r.gate.to(x.dtype).float()[:, None])
    out = rows.reshape(b * s, K, D).sum(dim=1).to(x.dtype)
    return out.reshape(b, s, D), r.aux_loss
