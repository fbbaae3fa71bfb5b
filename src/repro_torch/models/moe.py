"""Mixture-of-Experts MLP blocks: GShard/Switch-style capacity dispatch
(``moe_apply``) and dropless routing over a card's share of the experts
(``dropless_apply``, below).

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

from repro_torch.configs.base import HybridMoEConfig, ModelConfig
from repro_torch.kernels.moe_experts.ops import moe_experts
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


# --------------------------------------------------------------------------- #
# Dropless routing over the held experts (granitemoehybrid)
# --------------------------------------------------------------------------- #
# The router scores all ``cfg.num_experts`` experts and each token takes its
# ``experts_per_token`` largest logits, gated by their softmax (upstream
# ``GraniteMoeHybridTopKGating``).  The card holds the first
# ``experts_held`` experts and computes only the (token, k) pairs routed
# there, every one of them: no capacity.  Pairs are sorted by
# held expert (token-major inside each; the others last) into a static
# ``T * min(held, K)`` rows, the most a dropless route can need, and each
# expert's rows end at an offset that stays on the device: nothing in the
# layer waits for the card.  The products run grouped over the held
# experts (``kernels/moe_experts``); the rows past the last offset are
# never computed nor read.  Dispatch and combine gather rows and sum each
# token's pairs in f32 in the order of k, forward and backward, so the
# layer adds nothing by atomics and repeats bit for bit.  The gates are
# rounded to the tokens' dtype (upstream's ``type_as``) in value only: their
# gradient reaches the softmax in f32, whose backward subtracts nearly
# equal terms.


def dropless_init(generator, cfg: HybridMoEConfig, dtype, device) -> Params:
    """An f32 router over every expert and the held experts' SwiGLU
    weights ``w1 (held, d, 2 d_ff)`` (gate, then up) and ``w2 (held,
    d_ff, d)``."""
    D, F_, n = cfg.d_model, cfg.d_ff, cfg.experts_held

    def tn(shape, dt=dtype, scale=0.02):
        return truncated_normal_init(generator, shape, dt, device, scale)

    return {"router": tn((D, cfg.num_experts), torch.float32),
            "w1": tn((n, D, 2 * F_)),
            "w2": tn((n, F_, D), scale=0.02 / (2 * cfg.num_layers) ** 0.5)}


class DroplessRouting(NamedTuple):
    """Where each ``(token, k)`` pair goes."""

    pair: torch.Tensor  # (R,) int64 pair (t * K + k) of each dispatched row
    offs: torch.Tensor  # (held,) int32 end of each held expert's rows
    row: torch.Tensor   # (T, K) int64 row of each pair (clamped if not held)
    held: torch.Tensor  # (T, K) bool: the pair's expert is held here
    gate: torch.Tensor  # (T, K) f32 gate: its value rounded to the tokens'
    #                     dtype, its gradient not


def route_dropless(router: torch.Tensor, xt: torch.Tensor,
                   cfg: HybridMoEConfig) -> DroplessRouting:
    """Top-K routing of the ``(T, d)`` tokens over all experts, the pairs
    of the held experts sorted into rows."""
    T = xt.shape[0]
    K, n = cfg.experts_per_token, cfg.experts_held
    with _full_f32_matmul():
        logits = xt.float() @ router  # (T, E)
    top, idx = torch.topk(logits, K, dim=-1)
    gate = torch.softmax(top, dim=-1)
    held = idx < n
    group = torch.where(held, idx, n).reshape(-1)  # n: not held here
    order = torch.argsort(group, stable=True)
    counts = torch.zeros(n + 1, dtype=group.dtype, device=group.device)
    counts.scatter_add_(0, group, torch.ones_like(group))
    rows = T * min(n, K)
    row = torch.empty_like(order)
    row[order] = torch.arange(T * K, device=order.device)
    return DroplessRouting(
        pair=order[:rows],
        offs=torch.cumsum(counts[:n], dim=0).to(torch.int32),
        row=row.reshape(T, K).clamp_max(rows - 1), held=held,
        gate=gate + (gate.to(xt.dtype).float() - gate).detach())


def _sum_pairs(y: torch.Tensor, row: torch.Tensor, held: torch.Tensor,
               gate: "torch.Tensor | None") -> torch.Tensor:
    """``(T, d)`` f32: for each token, its held pairs' rows of ``y``
    (times their gates) summed in the order of k."""
    out = torch.zeros(row.shape[0], y.shape[1], dtype=torch.float32,
                      device=y.device)
    for k in range(row.shape[1]):
        r = y.index_select(0, row[:, k]).float()
        if gate is not None:
            r = r * gate[:, k, None]
        out.add_(torch.where(held[:, k, None], r, 0.0))
    return out


class _Dispatch(torch.autograd.Function):
    """The tokens' rows in dispatch order; the backward sums each token's
    held rows."""

    @staticmethod
    def forward(ctx, xt, pair, row, held):
        ctx.save_for_backward(row, held)
        return xt.index_select(0, pair // row.shape[1])

    @staticmethod
    def backward(ctx, g):
        row, held = ctx.saved_tensors
        return _sum_pairs(g, row, held, None).to(g.dtype), None, None, None


class _Combine(torch.autograd.Function):
    """Each token's held pairs' expert rows times their gates, summed in
    f32 and rounded to the rows' dtype."""

    @staticmethod
    def forward(ctx, y, gate, pair, row, held):
        ctx.save_for_backward(y, gate, pair, row, held)
        return _sum_pairs(y, row, held, gate).to(y.dtype)

    @staticmethod
    def backward(ctx, go):
        y, gate, pair, row, held = ctx.saved_tensors
        K = row.shape[1]
        gf = go.float()
        mine = held.reshape(-1).index_select(0, pair)[:, None]
        dy = torch.where(mine, gf.index_select(0, pair // K)
                         * gate.reshape(-1).index_select(0, pair)[:, None],
                         0.0).to(y.dtype)
        dgate = None
        if ctx.needs_input_grad[1]:
            dgate = torch.stack(
                [(gf * y.index_select(0, row[:, k]).float()).sum(-1)
                 for k in range(K)], dim=1)
            dgate = torch.where(held, dgate, 0.0)
        return dy, dgate, None, None, None


def dropless_apply(p: Params, x: torch.Tensor, cfg: HybridMoEConfig, *,
                   impl: str = "auto") -> torch.Tensor:
    """The held experts' part of the layer's MoE output (b, s, d); the
    absent experts' pairs add nothing.  ``impl`` routes the expert
    products (``kernels/moe_experts``)."""
    b, s, D = x.shape
    xt = x.reshape(b * s, D)
    r = route_dropless(p["router"], xt, cfg)
    xd = _Dispatch.apply(xt, r.pair, r.row, r.held)
    y = moe_experts(xd, p["w1"], p["w2"], r.offs, impl=impl)
    out = _Combine.apply(y, r.gate, r.pair, r.row, r.held)
    return out.reshape(b, s, D)
