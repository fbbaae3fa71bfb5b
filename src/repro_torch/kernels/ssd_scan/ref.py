"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

Per head ``h`` with state ``S in R^{P x N}`` (P = head dim, N = state dim):

    a_t = exp(dt_t * A_h)                       (scalar decay, A_h < 0)
    S_t = a_t * S_{t-1} + dt_t * x_t (x) B_t     (outer product update)
    y_t = S_t @ C_t  (+ D_h * x_t skip, added by the model)

``ssd_ref`` is the sequential-scan oracle; ``ssd_chunked`` is the chunked
(SSD) algorithm — quadratic within a chunk, linear across chunks — which is
what the CUDA kernel computes and what ``ssd_scan`` takes for CPU tensors.
``ssd_decode_step`` is the O(1) single-token state update of serving decode.
Head ``h`` reads group ``h // (h / g)`` of B and C (the reference's
``jnp.repeat`` along the group axis).
"""
from __future__ import annotations

import torch


def _heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """B or C with each group repeated for its ``rep`` heads, in f32."""
    return torch.repeat_interleave(t, rep, dim=dim).float()


def _init_state(init_state, shape, device) -> torch.Tensor:
    if init_state is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return init_state.float()


def ssd_ref(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h) — positive (post-softplus)
    A: torch.Tensor,  # (h,) — negative
    B: torch.Tensor,  # (b, l, g, n)
    C: torch.Tensor,  # (b, l, g, n)
    *,
    init_state: "torch.Tensor | None" = None,  # (b, h, p, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = _heads(B, rep, 2)  # (b, l, h, n)
    Ch = _heads(C, rep, 2)
    xf = x.float()
    dtf = dt.float()
    S = _init_state(init_state, (b, h, p, n), x.device)
    ys = []
    for t in range(l):
        a = torch.exp(dtf[:, t] * A[None])  # (b, h)
        S = (a[..., None, None] * S
             + (dtf[:, t, :, None] * xf[:, t])[..., None]
             * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", S, Ch[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), S.float()


def ssd_chunked(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, l, g, n)
    C: torch.Tensor,  # (b, l, g, n)
    *,
    chunk: int = 64,
    init_state: "torch.Tensor | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: O(L/Q) sequential steps of O(Q^2) intra-chunk work."""
    return _ssd_chunked_impl(x, dt, A, B, C, chunk=chunk,
                             init_state=init_state)


def _ssd_chunked_impl(x, dt, A, B, C, *, chunk, init_state):
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    if l % chunk:
        raise ValueError("length must be a multiple of the chunk size")
    nc, q = l // chunk, chunk
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Bh = _heads(B, rep, 2).reshape(b, nc, q, h, n)
    Ch = _heads(C, rep, 2).reshape(b, nc, q, h, n)
    S = _init_state(init_state, (b, h, p, n), x.device)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bh[:, c], Ch[:, c]
        alog = dtc * A[None, None]  # (b, q, h) — log decay per step
        L = torch.cumsum(alog, dim=1)  # inclusive cumsum
        # Intra-chunk: M[t,s] = (C_t . B_s) exp(L_t - L_s) dt_s  for s <= t.
        # exp(L_t - L_s) overflows above the diagonal; ``where`` selects
        # (never multiplies by) the mask, so those entries cannot leak NaN.
        CB = torch.einsum("bqhn,bshn->bhqs", Cc, Bc)
        Lt = L.transpose(1, 2)  # (b, h, q)
        decay = torch.exp(Lt[:, :, :, None] - Lt[:, :, None, :])
        M = torch.where(causal, CB * decay, 0.0)
        M = M * dtc.transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhqs,bshp->bqhp", M, xc)
        # Inter-chunk: y_t += exp(L_t) * (S0 @ C_t).
        y = y + torch.exp(L)[..., None] * torch.einsum("bhpn,bqhn->bqhp",
                                                        S, Cc)
        # State update: S' = exp(L_Q) S + sum_s exp(L_Q - L_s) dt_s x_s (x) B_s.
        Lq = L[:, -1]  # (b, h)
        w = torch.exp(Lq[:, None] - L) * dtc  # (b, q, h)
        S = torch.exp(Lq)[..., None, None] * S + torch.einsum(
            "bqhp,bqhn->bhpn", w[..., None] * xc, Bc)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, l, h, p)
    return y.to(x.dtype), S


def ssd_decode_step(
    x: torch.Tensor,  # (b, h, p)
    dt: torch.Tensor,  # (b, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, g, n)
    C: torch.Tensor,  # (b, g, n)
    state: torch.Tensor,  # (b, h, p, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update (serving decode path)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    Bh = _heads(B, rep, 1)
    Ch = _heads(C, rep, 1)
    dtf = dt.float()
    a = torch.exp(dtf * A[None])
    state = a[..., None, None] * state + (
        (dtf[..., None] * x.float())[..., None] * Bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x.dtype), state
