"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

Per head ``h`` with state ``S in R^{P x N}`` (P = head dim, N = state dim):

    a_t = exp(dt_t * A_h)                       (scalar decay, A_h < 0)
    S_t = a_t * S_{t-1} + dt_t * x_t (x) B_t     (outer product update)
    y_t = S_t @ C_t  (+ D_h * x_t skip, added by the model)

``ssd_ref`` is the sequential-scan oracle; ``ssd_chunked`` is the chunked
(SSD) algorithm — quadratic within a chunk, linear across chunks — which is
what the CUDA kernel computes and what ``ssd_scan`` takes for CPU tensors.
``ssd_decode_step`` is the O(1) single-token state update of serving decode.
``ssd_bwd_ref`` is the chunked version's backward, written out (below).
Head ``h`` reads group ``h // (h / g)`` of B and C (the reference's
``jnp.repeat`` along the group axis).  Float64 inputs are computed in
float64 (for ``gradcheck``), everything else in float32.
"""
from __future__ import annotations

import torch


def _acc(t: torch.Tensor) -> torch.dtype:
    """The dtype the plain versions compute in: f64 for f64, else f32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """B or C with each group repeated for its ``rep`` heads, in f32 (f64
    for f64)."""
    return torch.repeat_interleave(t, rep, dim=dim).to(_acc(t))


def _init_state(init_state, shape, device, dtype=torch.float32
                ) -> torch.Tensor:
    if init_state is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return init_state.to(dtype)


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
    acc = _acc(x)
    xf = x.to(acc).reshape(b, nc, q, h, p)
    dtf = dt.to(acc).reshape(b, nc, q, h)
    Bh = _heads(B, rep, 2).reshape(b, nc, q, h, n)
    Ch = _heads(C, rep, 2).reshape(b, nc, q, h, n)
    S = _init_state(init_state, (b, h, p, n), x.device, acc)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bh[:, c], Ch[:, c]
        alog = dtc * A.to(acc)[None, None]  # (b, q, h) — log decay per step
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


def pad_steps(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (b, l, ...) with ``pad`` zero steps after its last: with dt = 0
    they are identity steps (decay exp(0) = 1, no input)."""
    return torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def ssd_bwd_ref(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, l, g, n)
    C: torch.Tensor,  # (b, l, g, n)
    dy: torch.Tensor,  # (b, l, h, p), y's cotangent
    dstate: "torch.Tensor | None" = None,  # (b, h, p, n), the final state's
    *,
    chunk: int = 64,
) -> tuple[torch.Tensor, ...]:
    """The gradients ``(dx, ddt, dA, dB, dC)`` of ``ssd_chunked``'s ``(y,
    final_state)`` for the cotangents ``dy`` and ``dstate``, written out
    (autograd through ``ssd_chunked`` would meet ``0 * inf`` where the
    decays above the diagonal overflow).  dx, dB and dC in their inputs'
    dtypes, ddt and dA in f32 (f64 for f64 inputs).

    Per chunk, with S_in the state entering it, L = cumsum(dt A), D[t,s] =
    exp(L_t - L_s) for s <= t (the exponent selected, never masked after
    the exp), G = C B^T, dot[t,s] = dy_t . x_s, Wd = dot D dt_s, M = G D
    dt_s, w_s = exp(L_q - L_s) dt_s and u_s = dS_out B_s; chunks run in
    reverse with dS carried back:

        dx_s   = sum_t M[t,s] dy_t + w_s u_s
        dC_t   = sum_s Wd[t,s] B_s + exp(L_t) S_in^T dy_t
        dB_s   = sum_t Wd[t,s] C_t + w_s dS_out^T x_s
        dS_in  = exp(L_q) dS_out + sum_t exp(L_t) dy_t (x) C_t
        ddt_s  = sum_t dot G D [t,s] + r_s + A revcumsum(dL)_s,
                 r_s = exp(L_q - L_s) x_s . u_s
        dL_t   = sum_{s<t} W[t,s] - sum_{t'>t} W[t',t] + C_t . (exp(L_t)
                 S_in^T dy_t) - dt_t r_t (t < q - 1), W = Wd G, and at
                 t = q - 1 also exp(L_q) <dS_out, S_in> + sum_{s<q-1} dt_s
                 r_s
        dA     = sum dt revcumsum(dL)

    dB and dC sum over the heads of each group.  A length that is not a
    multiple of ``chunk`` is padded with identity steps (``pad_steps``) and
    the pad's gradients cut away.

    The terms of dL that cancel exactly are left out rather than summed:
    W[t,t] is in both the row sum and the column sum at t, and dt_q r_q in
    both the last step's two state terms.  Where the decays are steep (A =
    -64) they are the largest terms of dL, and summing them would leave
    f32 ~3e-3 of dA; without them, ~3e-5."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    q = min(chunk, l)
    if l % q:
        pad = q - l % q
        dx, ddt, dA, dB, dC = ssd_bwd_ref(
            pad_steps(x, pad), pad_steps(dt, pad), A, pad_steps(B, pad),
            pad_steps(C, pad), pad_steps(dy, pad), dstate, chunk=q)
        return dx[:, :l], ddt[:, :l], dA, dB[:, :l], dC[:, :l]
    nc = l // q
    acc = _acc(x)
    xf = x.to(acc).reshape(b, nc, q, h, p)
    dyf = dy.to(acc).reshape(b, nc, q, h, p)
    dtf = dt.to(acc).reshape(b, nc, q, h)
    Af = A.to(acc)
    Bh = _heads(B, rep, 2).to(acc).reshape(b, nc, q, h, n)
    Ch = _heads(C, rep, 2).to(acc).reshape(b, nc, q, h, n)
    L = torch.cumsum(dtf * Af, dim=2).transpose(2, 3)  # (b, nc, h, q)
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    strict = causal.tril(-1)
    # The state entering each chunk, from a forward sweep.
    S = torch.zeros((b, h, p, n), dtype=acc, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(S)
        Lc = L[:, c]
        w = torch.exp(Lc[..., -1:] - Lc) * dtf[:, c].transpose(1, 2)
        S = (torch.exp(Lc[..., -1])[..., None, None] * S
             + torch.einsum("bhs,bshp,bshn->bhpn", w, xf[:, c], Bh[:, c]))
    dS = (torch.zeros_like(S) if dstate is None else dstate.to(acc))
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dB = torch.empty_like(Bh)
    dC = torch.empty_like(Ch)
    dA = torch.zeros((h,), dtype=acc, device=x.device)
    for c in reversed(range(nc)):
        xc, dyc, Bc, Cc = xf[:, c], dyf[:, c], Bh[:, c], Ch[:, c]
        Lc = L[:, c]  # (b, h, q)
        dtc = dtf[:, c].transpose(1, 2)  # (b, h, q)
        Lq = Lc[..., -1]
        D = torch.exp(torch.where(causal, Lc[..., :, None] - Lc[..., None, :],
                                  -torch.inf))
        dot = torch.einsum("bthp,bshp->bhts", dyc, xc)
        G = torch.einsum("bthn,bshn->bhts", Cc, Bc)
        Wd = dot * D * dtc[..., None, :]
        M = G * D * dtc[..., None, :]
        Wg = dot * G * D
        W = Wg * dtc[..., None, :]
        eL = torch.exp(Lc)
        rq = torch.exp(Lq[..., None] - Lc)  # (b, h, q)
        wq = rq * dtc
        Sin = s_in[c]
        u = torch.einsum("bhpn,bshn->bhsp", dS, Bc)
        dx[:, c] = (torch.einsum("bhts,bthp->bshp", M, dyc)
                    + (wq[..., None] * u).transpose(1, 2))
        dc_inter = eL[..., None] * torch.einsum("bthp,bhpn->bhtn", dyc, Sin)
        dC[:, c] = (torch.einsum("bhts,bshn->bthn", Wd, Bc)
                    + dc_inter.transpose(1, 2))
        dB[:, c] = (torch.einsum("bhts,bthn->bshn", Wd, Cc)
                    + (wq[..., None] * torch.einsum("bshp,bhpn->bhsn", xc,
                                                    dS)).transpose(1, 2))
        r = rq * torch.einsum("bshp,bhsp->bhs", xc, u)
        Ws = W * strict  # W[t,t] cancels between the row and column sums
        dtr = dtc * r  # and dt_q r_q between the last step's state terms
        dL = (Ws.sum(-1) - Ws.sum(-2)
              + torch.einsum("bthn,bhtn->bht", Cc, dc_inter))
        dL[..., :-1] -= dtr[..., :-1]
        dL[..., -1] += (torch.exp(Lq) * (dS * Sin).sum((-2, -1))
                        + dtr[..., :-1].sum(-1))
        rev = torch.flip(torch.cumsum(torch.flip(dL, (-1,)), -1), (-1,))
        ddt[:, c] = (Wg.sum(-2) + r + Af[:, None] * rev).transpose(1, 2)
        dA = dA + (dtc * rev).sum((0, 2))
        dS = (torch.exp(Lq)[..., None, None] * dS
              + torch.einsum("bht,bthp,bthn->bhpn", eL, dyc, Cc))

    def groups(t):  # (b, nc, q, h, n) -> (b, l, g, n), summed per group
        return t.reshape(b, l, g, rep, n).sum(3).to(B.dtype)

    return (dx.reshape(b, l, h, p).to(x.dtype), ddt.reshape(b, l, h), dA,
            groups(dB), groups(dC))
