"""Plain float32 Mamba2 language model.

Mamba2 block (arXiv:2405.21060): RMSNorm; the input projections z, x, B, C
and dt; a causal depthwise convolution of width ``d_conv`` with bias, then
SiLU, over x and over B, C; the SSD scan

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D x_t

computed by its chunked definition (quadratic inside a chunk, a recurrence
across chunks); the gated RMSNorm norm(y * silu(z)) * w; out_proj; the
residual.

``params`` is the nested tree of ``models/mamba2.py``'s leaves, in f32.
``matmul`` sets the precision of the products (``reference/matmul.py``):
``matmul(a, w)`` is every weight product and ``matmul.operand`` is applied
to the scan's operands x, B and C.
``loss`` is the token-mean cross-entropy over the published vocabulary;
``logits_at`` gives the logits of chosen positions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.matmul import plain_matmul


def rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def causal_conv(u, w, b):
    """Depthwise causal conv: u (b, l, c), w (width, c), tap ``width-1`` on
    the current step; then the bias and SiLU."""
    width = w.shape[0]
    out = F.conv1d(F.pad(u.transpose(1, 2), (width - 1, 0)),
                   w.t().unsqueeze(1), b, groups=u.shape[-1])
    return F.silu(out.transpose(1, 2))


def ssd(x, dt, A, B, C, chunk):
    """y (b, l, h, p) of the SSD recurrence above (without the D skip) by
    chunks of ``chunk`` steps; a ragged tail is padded with steps of dt = 0
    (no decay, no input), which leaves the real steps' outputs alone."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = -l % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    L = x.shape[1]
    c, q = L // chunk, chunk
    rep = h // g
    X = (x * dt[..., None]).reshape(b, c, q, h, p)
    a = (dt * A).reshape(b, c, q, h).permute(0, 3, 1, 2)       # (b, h, c, q)
    acs = torch.cumsum(a, dim=-1)
    tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    seg = acs[..., :, None] - acs[..., None, :]                 # (b,h,c,q,q)
    decay = torch.exp(seg.masked_fill(~tril, float("-inf")))
    Bc = B.reshape(b, c, q, g, n)
    Cc = C.reshape(b, c, q, g, n)
    CB = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)
    CB = CB.repeat_interleave(rep, dim=2)                       # (b,c,h,q,q)
    M = CB * decay.permute(0, 2, 1, 3, 4)
    y = torch.einsum("bchij,bcjhp->bcihp", M, X)
    # Each chunk's own contribution to the state at its end.
    Bh = Bc.repeat_interleave(rep, dim=3)                       # (b,c,q,h,n)
    Ch = Cc.repeat_interleave(rep, dim=3)
    w_end = torch.exp(acs[..., -1:] - acs).permute(0, 2, 3, 1)  # (b,c,q,h)
    local = torch.einsum("bcjhn,bcjhp->bchpn", Bh, X * w_end[..., None])
    # The state entering each chunk, by the recurrence across chunks.
    chunk_decay = torch.exp(acs[..., -1])                       # (b, h, c)
    S = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    entering = []
    for k in range(c):
        entering.append(S)
        S = chunk_decay[:, :, k, None, None] * S + local[:, k]
    Sin = torch.stack(entering, dim=1)                          # (b,c,h,p,n)
    y = y + torch.einsum("bcihn,bchpn->bcihp", Ch, Sin) * torch.exp(
        acs).permute(0, 2, 3, 1)[..., None]
    return y.reshape(b, L, h, p)[:, :l]


def mamba_block(p, x, c, matmul):
    d = c["d_model"]
    di = c["expand"] * d
    hd, g, n = c["headdim"], c["ngroups"], c["d_state"]
    h = di // hd
    b, l, _ = x.shape
    hn = rmsnorm(x, p["ln"], c["rms_norm_eps"])
    z = matmul(hn, p["in_z"])
    xp = matmul(hn, p["in_x"])
    bc = matmul(hn, p["in_BC"])
    dt = F.softplus(matmul(hn, p["in_dt"]) + p["dt_bias"])
    xs = causal_conv(xp, p["conv_x_w"], p["conv_x_b"])
    BC = causal_conv(bc, p["conv_BC_w"], p["conv_BC_b"])
    B, C = BC.split(g * n, dim=-1)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, l, h, hd)
    rnd = matmul.operand
    y = ssd(rnd(xh), dt, A, rnd(B.reshape(b, l, g, n)),
            rnd(C.reshape(b, l, g, n)), c["chunk_size"])
    y = (y + p["D_skip"][:, None] * xh).reshape(b, l, di)
    y = rmsnorm(y * F.silu(z), p["norm_w"], c["rms_norm_eps"])
    return x + matmul(y, p["out_proj"])


def hidden(params, tokens, c, matmul=plain_matmul, remat=False):
    """The final normed hidden states (b, s, d)."""
    x = params["embed"]["embedding"][tokens.long()]

    for lp in params["layers"]:
        if remat:
            x = checkpoint(mamba_block, lp, x, c, matmul, use_reentrant=False)
        else:
            x = mamba_block(lp, x, c, matmul)
    return rmsnorm(x, params["ln_f"], c["rms_norm_eps"])


def logits_of(params, hid, c, matmul=plain_matmul):
    """Logits over the published vocabulary (the pad columns dropped)."""
    return matmul(hid, params["embed"]["lm_head"][:, :c["vocab_size"]])


def loss(params, tokens, targets, c, matmul=plain_matmul, remat=True):
    """Token-mean cross-entropy of ``targets`` (every position counts)."""
    lg = logits_of(params, hidden(params, tokens, c, matmul, remat), c,
                   matmul)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.reshape(-1).long())


@torch.no_grad()
def logits_at(params, tokens, positions, c, matmul=plain_matmul):
    """Logits (b, len(positions), vocab) at ``positions`` of each row."""
    hid = hidden(params, tokens, c, matmul)
    return logits_of(params, hid[:, positions], c, matmul)
