"""Plain PyTorch versions of flash attention (GQA, optional causal).

``attention_ref`` is the straightforward O(S^2)-memory oracle.
``attention_chunked`` is the online-softmax version with an O(S * chunk)
working set — the same math as the kernel, expressed in PyTorch — and is
what ``flash_attention`` takes for CPU tensors.  ``chip_smoke.py`` holds the
CUDA kernel against ``attention_ref`` on the card.

Rounding in ``attention_chunked`` follows the reference kernel: q is scaled
and rounded back to its dtype before QK^T, the softmax state stays f32 and
the probabilities are rounded to q's dtype before PV (bf16 operands are
widened to f32 for the products, which is exact).  ``attention_ref``, like
the reference's oracle, computes in f32 throughout.

The backward's plain versions: ``attention_fwd_lse`` is the oracle forward
that also returns each row's log-sum-exp ``(b, h, sq)``, and
``attention_bwd_ref`` writes dQ, dK and dV out from it (P recomputed from
the log-sum-exp, ``D = rowsum(dO * O)``, ``dS = P * (dP - D)``, dK and dV
summed over each KV head's g query heads): the plain version beside the
backward kernel.  The reference has no backward kernel: JAX differentiates
``attention_chunked`` (``src/repro/kernels/flash_attention/ref.py:49``).
Both compute in f32 (f64 for f64 inputs, so ``gradcheck`` can run).
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _scale(d: int, scale: "float | None") -> float:
    return (d ** -0.5) if scale is None else scale


def attention_ref(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, kv, d)
    v: torch.Tensor,  # (b, sk, kv, d)
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: "float | None" = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    kv = k.shape[2]
    if h % kv:
        raise ValueError("q heads must be a multiple of kv heads")
    g = h // kv
    scale = _scale(d, scale)
    qg = q.reshape(b, sq, kv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, k.float())
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, kv, d)
    v: torch.Tensor,  # (b, sk, kv, d)
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: "float | None" = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax chunked attention; the kernel's math in PyTorch.

    Never materializes more than ``q_chunk x kv_chunk`` scores per (b,
    kv-head, group).  Causal key chunks entirely above a query chunk's
    diagonal are skipped.
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _scale(d, scale)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    nq = -(-sq // q_chunk)
    nk = -(-sk // kv_chunk)
    qs = (q * scale).to(q.dtype).float()
    kf, vf = k.float(), v.float()
    kpos_all = torch.arange(nk * kv_chunk, device=q.device)
    outs = []
    for qi in range(nq):
        lo, hi = qi * q_chunk, min((qi + 1) * q_chunk, sq)
        qc = qs[:, lo:hi].reshape(b, hi - lo, kvh, g, d)
        qpos = q_offset + torch.arange(lo, lo + q_chunk, device=q.device)
        m = torch.full((b, kvh, g, hi - lo), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, hi - lo), device=q.device)
        o = torch.zeros((b, kvh, g, hi - lo, d), device=q.device)
        n_blocks = nk
        if causal:
            # Only chunks with kj * kv_chunk <= q_offset + (qi+1)*q_chunk - 1.
            n_blocks = min(
                (q_offset + (qi + 1) * q_chunk + kv_chunk - 1) // kv_chunk, nk)
        for kj in range(n_blocks):
            k0, k1 = kj * kv_chunk, min((kj + 1) * kv_chunk, sk)
            s = torch.einsum("bqkgd,bskd->bkgqs", qc, kf[:, k0:k1])
            kpos = kpos_all[k0:k1]
            valid = (qpos[: hi - lo, None] < q_offset + sq) & (
                kpos[None, :] < sk)
            if causal:
                valid = valid & (qpos[: hi - lo, None] >= kpos[None, :])
            s = torch.where(valid, s, NEG_INF)
            mn = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - mn[..., None])
            alpha = torch.exp(m - mn)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(q.dtype).float(), vf[:, k0:k1])
            m = mn
        out = (o / torch.clamp_min(l, 1e-37)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, hi - lo, h, d))
    return torch.cat(outs, dim=1)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _scores(q, k, *, causal, q_offset, scale):
    """Masked scores ``(b, kv, g, sq, sk)`` of the scaled query (rounded back
    to q's dtype, as the kernels do) against k, in the accumulation dtype,
    and that scaled query ``(b, sq, kv, g, d)``."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError("q heads must be a multiple of kv heads")
    acc = _acc(q.dtype)
    qs = (q * scale).to(q.dtype).to(acc).reshape(b, sq, kv, h // kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, k.to(acc))
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    return s, qs


def attention_fwd_lse(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, kv, d)
    v: torch.Tensor,  # (b, sk, kv, d)
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: "float | None" = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The oracle forward and each row's log-sum-exp: ``(o (b, sq, h, d) in
    q's dtype, lse (b, h, sq) f32)`` (f64 for f64 inputs)."""
    b, sq, h, d = q.shape
    s, _ = _scores(q, k, causal=causal, q_offset=q_offset,
                   scale=_scale(d, scale))
    lse = torch.logsumexp(s, dim=-1)  # (b, kv, g, sq)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(p.dtype))
    return (o.reshape(b, sq, h, d).to(q.dtype),
            lse.reshape(b, h, sq))


def attention_bwd_ref(
    q: torch.Tensor,  # (b, sq, h, d)
    k: torch.Tensor,  # (b, sk, kv, d)
    v: torch.Tensor,  # (b, sk, kv, d)
    o: torch.Tensor,  # (b, sq, h, d), the forward's output
    lse: torch.Tensor,  # (b, h, sq), the forward's log-sum-exp
    do: torch.Tensor,  # (b, sq, h, d), the output's cotangent
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: "float | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of the forward, written out: ``P = exp(S - lse)``, ``D =
    rowsum(dO * O)``, ``dV = P^T dO``, ``dS = P * (dP - D)`` with ``dP = dO
    V^T``, ``dK = dS^T (Q * scale)`` and ``dQ = scale * dS K``; dK and dV
    sum over the g query heads of each KV head.  Each in its input's
    dtype."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = _scale(d, scale)
    s, qs = _scores(q, k, causal=causal, q_offset=q_offset, scale=scale)
    acc = s.dtype
    p = torch.exp(s - lse.to(acc).reshape(b, kv, g, sq)[..., None])
    dof = do.to(acc).reshape(b, sq, kv, g, d)
    delta = (dof * o.to(acc).reshape(b, sq, kv, g, d)).sum(-1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, v.to(acc))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qs)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.to(acc)) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
