"""Plain PyTorch versions of single-token decode attention over a KV cache.

``decode_attention_ref`` is what ``decode_attention`` takes for CPU tensors
(and for ``impl="ref"``); ``chip_smoke.py`` holds the CUDA kernel against it
on the card.  ``decode_attention_partial`` and ``combine_partials`` are the
flash-decoding split-and-combine: the kernel cuts the cache into splits and
combines their partial softmax states exactly this way.

Rounding follows the reference kernel: q is scaled and rounded back to its
dtype before QK^T, scores and the softmax stay f32, and the probabilities
are rounded to v's dtype before PV.  bf16 operands are widened to f32 for
the products (a bf16 x bf16 product is exact in f32), which is what the
reference's ``preferred_element_type=f32`` products compute.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _scale(d: int, scale: "float | None") -> float:
    return (d ** -0.5) if scale is None else scale


def decode_attention_ref(
    q: torch.Tensor,  # (b, h, d) — one new token per sequence
    k_cache: torch.Tensor,  # (b, s, kv, d)
    v_cache: torch.Tensor,  # (b, s, kv, d)
    lengths: torch.Tensor,  # (b,) int — valid cache entries per sequence
    *,
    scale: "float | None" = None,
) -> torch.Tensor:
    b, h, d = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = _scale(d, scale)
    qg = (q.reshape(b, kv, g, d) * scale).to(q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None] < lengths[:, None]  # (b, s)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o.reshape(b, h, d).to(q.dtype)
    # length-0 rows (a retired or never-filled arena slot): the all-masked
    # softmax degenerates to uniform weights over garbage; return exact
    # zeros, as the kernel's empty accumulator does.
    return torch.where(lengths[:, None, None] > 0, o, torch.zeros_like(o))


def decode_attention_partial(
    q: torch.Tensor,  # (b, h, d)
    k_cache: torch.Tensor,  # (b, s_split, kv, d) — one split of the cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (b,) valid entries in THIS split
    *,
    scale: "float | None" = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-decoding partial results of one split, all in f32.

    Returns ``(o, m, l)``: ``o`` (b, h, d) is the split's *unnormalized*
    ``sum_s exp(s - m) v_s``, ``m`` (b, h) its running max and ``l`` (b, h)
    its ``sum_s exp(s - m)``.  ``combine_partials`` folds any number of
    splits into the full softmax output.  A row with no valid entry in the
    split gives ``o = 0``, ``m = NEG_INF``, ``l = 0`` exactly: nothing to
    fold (the all-masked softmax would otherwise weigh every row alike).
    """
    b, h, d = q.shape
    kv = k_cache.shape[2]
    g = h // kv
    scale = _scale(d, scale)
    qg = q.reshape(b, kv, g, d).float() * scale
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None] < lengths[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)  # (b, kv, g)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    empty = (lengths <= 0).reshape(b, 1)
    o = torch.where(empty[..., None], 0.0, o.reshape(b, h, d))
    return o, m.reshape(b, h), torch.where(empty, 0.0, l.reshape(b, h))


def combine_partials(
    os: torch.Tensor,  # (n_splits, b, h, d)
    ms: torch.Tensor,  # (n_splits, b, h)
    ls: torch.Tensor,  # (n_splits, b, h)
    out_dtype: "torch.dtype | None" = None,
) -> torch.Tensor:
    """The softmax output over all splits from their ``(o, m, l)``."""
    m = ms.amax(dim=0)  # (b, h)
    w = torch.exp(ms - m[None])  # (n, b, h)
    l = (ls * w).sum(dim=0)
    o = (os * w[..., None]).sum(dim=0)
    out = o / torch.clamp_min(l, 1e-37)[..., None]
    return out.to(out_dtype or os.dtype)
