"""Gradient/update compression for the federated client->cloud path.

The paper's DeviceFlow moves whole model updates; at LM scale the update
payload dominates edge bandwidth.  Two standard distributed-optimization
tricks, both with exact round-trip APIs so DeviceFlow messages can carry
compressed payloads:

* **top-k sparsification with error feedback** — keep the k largest-magnitude
  entries per tensor; the residual is fed back into the next round's update
  (memory of the compressor keeps convergence);
* **int8 quantization** — symmetric per-tensor scaling.

Both are *host transforms* (the tensors may live on the card; the stats come
back in one host sync).  :func:`topk_compress` is the per-message form;
:func:`topk_compress_rows` is its columnar (stacked) form — one per-row
top-k over a whole cohort chunk, so compressed rounds ride the columnar
message plane (``HybridSimulation(payload_transform=...)``).  The fused
wire-level path (``UpdateBuffer(wire="int8")``) lives in ``core.updates``
and ``kernels.fed_reduce``.

The kept set is ``|u + r| >= thresh`` with ``thresh`` the k-th largest
magnitude, so the result does not depend on how ``torch.topk`` orders ties:
kept values, residuals and nonzero counts equal the JAX package's bit for
bit in f32.

Trees are nested dicts (keys in sorted order, as JAX flattens them), lists
and tuples of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

Params = Any


def _leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's order (dict keys sorted; ``None``
    is an empty subtree)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def _unflatten_like(tree: Any, leaves: list) -> Any:
    """A tree of ``tree``'s structure holding ``leaves`` (in
    :func:`_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(tree)


@dataclasses.dataclass(frozen=True)
class TopKState:
    residual: Params  # error-feedback memory


def topk_init(params: Params) -> TopKState:
    return TopKState(residual=_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _keep_topk(uf: torch.Tensor, k: int) -> torch.Tensor:
    """``uf`` with every entry of its last axis below the k-th largest
    magnitude set to 0."""
    mag = uf.abs()
    thresh = torch.topk(mag, k, dim=-1).values[..., -1:]
    return torch.where(mag >= thresh, uf, torch.zeros_like(uf))


def topk_compress(
    update: Params, state: TopKState, *, fraction: float = 0.01
) -> tuple[Params, TopKState, dict]:
    """Returns (sparse update (dense layout, zeros elsewhere), state, stats)."""

    def one(u, r):
        uf = u.to(torch.float32) + r
        k = max(1, int(uf.numel() * fraction))
        kept = _keep_topk(uf.reshape(-1), k).reshape(uf.shape)
        return kept.to(u.dtype), uf - kept

    pairs = [one(u, r) for u, r in zip(_leaves(update),
                                        _leaves(state.residual))]
    leaves = [kept for kept, _ in pairs]
    kept = _unflatten_like(update, leaves)
    resid = _unflatten_like(update, [r for _, r in pairs])
    # One reduction over every leaf and a single host sync for the stats.
    nz = int(sum(torch.count_nonzero(l) for l in leaves))
    total = sum(l.numel() for l in leaves)
    return kept, TopKState(residual=resid), {
        "nonzero": nz, "total": total,
        "compression_ratio": total / max(nz, 1),
    }


def topk_compress_rows(
    stacked: Params, residual: "tuple | None" = None, *,
    fraction: float = 0.01,
) -> tuple[Params, tuple, np.ndarray]:
    """Columnar :func:`topk_compress`: per-row top-k over a *stacked* update
    (leaves shaped ``(rows, ...)``, one row per device).

    Returns ``(kept stacked tree, residual, per-row nonzero counts)``.
    ``residual`` is the error-feedback memory as a tuple of f32
    ``(rows, size)`` tensors — pass the returned tuple back on the same
    chunk's next round (``None`` starts from zero; a residual of another
    layout is dropped and the memory restarts).  The nonzero counts are
    what a sparse encoding ships per row (value + index pairs), i.e. the
    per-row wire size is ``counts * 8``.
    """
    leaves = _leaves(stacked)
    leaves2d = [l.reshape(l.shape[0], -1) for l in leaves]
    if residual is not None and not (
            len(residual) == len(leaves2d)
            and all(tuple(r.shape) == tuple(l.shape)
                    for r, l in zip(residual, leaves2d))):
        residual = None  # layout changed: restart the compressor memory
    kept2d, new_res = [], []
    nnz_rows = None
    for i, leaf in enumerate(leaves2d):
        uf = leaf.to(torch.float32)
        if residual is not None:
            uf = uf + residual[i]
        k = max(1, int(uf.shape[1] * fraction))
        keep = _keep_topk(uf, k)
        kept2d.append(keep.to(leaf.dtype))
        new_res.append(uf - keep)
        nnz = torch.count_nonzero(keep, dim=1)
        nnz_rows = nnz if nnz_rows is None else nnz_rows + nnz
    kept = _unflatten_like(stacked, [k.reshape(l.shape)
                                     for k, l in zip(kept2d, leaves)])
    return kept, tuple(new_res), nnz_rows.cpu().numpy()


def int8_quantize(update: Params) -> tuple[Params, Params]:
    """Returns (int8 tree, per-tensor scales)."""

    def one(u):
        uf = u.to(torch.float32)
        scale = torch.clamp_min(uf.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(uf / scale), -127, 127).to(torch.int8)
        return q, scale

    pairs = [one(u) for u in _leaves(update)]
    return (_unflatten_like(update, [q for q, _ in pairs]),
            _unflatten_like(update, [s for _, s in pairs]))


def int8_dequantize(q: Params, scales: Params, like: Params) -> Params:
    return _map(lambda qq, ss, p: (qq.to(torch.float32) * ss).to(p.dtype),
                q, scales, like)


def payload_bytes(tree: Params) -> int:
    """Wire bytes of a payload tree — what actually crosses the wire.

    A quantized payload is the ``(q, scales)`` *pair*; pass the pair and the
    scale bytes are counted alongside the int8 values.  Python scalars are
    counted at their numpy footprint instead of being dropped.
    """
    total = 0
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif hasattr(x, "size") and hasattr(x, "dtype"):
            total += int(x.size) * np.dtype(x.dtype).itemsize
        else:
            total += np.asarray(x).nbytes
    return total
