"""Public entry point for decode attention (one token vs a KV cache).

``decode_attention(q, k_cache, v_cache, lengths, *, scale, block_k, impl)``
attends each sequence's one new query token over its own ragged prefix of
a ``(b, s, kv, d)`` cache.  Implementations (``impl``):

* ``"cuda"`` — the hand-written Hopper kernel (``csrc/decode_attention.cu``),
  built with ``nvcc`` at first use and launched through ``ctypes`` on the
  current stream;
* ``"ref"`` — the plain PyTorch version (:mod:`.ref`);
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes the
  plain version, a CUDA tensor the kernel.  There is no fallback: a CUDA
  tensor the kernel does not take raises.

The kernel splits each sequence's cache over several thread blocks
(flash-decoding) and combines the split partials in split order, so
``block_k`` here is the number of cache rows one split covers; ``None``
takes :func:`plan`'s choice.  The plain version ignores it.

Besides the op, this module carries the KV-*arena* slot helpers used by
continuous batching (``core.serving``): a fixed-capacity cache ``(slots,
max_len, kv, d)`` whose rows are requests' cache residencies.  Slot writes
take out-of-range ids as padding sentinels whose writes drop, so one call
serves any number of admissions.  torch indexing raises on out-of-range
ids and boolean filtering would sync the host, so the helpers mask
explicitly: every index is clamped into range and the dropped writes put
back what was there.  Unlike the reference's functional updates they write
the cache *in place* (and return it), so an arena is never copied.

``decode_attention.launches`` counts kernel launches (one per call that
reaches the kernel); nothing else touches it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.decode_attention.ref import (
    combine_partials,
    decode_attention_partial,
    decode_attention_ref,
)

__all__ = [
    "decode_attention",
    "decode_attention_partial",
    "combine_partials",
    "decode_attention_ref",
    "scatter_prefill_rows",
    "scatter_decode_token",
    "gather_slots",
    "slot_sources",
    "plan",
    "tile_rows",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the kernel is built for
MAX_GROUP = 16  # query heads per KV head the kernel takes
_TILE_BYTES = 32 * 1024  # one K tile plus one V tile in shared memory
_MAX_TILE = 64
_CTAS_PER_SM = 4

_lib = None
_sm_counts: dict[int, int] = {}


def tile_rows(d: int, itemsize: int) -> int:
    """Cache rows the kernel stages per step: the largest power of two up to
    64 whose K and V tiles fit in 32 KiB (64 for bf16 at d <= 128)."""
    t = _MAX_TILE
    while t > 1 and 2 * t * d * itemsize > _TILE_BYTES:
        t //= 2
    return t


def plan(b: int, kv_heads: int, s: int, d: int, itemsize: int, *,
         sm_count: int, block_k: "int | None" = None
         ) -> tuple[int, int, int]:
    """Launch shape ``(tile, rows_per_split, splits)`` for a ``(b, s, kv,
    d)`` cache on a card with ``sm_count`` multiprocessors.

    The Hopper analogue of the reference's VMEM heuristic
    ``tuned_block_k``.  Rule: one thread block per (sequence, KV head,
    split); split the cache capacity ``s`` until about four blocks run per
    SM, but never below one tile of rows per split; round each split up to
    whole tiles.  The plan reads shapes only — never ``lengths``, which live
    on the card — so it needs no host sync, and the same input always
    combines its splits in the same order.  ``block_k`` fixes the rows per
    split instead.
    """
    if min(b, kv_heads, s, d) < 1:
        raise ValueError("empty decode-attention shape")
    tile = tile_rows(d, itemsize)
    if block_k is None:
        want = -(-_CTAS_PER_SM * sm_count // (b * kv_heads))
        splits = max(1, min(want, -(-s // tile)))
        rows = -(-(-(-s // splits)) // tile) * tile
    else:
        if block_k < 1:
            raise ValueError("block_k must be >= 1")
        rows = block_k
    return tile, rows, -(-s // rows)


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load_library

        lib = load_library("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _decode_attention_cuda(q, k_cache, v_cache, lengths, scale, block_k):
    if q.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, q is on {q.device}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention kernel needs a contiguous "
                             f"{name}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    b, h, d = q.shape
    _, s, kvh, _ = k_cache.shape
    g = h // kvh
    if d not in HEAD_DIMS or g > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"per KV head, got d={d}, g={g}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel needs 16-byte aligned "
                         "caches")
    out = torch.empty_like(q)
    tile, rows, splits = plan(b, kvh, s, d, q.element_size(),
                              sm_count=_sm_count(q.device), block_k=block_k)
    part_o = part_ml = None
    if splits > 1:
        part_o = torch.empty((b, kvh, splits, g, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((b, kvh, splits, g, 2), dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if part_o is None else part_o.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            code, b, s, kvh, g, d, rows, splits, float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention kernel launch failed: cudaError {err}")
    decode_attention.launches += 1
    return out


def decode_attention(
    q: torch.Tensor,  # (b, h, d)
    k_cache: torch.Tensor,  # (b, s, kv, d)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (b,) int32
    *,
    scale: "float | None" = None,
    block_k: "int | None" = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Softmax attention of ``q`` over ``k_cache[i, :lengths[i]]`` ->
    ``(b, h, d)`` in q's dtype; a ``lengths == 0`` row is exact zeros."""
    b, h, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if h % k_cache.shape[2]:
        raise ValueError("q heads must be a multiple of kv heads")
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be ({b},)")
    scale = (d ** -0.5) if scale is None else scale
    if impl == "auto":
        impl = "cuda" if q.device.type == "cuda" else "ref"
    if impl == "ref":
        return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)
    if impl == "cuda":
        return _decode_attention_cuda(q, k_cache, v_cache, lengths, scale,
                                      block_k)
    raise ValueError(f"unknown impl {impl!r}")


decode_attention.launches = 0


# --------------------------------------------------------------------------- #
# KV-arena slot paths (continuous batching)
# --------------------------------------------------------------------------- #
def slot_sources(slot_ids: torch.Tensor, slots: int) -> torch.Tensor:
    """For each of ``slots`` slots, the index ``i`` of the ``slot_ids``
    entry that targets it, or -1: the inverse of a scatter, computed on the
    ids' device without a host sync.  Ids outside ``[0, slots)`` are
    padding and target nothing."""
    m = slot_ids.shape[0]
    ids = slot_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < slots)
    target = torch.where(valid, ids, slots)  # padding -> a spare entry
    src = torch.full((slots + 1,), -1, dtype=torch.int64,
                     device=slot_ids.device)
    src.scatter_(0, target, torch.arange(m, device=slot_ids.device))
    return src[:slots]


def scatter_prefill_rows(cache: torch.Tensor, rows: torch.Tensor,
                         slot_ids: torch.Tensor) -> torch.Tensor:
    """Write freshly prefilled K/V rows into their arena slots, in place.

    ``cache`` is ``(slots, max_len, kv, d)``; ``rows`` is ``(m, s, kv, d)``
    with ``s <= max_len``; ``slot_ids`` is ``(m,)``.  Entries with
    ``slot_ids[i] >= slots`` are padding: their writes drop.  Rows
    ``[s:max_len)`` of a reused slot keep the previous occupant's stale
    K/V; they are dead by construction because the slot's length counter is
    reset to ``s``.  Returns ``cache``.
    """
    slots, s = cache.shape[0], rows.shape[1]
    src = slot_sources(slot_ids, slots)
    picked = rows.index_select(0, src.clamp_min(0)).to(cache.dtype)
    head = cache[:, :s]
    head.copy_(torch.where((src >= 0)[:, None, None, None], picked, head))
    return cache


def scatter_decode_token(cache: torch.Tensor, kv_tok: torch.Tensor,
                         write_pos: torch.Tensor) -> torch.Tensor:
    """Write one decoded token's K/V at each slot's own position, in place.

    ``cache`` is ``(slots, max_len, kv, d)``; ``kv_tok`` is ``(slots, kv,
    d)``; ``write_pos`` is ``(slots,)`` — per-slot ragged positions.
    Inactive slots pass ``write_pos >= max_len`` and their writes drop (the
    clamped position gets its own value back).  Returns ``cache``.
    """
    slots, max_len = cache.shape[0], cache.shape[1]
    pos = write_pos.to(torch.int64)
    valid = (pos >= 0) & (pos < max_len)
    pos = pos.clamp(0, max_len - 1)
    idx = torch.arange(slots, device=cache.device)
    old = cache[idx, pos]
    cache[idx, pos] = torch.where(valid[:, None, None],
                                  kv_tok.to(cache.dtype), old)
    return cache


def gather_slots(cache: torch.Tensor, slot_ids: torch.Tensor) -> torch.Tensor:
    """Gather ``(m, max_len, kv, d)`` slot rows (e.g. to migrate or inspect a
    request's cache residency); out-of-range ids fill with zeros."""
    slots = cache.shape[0]
    ids = slot_ids.to(torch.int64)
    valid = (ids >= 0) & (ids < slots)
    out = cache.index_select(0, ids.clamp(0, slots - 1))
    return torch.where(valid[:, None, None, None], out,
                       torch.zeros((), dtype=cache.dtype, device=cache.device))
