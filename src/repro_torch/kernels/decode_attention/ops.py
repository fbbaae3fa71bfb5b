"""Public entry point for decode attention (one token vs a KV cache).

``decode_attention(q, k_cache, v_cache, lengths, *, scale, block_k, impl)``
attends each sequence's one new query token over its own ragged prefix of
a ``(b, s, kv, d)`` cache.  Implementations (``impl``):

* ``"cuda"`` — the hand-written Hopper kernel (``csrc/decode_attention.cu``),
  built with ``nvcc`` at first use and launched through ``ctypes`` on the
  current stream;
* ``"ref"`` — the plain PyTorch version (:mod:`.ref`);
* ``"meta"`` — shapes only, for ``meta`` tensors (the dry run): the
  output's shape and dtype, no arithmetic;
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes the
  plain version, a CUDA tensor the kernel, a meta tensor ``"meta"``.
  There is no fallback: a CUDA tensor the kernel does not take raises.

The kernel (one launch per call) splits each sequence's cache over
several thread blocks (flash-decoding) and folds the split partials in
split order inside the same launch.  :func:`plan` fixes the number of
splits from the shapes alone; each block finds its own rows from the
sequence's length on the card (:func:`split_range`).  ``block_k`` fixes the
rows one split covers instead (its meaning since the first kernel); the
plain version ignores it.

Besides the op, this module carries the KV-*arena* slot helpers used by
continuous batching (``core.serving``): a fixed-capacity cache ``(slots,
max_len, kv, d)`` whose rows are requests' cache residencies.  Slot writes
take out-of-range ids as padding sentinels whose writes drop, so one call
serves any number of admissions.  torch indexing raises on out-of-range
ids and boolean filtering would sync the host, so the helpers mask
explicitly: every index is clamped into range and the dropped writes put
back what was there.  Unlike the reference's functional updates they write
the cache *in place* (and return it), so an arena is never copied.

``decode_attention_partial(q, k_cache, v_cache, lengths, ...)`` (K2p) is
the same kernel, launch and split plan with the fold's state as its
output: each ``(b, h)``'s unnormalised ``o`` and its ``m`` and ``l``, in
f32, the contract of the plain :func:`.ref.decode_attention_partial`
(an empty row gives ``o = 0``, ``m = NEG_INF``, ``l = 0``).  A rank that
holds one block of a cache's sequence runs it on its block, and the ranks'
states combine as :func:`.ref.combine_partials` combines splits
(``distribution/steps.py``).  It dispatches as ``decode_attention`` does.

Under :func:`repro_torch.roofline.op_analysis.analyze` each call records
its work (``op_analysis.decode_attention_work`` over the rows its lengths
select) whichever route runs it.

``decode_attention.launches`` counts kernel launches (one per call that
reaches the kernel, one kernel per launch); nothing else touches it.
``decode_attention_partial.launches`` counts K2p's likewise.  When
a caller sets ``decode_attention.shapes`` to a set, each launch also adds
its ``(b, s, h, kv, d, dtype name)`` to it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels.decode_attention import ref as _ref
from repro_torch.kernels.decode_attention.ref import (
    combine_partials,
    decode_attention_ref,
)
from repro_torch.roofline import op_analysis

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
    "split_range",
    "tile_rows",
    "smem_bytes",
    "kernel_for",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the kernel is built for
MMA_HEAD_DIMS = (64, 128)  # bf16 widths the tensor-core stream takes
MAX_GROUP = 16  # query heads per KV head the kernel takes
ROW_GROUP = 16  # a by-length split covers whole groups of 16 rows
MAX_CLUSTER = 8  # splits the kernel folds within one thread-block cluster
SMEM_PER_SM = 233472  # Hopper: 228 KB of shared memory per SM
_SMEM_RESERVED = 1024  # the runtime's share per resident block
_WARPS, _STAGES, _STEPS = 4, 3, 4  # csrc/decode_attention.cu's ring
_MMA_ROWS = 16  # cache rows per tile of the tensor-core stream

_lib = None
_sm_counts: dict[int, int] = {}
_tickets: dict[int, torch.Tensor] = {}  # device index -> zeroed int32


class Plan(NamedTuple):
    splits: int  # thread blocks per (sequence, KV head)
    fixed_rows: int  # rows per split, or 0: each block's rows by length


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """How the kernel streams a tile: ``"mma"`` (bf16 at d = 64, 128, every
    model's width: the tensor cores, the g heads as the rows of an
    m16n8k16 product) or ``"simt"`` (f32, whose 3e-5 tolerance TF32 would
    break, and bf16 at the other widths: plain FMAs).  Raises for what
    neither takes; a pure function of its arguments."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention kernel takes float32 or "
                        f"bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got d={d}")
    return "mma" if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS else "simt"


def tile_rows(d: int, itemsize: int) -> int:
    """Cache rows one warp stages per ring stage: 16 on the tensor-core
    stream (``csrc/decode_attention.cu::MmaGeo::TR``); on the plain-FMA
    stream (``Geo::WR``) four steps of ``32 / (lanes per row)`` rows, a row
    read in 16-byte chunks by ``d * itemsize / 16`` lanes (at most 32)."""
    if itemsize == 2 and d in MMA_HEAD_DIMS:
        return _MMA_ROWS
    lanes = min(32, d * itemsize // 16)
    return _STEPS * (32 // lanes)


def smem_bytes(d: int, itemsize: int, g: int) -> int:
    """The kernel's shared memory (``csrc/decode_attention.cu::
    smem_bytes``): each warp's 3-stage ring of K and V tiles, then each
    warp's (m, l, acc) for ``g`` heads and the block's folded partial, in
    f32."""
    ring = _WARPS * _STAGES * 2 * tile_rows(d, itemsize) * d * itemsize
    return ring + (_WARPS + 1) * g * (d + 2) * 4


def blocks_per_sm(d: int, itemsize: int, g: int) -> int:
    """Blocks of the kernel one SM holds at once, by shared memory."""
    return max(1, min(16, SMEM_PER_SM // (smem_bytes(d, itemsize, g)
                                          + _SMEM_RESERVED)))


def plan(b: int, kv_heads: int, s: int, *, d: int, itemsize: int, g: int,
         sm_count: int, block_k: "int | None" = None) -> Plan:
    """Launch shape for a ``(b, s, kv, d)`` cache on a card with
    ``sm_count`` multiprocessors: one thread block per (sequence, KV head,
    split).

    The Hopper analogue of the reference's VMEM heuristic
    ``tuned_block_k``.  Rule: as many splits as keep every block of the
    launch resident at once (:func:`blocks_per_sm` x ``sm_count`` blocks
    over all (sequence, KV head) groups: a second wave would wait for the
    first one's whole chain of round trips), but no more splits than the
    capacity ``s`` has groups of 16 rows, nor than one cluster of blocks
    folds (8: the splits of a sequence fold through distributed shared
    memory; more, as a fixed ``block_k`` may give, fold through an int
    ticket and L2).  The plan reads shapes only, never ``lengths`` (they live
    on the card: reading them would sync the host); each block cuts its own
    sequence by length (:func:`split_range`), and the same input always
    folds its splits in the same order.  ``block_k`` fixes the rows per
    split instead, and the splits cover the capacity.
    """
    if min(b, kv_heads, s) < 1:
        raise ValueError("empty decode-attention shape")
    if block_k is not None:
        if block_k < 1:
            raise ValueError("block_k must be >= 1")
        return Plan(-(-s // block_k), block_k)
    want = blocks_per_sm(d, itemsize, g) * sm_count // (b * kv_heads)
    return Plan(max(1, min(want, -(-s // ROW_GROUP), MAX_CLUSTER)), 0)


def split_range(length: int, split: int, p: Plan, s: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of the cache that block ``split`` of a sequence of
    ``length`` valid rows (capacity ``s``) reads under plan ``p``: what the
    kernel's ``split_rows`` computes on the card.  By length, each split
    takes ``ceil(length / splits)`` rows rounded up to whole groups of 16,
    so the splits cover ``[0, length)`` once in equal shares and those past
    the end are empty (``lo == hi``); length 0 reads nothing."""
    n = min(max(length, 0), s)
    if n == 0:
        return 0, 0
    rows = p.fixed_rows or -(-(-(-n // p.splits)) // ROW_GROUP) * ROW_GROUP
    lo = split * rows
    return (lo, min(lo + rows, n)) if lo < n else (n, n)


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load_library

        lib = load_library("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.decode_attention_partial_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else (
        torch.cuda.current_device())


def _sm_count(device: torch.device) -> int:
    idx = _device_index(device)
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _ticket_buffer(device: torch.device, groups: int) -> torch.Tensor:
    """At least ``groups`` zeroed int32 tickets on ``device``, allocated
    once (and again only for more groups); every launch leaves them at 0."""
    idx = _device_index(device)
    buf = _tickets.get(idx)
    if buf is None or buf.numel() < groups:
        buf = _tickets[idx] = torch.zeros(max(groups, 256),
                                          dtype=torch.int32, device=device)
    return buf


def _decode_attention_cuda(q, k_cache, v_cache, lengths, scale, block_k,
                           partial: bool = False):
    """The kernel's launch: the output in q's dtype, or (``partial``,
    K2p) the f32 ``(o, m, l)``."""
    if q.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, q is on {q.device}")
    kernel_for(q.dtype, q.shape[2])  # raises for what neither stream takes
    code = _DTYPE_CODES[q.dtype]
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
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or \
            v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel needs 16-byte aligned "
                         "q and caches")
    if partial:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m, l = (torch.empty((b, h), dtype=torch.float32, device=q.device)
                for _ in range(2))
    else:
        out = torch.empty_like(q)
    p = plan(b, kvh, s, d=d, itemsize=q.element_size(), g=g,
             sm_count=_sm_count(q.device), block_k=block_k)
    part_o = part_ml = tickets = None
    if p.splits > 1:
        part_o = torch.empty((b, kvh, p.splits, g, d), dtype=torch.float32,
                             device=q.device)
        part_ml = torch.empty((b, kvh, p.splits, g, 2), dtype=torch.float32,
                              device=q.device)
        tickets = _ticket_buffer(q.device, b * kvh)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                lengths.data_ptr(), out.data_ptr())
        scratch = (None if part_o is None else part_o.data_ptr(),
                   None if part_ml is None else part_ml.data_ptr(),
                   None if tickets is None else tickets.data_ptr())
        tail = (code, b, s, kvh, g, d, p.splits, p.fixed_rows, float(scale),
                stream)
        if partial:
            err = _library().decode_attention_partial_launch(
                *head, m.data_ptr(), l.data_ptr(), *scratch, *tail)
        else:
            err = _library().decode_attention_launch(*head, *scratch, *tail)
    if err != 0:
        raise RuntimeError(
            f"decode_attention{'_partial' if partial else ''} kernel launch "
            f"failed: cudaError {err}")
    counter = decode_attention_partial if partial else decode_attention
    counter.launches += 1
    if counter.shapes is not None:
        counter.shapes.add(
            (b, s, h, kvh, d, str(q.dtype).removeprefix("torch.")))
    return (out, m, l) if partial else out


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
    return _call(False, q, k_cache, v_cache, lengths, scale, block_k, impl)


decode_attention.launches = 0
decode_attention.shapes = None


def decode_attention_partial(
    q: torch.Tensor,  # (b, h, d)
    k_cache: torch.Tensor,  # (b, s_block, kv, d): one block of the cache
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (b,) int32: valid rows of THIS block
    *,
    scale: "float | None" = None,
    block_k: "int | None" = None,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2p: the flash-decoding state of ``q`` over ``k_cache[i,
    :lengths[i]]``, ``(o (b, h, d), m (b, h), l (b, h))`` in f32 (see the
    module docstring); a ``lengths == 0`` row is ``(0, NEG_INF, 0)``."""
    return _call(True, q, k_cache, v_cache, lengths, scale, block_k, impl)


decode_attention_partial.launches = 0
decode_attention_partial.shapes = None


def _call(partial: bool, q, k_cache, v_cache, lengths, scale, block_k,
          impl: str):
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
        impl = {"cuda": "cuda", "meta": "meta"}.get(q.device.type, "ref")
    if op_analysis.ARMED:
        kvh = k_cache.shape[2]
        work = op_analysis.decode_attention_work(
            b, h, kvh, d, k_cache.element_size(),
            op_analysis.decode_rows(lengths, k_cache.shape[1]),
            partial=partial)
        return op_analysis.kernel_call(
            "decode_attention_partial" if partial else "decode_attention",
            work, _route, partial, q, k_cache, v_cache, lengths, scale,
            block_k, impl)
    return _route(partial, q, k_cache, v_cache, lengths, scale, block_k, impl)


def _route(partial: bool, q, k_cache, v_cache, lengths, scale, block_k,
           impl: str):
    if impl == "ref":
        if partial:
            return _ref.decode_attention_partial(q, k_cache, v_cache, lengths,
                                                 scale=scale)
        return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)
    if impl == "cuda":
        return _decode_attention_cuda(q, k_cache, v_cache, lengths, scale,
                                      block_k, partial)
    if impl == "meta":
        if q.device.type != "meta":
            raise ValueError(f"impl='meta' needs meta tensors, q is on "
                             f"{q.device}")
        if partial:
            return (torch.empty(q.shape, dtype=torch.float32,
                                device=q.device),
                    *(torch.empty(q.shape[:2], dtype=torch.float32,
                                  device=q.device) for _ in range(2)))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    raise ValueError(f"unknown impl {impl!r}")


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
