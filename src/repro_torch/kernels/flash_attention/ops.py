"""Public entry point for flash attention (GQA, causal with a query offset).

``flash_attention(q, k, v, *, causal, q_offset, scale, block_q, block_k,
impl)``: q ``(b, sq, h, d)``, k/v ``(b, sk, kv, d)`` -> ``(b, sq, h, d)``.
Implementations (``impl``):

* ``"cuda"`` — the hand-written Hopper kernels (``csrc/flash_attention.cu``,
  forward only), built with ``nvcc`` at first use and launched through
  ``ctypes`` on the current stream.  :func:`kernel_for` picks one by dtype
  and head width before the launch: bf16 at d = 64 or 128 (every published
  config's width) runs on the tensor cores (``"wgmma"``: wgmma with TMA
  loads), f32 and the other widths on plain FMAs (``"simt"``; f32 on tensor
  cores would be TF32, outside the f32 tolerance).  Their tiles are their
  own (64 query rows per warpgroup x 64 keys); ``block_q`` and
  ``block_k`` shape the plain version only, and passing them with
  ``impl="cuda"`` raises;
* ``"chunked"`` — the plain online-softmax version (:mod:`.ref`) in
  ``block_q x block_k`` chunks (default: all of sq x 1024 keys, the
  reference's lowerable path);
* ``"ref"`` — the plain O(S^2) oracle;
* ``"meta"`` — shapes only, for ``meta`` tensors (the dry run): the
  output's shape and dtype, no arithmetic;
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes
  ``"chunked"``, a CUDA tensor the kernel, a meta tensor ``"meta"``.
  There is no fallback: a CUDA tensor the kernel does not take raises.

Training goes through :class:`FlashAttention`, a ``torch.autograd.Function``
(``setup_context`` style, with a ``vmap`` rule, so ``torch.func``'s
``vmap(grad(...))`` of a model runs it).  Its forward is the kernel above
asked also for each row's log-sum-exp; its backward is the hand-written
backward (``csrc/flash_attention.cu``) for CUDA tensors, chosen by
:func:`kernel_for_bwd`, ``attention_bwd_ref`` for CPU tensors and empty
gradients of the right shapes for meta tensors.  There is no fallback
between them.  bf16 at d = 64, 128 runs on ``wgmma`` with
TMA: a prep pass, one kernel for dK, dV and dQ (dQ's partials summed
across key tiles in a fixed order) and a pass that casts dQ; everything
else runs a dK/dV kernel and a dQ kernel on plain FMAs.

Under :func:`repro_torch.roofline.op_analysis.analyze` each forward
(``"flash_attention"``) and backward (``"flash_attention_bwd"``) call
records its work (``op_analysis.flash_attention_work``,
``flash_attention_bwd_work``) whichever route runs it.

``flash_attention.launches`` counts kernel launches of either forward
kernel (one per call that reaches a kernel),
``flash_attention.wgmma_launches`` those of the tensor-core kernel alone,
and ``flash_attention.bwd_launches`` the backward's calls (one per
backward, its three kernels together), ``flash_attention.wgmma_bwd_launches``
those on ``wgmma``; nothing else touches them.  When a
caller sets ``flash_attention.shapes`` (``bwd_shapes``) to a set, each
forward (backward) launch also adds its ``(b, sq, sk, h, kv, d, causal,
q_offset, dtype name)`` to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_chunked,
    attention_fwd_lse,
    attention_ref,
)
from repro_torch.roofline import op_analysis

__all__ = ["flash_attention", "FlashAttention", "attention_chunked",
           "attention_ref", "attention_fwd_lse", "attention_bwd_ref",
           "kernel_for", "kernel_for_bwd", "HEAD_DIMS", "BWD_HEAD_DIMS",
           "WGMMA_HEAD_DIMS", "TILE", "BWD_ROWS", "bwd_rows"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the kernels are built for
WGMMA_HEAD_DIMS = (64, 128)  # bf16 widths the tensor-core kernel takes
BWD_HEAD_DIMS = (16, 32, 64, 128)  # head widths the backward is built for
TILE = (64, 64)  # the kernels' (query rows, keys) per warpgroup step
# The Hopper backward's row tile (wg_bwd::ROWS in csrc/flash_attention.cu):
# its lse, D and turn-counter scratch is padded to it, and the launch
# refuses a padding that does not match its own.
BWD_ROWS = 64

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load_library

        lib = load_library("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.flash_attention_wgmma_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.flash_attention_bwd_wgmma_launch
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def bwd_rows(sq: int) -> int:
    """The rows the Hopper backward's scratch holds for ``sq`` query rows:
    ``sq`` rounded up to ``BWD_ROWS``, the padded length the launch is
    given and checks against its own tile."""
    return -(-sq // BWD_ROWS) * BWD_ROWS


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call with this dtype and head width launches:
    ``"wgmma"`` (bf16 at d in ``WGMMA_HEAD_DIMS``, tensor cores) or
    ``"simt"`` (f32 at any of ``HEAD_DIMS``, bf16 at the others).  Raises
    for what neither takes; a pure function of its arguments."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def kernel_for_bwd(dtype: torch.dtype, d: int) -> str:
    """The backward kernels a CUDA call with this dtype and head width
    launches: ``"wgmma"`` (bf16 at d in ``WGMMA_HEAD_DIMS``: ``wgmma`` and
    TMA on the tensor cores) or ``"simt"`` (f32 at any of ``BWD_HEAD_DIMS``,
    bf16 at the others: plain FMAs; f32 on tensor cores would be TF32).
    Raises for what neither takes; a pure function of its arguments."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention backward takes float32 or "
                        f"bfloat16, got {dtype}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward takes head_dim in "
                         f"{BWD_HEAD_DIMS}, got {d}")
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def _check_operands(q, named):
    for name, t in named:
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel needs a contiguous "
                             f"{name}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs a 16-byte "
                             f"aligned {name}")


def _shape_key(q, k, causal, q_offset):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, bool(causal), int(q_offset),
            str(q.dtype).removeprefix("torch."))


def _flash_attention_cuda(q, k, v, causal, q_offset, scale, kernel=None, *,
                          with_lse=False):
    """Launches ``kernel`` (by default ``kernel_for(q.dtype, d)``; the
    smoke names ``"simt"`` to time the plain-FMA kernel on bf16).  With
    ``with_lse`` returns ``(out, lse)``, lse ``(b, h, sq)`` f32."""
    if q.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, q is on {q.device}")
    b, sq, h, d = q.shape
    route = kernel_for(q.dtype, d)
    kernel = route if kernel is None else kernel
    if kernel not in (route, "simt"):
        raise ValueError(f"the {kernel!r} kernel does not take {q.dtype} at "
                         f"head_dim {d}")
    _check_operands(q, (("q", q), ("k", k), ("v", v)))
    sk, kvh = k.shape[1], k.shape[2]
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr())
        shape = (b, sq, sk, h, kvh, d, int(bool(causal)), int(q_offset),
                 float(scale), stream)
        lib = _library()
        if kernel == "wgmma":
            err = lib.flash_attention_wgmma_launch(*args, *shape)
        else:
            err = lib.flash_attention_launch(*args, _DTYPE_CODES[q.dtype],
                                             *shape)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    if kernel == "wgmma":
        flash_attention.wgmma_launches += 1
    if flash_attention.shapes is not None:
        flash_attention.shapes.add(_shape_key(q, k, causal, q_offset))
    return (out, lse) if with_lse else out


def _flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, q_offset, scale,
                              kernel=None):
    """The backward kernels on CUDA tensors: ``(dq, dk, dv)``; ``kernel``
    (by default ``kernel_for_bwd(q.dtype, d)``; the smoke names ``"simt"``
    to time the plain-FMA kernels on bf16)."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernel needs CUDA tensors, q is on "
                         f"{q.device}")
    b, sq, h, d = q.shape
    route = kernel_for_bwd(q.dtype, d)
    kernel = route if kernel is None else kernel
    if kernel not in (route, "simt"):
        raise ValueError(f"the {kernel!r} backward does not take {q.dtype} "
                         f"at head_dim {d}")
    _check_operands(q, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 (b, h, sq) = "
                         f"{(b, h, sq)} tensor on {q.device}")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    sk, kvh = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # Scratch: D = rowsum(dO * O) per row; the wgmma kernels also take
    # q * scale in bf16 and lse * log2(e), with D and lse padded to
    # BWD_ROWS-row tiles, dQ's f32 sum and a turn counter per tile.
    wgmma = kernel == "wgmma"
    rows = bwd_rows(sq) if wgmma else sq
    delta = torch.empty((b, h, rows), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr())
        shape = (b, sq, sk, h, kvh, d, int(bool(causal)), int(q_offset),
                 float(scale), stream)
        if wgmma:
            qs, lse2 = torch.empty_like(q), torch.empty_like(delta)
            acc = torch.empty((b, h, rows, d), dtype=torch.float32,
                              device=q.device)
            turns = torch.empty((b, h, rows // BWD_ROWS), dtype=torch.int32,
                                device=q.device)
            err = _library().flash_attention_bwd_wgmma_launch(
                *ptrs, qs.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                acc.data_ptr(), turns.data_ptr(), rows, *shape)
        else:
            err = _library().flash_attention_bwd_launch(
                *ptrs, delta.data_ptr(), _DTYPE_CODES[q.dtype], *shape)
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} backward launch "
                           f"failed: cudaError {err}")
    flash_attention.bwd_launches += 1
    if wgmma:
        flash_attention.wgmma_bwd_launches += 1
    if flash_attention.bwd_shapes is not None:
        flash_attention.bwd_shapes.add(_shape_key(q, k, causal, q_offset))
    return dq, dk, dv


def _fold(x, dim, batch):
    """A vmapped operand with its vmapped dimension ``dim`` (``None``:
    unbatched, expanded) folded into its leading dimension."""
    x = x.expand(batch, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(batch * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x, batch):
    return x.reshape(batch, x.shape[0] // batch, *x.shape[1:])


def _work(q, k, causal, q_offset, *, lse=False) -> "op_analysis.Work":
    b, sq, h, d = q.shape
    return op_analysis.flash_attention_work(
        b, sq, k.shape[1], h, k.shape[2], d, q.element_size(), causal,
        q_offset, lse)


def _contiguous(tensors):
    """The plain versions' outputs in the kernels' layout (contiguous), so
    that what follows a call runs the same ops on every device."""
    return tuple(t.contiguous() for t in tensors)


def _forward_lse(q, k, v, causal, q_offset, scale):
    """``(o, lse)`` on the route of q's device: the kernel (CUDA), empty
    tensors of the right shapes (meta) or the plain version (CPU)."""
    if q.device.type == "cuda":
        return _flash_attention_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal, q_offset,
                                     scale, with_lse=True)
    if q.device.type == "meta":
        b, sq, h, _ = q.shape
        return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
                torch.empty((b, h, sq), dtype=torch.float32,
                            device=q.device))
    return _contiguous(attention_fwd_lse(q, k, v, causal=causal,
                                         q_offset=q_offset, scale=scale))


def _backward(q, k, v, o, lse, do, causal, q_offset, scale):
    """``(dq, dk, dv)`` on the route of q's device, as :func:`_forward_lse`
    picks it."""
    if q.device.type == "cuda":
        return _flash_attention_bwd_cuda(
            *(t.contiguous() for t in (q, k, v, o, lse, do)), causal,
            q_offset, scale)
    if q.device.type == "meta":
        return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                     for t in (q, k, v))
    return _contiguous(attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                         q_offset=q_offset, scale=scale))


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``FlashAttention.apply(q, k, v,
    causal, q_offset, scale)`` -> ``(o, lse)`` (lse ``(b, h, sq)`` f32, not
    differentiable).  CUDA tensors run the forward kernel and, in the
    backward, the backward kernel (or raise); CPU tensors the plain
    versions.  Under ``torch.func.vmap`` the vmapped dimension is folded
    into the batch (a ctypes launch cannot be vmapped any other way)."""

    @staticmethod
    def forward(q, k, v, causal, q_offset, scale):
        if op_analysis.ARMED:
            return op_analysis.kernel_call(
                "flash_attention", _work(q, k, causal, q_offset, lse=True),
                _forward_lse, q, k, v, causal, q_offset, scale)
        return _forward_lse(q, k, v, causal, q_offset, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, q_offset, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, q_offset, scale)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBackward.apply(q, k, v, o, lse, do,
                                                   *ctx.args)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, q_offset, scale):
        n = info.batch_size
        o, lse = FlashAttention.apply(
            *(_fold(x, d, n) for x, d in zip((q, k, v), in_dims)),
            causal, q_offset, scale)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionBackward(torch.autograd.Function):
    """``FlashAttention``'s backward as a function of its own, so that
    ``torch.func`` can vmap it (the backward of ``vmap(grad(...))`` runs on
    vmapped tensors).  It has no backward itself."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, q_offset, scale):
        if op_analysis.ARMED:
            b, sq, h, d = q.shape
            work = op_analysis.flash_attention_bwd_work(
                b, sq, k.shape[1], h, k.shape[2], d, q.element_size(),
                causal, q_offset)
            return op_analysis.kernel_call(
                "flash_attention_bwd", work, _backward, q, k, v, o, lse, do,
                causal, q_offset, scale)
        return _backward(q, k, v, o, lse, do, causal, q_offset, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, q_offset, scale):
        n = info.batch_size
        grads = _FlashAttentionBackward.apply(
            *(_fold(x, d, n) for x, d in zip((q, k, v, o, lse, do), in_dims)),
            causal, q_offset, scale)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    scale: "float | None" = None,
    block_q: "int | None" = None,
    block_k: "int | None" = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Multi-head/GQA attention: q (b,sq,h,d), k/v (b,sk,kv,d) -> (b,sq,h,d)."""
    b, sq, h, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError("q heads must be a multiple of kv heads")
    scale = (d ** -0.5) if scale is None else scale
    if impl == "auto":
        impl = {"cuda": "cuda", "meta": "meta"}.get(q.device.type, "chunked")
    if op_analysis.ARMED:
        return op_analysis.kernel_call(
            "flash_attention", _work(q, k, causal, q_offset), _route, q, k,
            v, causal, q_offset, scale, block_q, block_k, impl)
    return _route(q, k, v, causal, q_offset, scale, block_q, block_k, impl)


def _route(q, k, v, causal, q_offset, scale, block_q, block_k, impl: str):
    sq = q.shape[1]
    if impl == "cuda":
        if block_q is not None or block_k is not None:
            raise ValueError(f"the kernel's tile is fixed at {TILE}; "
                             "block_q/block_k shape the plain version only")
        return _flash_attention_cuda(q, k, v, causal, q_offset, scale)
    if impl == "chunked":
        return attention_chunked(
            q, k, v, causal=causal, q_offset=q_offset, scale=scale,
            q_chunk=block_q or sq, kv_chunk=block_k or 1024)
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                             scale=scale)
    if impl == "meta":
        if q.device.type != "meta":
            raise ValueError(f"impl='meta' needs meta tensors, q is on "
                             f"{q.device}")
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    raise ValueError(f"unknown impl {impl!r}")


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.bwd_launches = 0
flash_attention.wgmma_bwd_launches = 0
flash_attention.shapes = None
flash_attention.bwd_shapes = None
