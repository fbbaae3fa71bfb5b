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
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes
  ``"chunked"``, a CUDA tensor the kernel.  There is no fallback: a CUDA
  tensor the kernel does not take raises.

The kernel has no backward: LM training (ROADMAP P12) adds one.

``flash_attention.launches`` counts kernel launches of either kernel (one
per call that reaches a kernel), ``flash_attention.wgmma_launches`` those
of the tensor-core kernel alone; nothing else touches them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import (
    attention_chunked,
    attention_ref,
)

__all__ = ["flash_attention", "attention_chunked", "attention_ref",
           "kernel_for", "HEAD_DIMS", "WGMMA_HEAD_DIMS", "TILE"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the kernels are built for
WGMMA_HEAD_DIMS = (64, 128)  # bf16 widths the tensor-core kernel takes
TILE = (64, 64)  # the kernels' (query rows, keys) per warpgroup step

_lib = None


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load_library

        lib = load_library("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.flash_attention_wgmma_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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


def _flash_attention_cuda(q, k, v, causal, q_offset, scale, kernel=None):
    """Launches ``kernel`` (by default ``kernel_for(q.dtype, d)``; the
    smoke names ``"simt"`` to time the plain-FMA kernel on bf16)."""
    if q.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, q is on {q.device}")
    b, sq, h, d = q.shape
    route = kernel_for(q.dtype, d)
    kernel = route if kernel is None else kernel
    if kernel not in (route, "simt"):
        raise ValueError(f"the {kernel!r} kernel does not take {q.dtype} at "
                         f"head_dim {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    sk, kvh = k.shape[1], k.shape[2]
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
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
    return out


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
        impl = "cuda" if q.device.type == "cuda" else "chunked"
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
    raise ValueError(f"unknown impl {impl!r}")


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
