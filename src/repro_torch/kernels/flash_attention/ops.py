"""Public entry point for flash attention (GQA, causal with a query offset).

``flash_attention(q, k, v, *, causal, q_offset, scale, block_q, block_k,
impl)``: q ``(b, sq, h, d)``, k/v ``(b, sk, kv, d)`` -> ``(b, sq, h, d)``.
Implementations (``impl``):

* ``"cuda"`` — the hand-written Hopper kernel (``csrc/flash_attention.cu``,
  forward only), built with ``nvcc`` at first use and launched through
  ``ctypes`` on the current stream.  Its tiles are its own (64 query rows x
  64 keys); ``block_q``/``block_k`` shape the plain version only, and
  passing them with ``impl="cuda"`` raises;
* ``"chunked"`` — the plain online-softmax version (:mod:`.ref`) in
  ``block_q x block_k`` chunks (default: all of sq x 1024 keys, the
  reference's lowerable path);
* ``"ref"`` — the plain O(S^2) oracle;
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes
  ``"chunked"``, a CUDA tensor the kernel.  There is no fallback: a CUDA
  tensor the kernel does not take raises.

The kernel has no backward: LM training (ROADMAP P12) adds one.

``flash_attention.launches`` counts kernel launches (one per call that
reaches the kernel); nothing else touches it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention.ref import (
    attention_chunked,
    attention_ref,
)

__all__ = ["flash_attention", "attention_chunked", "attention_ref",
           "HEAD_DIMS", "TILE"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the kernel is built for
TILE = (64, 64)  # the kernel's (query rows, keys) per block step

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
        _lib = lib
    return _lib


def _flash_attention_cuda(q, k, v, causal, q_offset, scale):
    if q.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, q is on {q.device}")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
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
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
            b, sq, sk, h, kvh, d, int(bool(causal)), int(q_offset),
            float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
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
