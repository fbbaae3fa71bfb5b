"""Public entry point for the Mamba2 SSD scan.

``ssd_scan(x, dt, A, B, C, *, chunk, impl)``: x ``(b, l, h, p)``, dt
``(b, l, h)``, A ``(h,)``, B/C ``(b, l, g, n)`` -> ``(y (b, l, h, p),
final_state (b, h, p, n) f32)``.  Implementations (``impl``):

* ``"cuda"`` — the hand-written Hopper kernels (``csrc/ssd_scan.cu``), built
  with ``nvcc`` at first use and launched through ``ctypes`` on the current
  stream.  They take x, B and C in one dtype (float32 or bfloat16), dt and
  A in float32, all contiguous.  :func:`kernel_for` picks one before the
  launch: bf16 at the model shapes (p = 64, n in {64, 128}, chunk 64 or
  128) runs on the tensor cores (``"tc"``: wgmma with TMA loads), the rest
  on plain f32 FMAs (``"simt"``: p <= 64, n <= 128, chunk <= 128 within its
  shared-memory footprint, :func:`smem_bytes`); anything else raises;
* ``"chunked"`` — the plain chunked version (:mod:`.ref`);
* ``"ref"`` — the plain sequential oracle;
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes
  ``"chunked"``, a CUDA tensor the kernel.  There is no fallback: a CUDA
  tensor the kernel does not take raises.

A length that is not a multiple of the chunk is padded with ``dt = 0``
identity steps (decay exp(0) = 1, no input), and y is cut back, as the
reference does.  ``ssd_decode_step`` (one token) stays a plain torch op: the
reference has no kernel for it.

``ssd_scan.launches`` counts kernel launches of either kernel (one per call
that reaches a kernel), ``ssd_scan.tc_launches`` those of the tensor-core
kernel alone; nothing else touches them.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ref import (
    ssd_chunked,
    ssd_decode_step,
    ssd_ref,
)

__all__ = ["ssd_scan", "ssd_decode_step", "ssd_ref", "ssd_chunked",
           "smem_bytes", "tc_smem_bytes", "kernel_takes", "kernel_for"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
SMEM_LIMIT = 232448  # Hopper's opt-in shared memory per block
_ROWS = 32  # rows of the intra-chunk matrix the kernel builds per tile
TC_HEAD_DIM, TC_STATES, TC_CHUNKS = 64, (64, 128), (64, 128)

_lib = None


def smem_bytes(q: int, p: int, n: int) -> int:
    """The kernel's shared memory for chunk q, head dim p, state dim n
    (``csrc/ssd_scan.cu::smem_floats``): x, B^T, C^T, S^T, one row tile of
    the intra-chunk matrix and four per-step vectors, in f32."""
    return 4 * (q * p + 2 * n * (q | 1) + n * (p | 1) + _ROWS * (q | 1)
                + 4 * q)


def kernel_takes(q: int, p: int, n: int) -> bool:
    """Whether the kernel takes chunk q, head dim p and state dim n."""
    return (1 <= q <= MAX_CHUNK and 1 <= p <= MAX_HEAD_DIM
            and 1 <= n <= MAX_STATE and smem_bytes(q, p, n) <= SMEM_LIMIT)


def tc_smem_bytes(q: int, n: int) -> int:
    """The tensor-core kernel's shared memory for chunk q and state n
    (``csrc/ssd_scan.cu::tc::Layout``): bf16 tiles of C and B (q x n),
    x and its split w x for two heads (2 x 2 x q x 64), the bf16 state of
    two heads (2 x 64 x n), four per-step vectors of two heads in f32, an
    mbarrier and 1 KB of alignment slack."""
    return (2 * q * n * 2 + 4 * q * 64 * 2 + 2 * 64 * n * 2
            + 4 * 2 * q * 4 + 8 + 1024)


def kernel_for(dtype: torch.dtype, p: int, n: int, q: int) -> str:
    """The kernel a CUDA call with this dtype, head dim p, state n and
    chunk q launches: ``"tc"`` (bf16 at p = 64, n in (64, 128), q in (64,
    128): the models' shapes, tensor cores) or ``"simt"`` (f32, and bf16
    elsewhere, within :func:`kernel_takes`; f32 on tensor cores would be
    TF32, outside the f32 tolerance).  Raises for what neither takes; a
    pure function of its arguments."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan kernel takes x, B and C as float32 or "
                        f"bfloat16, got {dtype}")
    if (dtype == torch.bfloat16 and p == TC_HEAD_DIM and n in TC_STATES
            and q in TC_CHUNKS):
        return "tc"
    if kernel_takes(q, p, n):
        return "simt"
    raise ValueError(
        f"ssd_scan kernel takes chunk <= {MAX_CHUNK}, head dim <= "
        f"{MAX_HEAD_DIM} and state <= {MAX_STATE} within {SMEM_LIMIT} bytes "
        f"of shared memory; chunk {q}, p {p}, n {n} need "
        f"{smem_bytes(q, p, n)}")


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load_library

        lib = load_library("ssd_scan")
        fn = lib.ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.ssd_scan_tc_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(x, dt, A, B, C, chunk) -> str:
    """The kernel that takes these tensors as they are (it never copies a
    strided or mistyped tensor into shape); raises if none does."""
    if x.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, x is on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan kernel takes x, B and C as float32 or "
                        f"bfloat16, got {x.dtype}")
    for name, t, want in (("x", x, x.dtype), ("dt", dt, torch.float32),
                          ("A", A, torch.float32), ("B", B, x.dtype),
                          ("C", C, x.dtype)):
        if t.dtype != want:
            raise TypeError(f"ssd_scan kernel takes {name} as {want}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel needs a contiguous {name}")
    kernel = kernel_for(x.dtype, x.shape[3], B.shape[3], chunk)
    if kernel == "tc" and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("the tensor-core ssd_scan kernel needs 16-byte "
                         "aligned x, B and C")
    return kernel


def _ssd_scan_cuda(x, dt, A, B, C, chunk, kernel=None):
    """Launch ``kernel`` (by default :func:`kernel_for`'s; the smoke names
    ``"simt"`` to time the plain-FMA kernel on bf16) on tensors
    :func:`_check_cuda` passed."""
    route = kernel_for(x.dtype, x.shape[3], B.shape[3], chunk)
    kernel = route if kernel is None else kernel
    if kernel not in (route, "simt") or (
            kernel == "simt" and not kernel_takes(chunk, x.shape[3],
                                                  B.shape[3])):
        raise ValueError(f"the {kernel!r} ssd_scan kernel does not take "
                         f"{x.dtype} at p {x.shape[3]}, n {B.shape[3]}, "
                         f"chunk {chunk}")
    code = _DTYPE_CODES[x.dtype]
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(), state.data_ptr())
        if kernel == "tc":
            err = _library().ssd_scan_tc_launch(*ptrs, b, l, h, p, g, n,
                                                chunk, stream)
        else:
            err = _library().ssd_scan_launch(*ptrs, code, b, l, h, p, g, n,
                                             chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan {kernel} kernel launch failed: "
                           f"cudaError {err}")
    ssd_scan.launches += 1
    if kernel == "tc":
        ssd_scan.tc_launches += 1
    return y, state


def ssd_scan(
    x: torch.Tensor,  # (b, l, h, p)
    dt: torch.Tensor,  # (b, l, h) positive
    A: torch.Tensor,  # (h,) negative
    B: torch.Tensor,  # (b, l, g, n)
    C: torch.Tensor,  # (b, l, g, n)
    *,
    chunk: int = 64,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (b,l,h,p), final_state (b,h,p,n))."""
    b, l, h, p = x.shape
    if (dt.shape != (b, l, h) or A.shape != (h,) or B.ndim != 4
            or B.shape[:2] != (b, l) or C.shape != B.shape
            or h % B.shape[2]):
        raise ValueError(
            f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, "
            f"C {tuple(C.shape)} do not fit x {tuple(x.shape)}")
    if impl == "auto":
        impl = "cuda" if x.device.type == "cuda" else "chunked"
    chunk = min(chunk, l)
    if impl == "cuda":
        _check_cuda(x, dt, A, B, C, chunk)  # before any padding copies
    if l % chunk:
        # Pad to a chunk multiple with identity steps: dt=0 gives decay
        # exp(0)=1 and zero input contribution, so y/state are exact.
        pad = chunk - l % chunk

        def padt(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        y, s = ssd_scan(padt(x), padt(dt), A, padt(B), padt(C),
                        chunk=chunk, impl=impl)
        return y[:, :l], s
    if impl == "cuda":
        return _ssd_scan_cuda(x, dt, A, B, C, chunk)
    if impl == "chunked":
        return ssd_chunked(x, dt, A, B, C, chunk=chunk)
    if impl == "ref":
        return ssd_ref(x, dt, A, B, C)
    raise ValueError(f"unknown impl {impl!r}")


ssd_scan.launches = 0
ssd_scan.tc_launches = 0
