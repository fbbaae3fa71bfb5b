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
* ``"meta"`` — shapes only, for ``meta`` tensors (the dry run): y and
  the state (and in the backward the gradients) of the right shapes and
  dtypes, no arithmetic;
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes
  ``"chunked"``, a CUDA tensor the kernel, a meta tensor ``"meta"``.
  There is no fallback: a CUDA tensor the kernel does not take raises.

A length that is not a multiple of the chunk is padded with ``dt = 0``
identity steps (decay exp(0) = 1, no input), and y is cut back, as the
reference does.  ``ssd_decode_step`` (one token) stays a plain torch op: the
reference has no kernel for it.

Training goes through :class:`SsdScan`, a ``torch.autograd.Function``
(``setup_context`` style, with a ``vmap`` rule, so ``torch.func``'s
``vmap(grad(...))`` of a model runs it) that returns ``(y, final_state)``.
Its backward is the hand-written backward (``csrc/ssd_scan.cu``) for CUDA
tensors and :func:`~.ref.ssd_bwd_ref` for CPU tensors (or with
``impl="chunked"``); there is no fallback between them.
:func:`kernel_for_bwd` picks its route before the launch, as
:func:`kernel_for` does the forward's: bf16 at the models' shapes runs on
the tensor cores (``"tc"``: six kernels, wgmma with TMA loads, the
cross-chunk recurrences elementwise), the rest on plain f32 FMAs
(``"simt"``: five kernels).  It takes the final state's cotangent too, and
a length that is not a multiple of the chunk is padded as the forward pads
it, the pad's gradients cut away.

Under :func:`repro_torch.roofline.op_analysis.analyze` each forward
(``"ssd_scan"``) and backward (``"ssd_scan_bwd"``) call of
:class:`SsdScan` records its work (``op_analysis.ssd_scan_work``,
``ssd_scan_bwd_work``) whichever route runs it.

``ssd_scan.launches`` counts kernel launches of either forward kernel (one
per call that reaches a kernel), ``ssd_scan.tc_launches`` those of the
tensor-core kernel alone, ``ssd_scan.bwd_launches`` the backward's calls
(one per backward, its kernels together) and ``ssd_scan.tc_bwd_launches``
those on the tensor-core route alone; nothing else touches them.
When a caller sets ``ssd_scan.shapes`` (``bwd_shapes``) to a set, each
forward (backward) launch also adds its ``(b, l, h, p, g, n, chunk, dtype
name)`` to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._vmap import fold, unfold
from repro_torch.kernels.ssd_scan.ref import (
    pad_steps,
    ssd_bwd_ref,
    ssd_chunked,
    ssd_decode_step,
    ssd_ref,
)
from repro_torch.roofline import op_analysis

__all__ = ["ssd_scan", "SsdScan", "ssd_decode_step", "ssd_ref",
           "ssd_chunked", "ssd_bwd_ref", "smem_bytes", "tc_smem_bytes",
           "kernel_takes", "kernel_for", "bwd_smem_bytes",
           "bwd_scratch_floats", "tc_bwd_smem_bytes",
           "tc_bwd_scratch_floats", "kernel_for_bwd"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
SMEM_LIMIT = 232448  # Hopper's opt-in shared memory per block
_ROWS = 32  # rows of the intra-chunk matrix the kernel builds per tile
TC_HEAD_DIM, TC_STATES, TC_CHUNKS = 64, (64, 128), (64, 128)
TC_BWD_HEADS = 8  # heads per block of the tensor-core backward (bwd_tc::HPB)
_TC_BWD_SPLIT = 1024  # state entries per block of its recurrence (SPLIT)

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


def bwd_smem_bytes(q: int, p: int) -> int:
    """The backward's chunk kernel's shared memory for chunk q and head dim
    p (``csrc/ssd_scan.cu::bwd::chunk_smem_floats``): x and dy transposed,
    the q x q matrix (dy_t . x_s) exp(L_t - L_s), one row tile of C B^T,
    column tiles (32 wide, stride 33) of B, C, S_in and dS_out, six
    per-step vectors and one partial per thread, in f32."""
    qs = q | 1
    return 4 * (2 * p * qs + q * qs + _ROWS * qs + 2 * q * 33 + 2 * p * 33
                + 6 * q + 256)


def bwd_scratch_floats(b: int, l: int, h: int, p: int, g: int, n: int,
                       q: int) -> int:
    """The backward's f32 scratch (``csrc/ssd_scan.cu::bwd::scratch_floats``;
    l a multiple of q): C B^T per (batch, group, chunk), the state entering
    each chunk and its cotangent leaving it per (batch, head, chunk), each
    head's dB and dC before the sum over its group, and each (batch, head,
    chunk)'s part of dA."""
    nc = l // q
    return (b * g * nc * q * q + 2 * b * h * nc * p * n + 2 * b * l * h * n
            + b * h * nc)


def tc_bwd_smem_bytes(q: int, n: int) -> dict:
    """The tensor-core backward's shared memory per block at chunk q and
    state n (``csrc/ssd_scan.cu::bwd_tc``'s layouts, 1 KB of alignment slack
    each): ``"local"`` (B, C, x, dy in bf16, dt and L), ``"chunk"`` (B, C, x,
    dy, S_in, dS_out in bf16, the f32 fragments of C B^T on and above the
    diagonal, ten per-step f32 vectors at q = 128, three mbarriers) and
    ``"dbdc"`` (two buffers of one head's x, dy, S_in, dS_out, the first
    over the summed Wd^T, C and B)."""
    box, s_box, nb, nw = q * 128, 64 * 128, n // 64, q // 64
    chunk = (2 * nb * box + 2 * box + 2 * nb * s_box
             + nw * (nw + 1) // 2 * 32 * 128 * 4 + (6 + 4 * nw) * q * 4
             + 3 * 8 + 1024)
    head = 2 * box + 2 * nb * s_box
    front = nw * box + 2 * nb * box
    return {"local": 2 * nb * box + 2 * box + 2 * q * 4 + 8 + 1024,
            "chunk": chunk,
            "dbdc": max(front, head) + head + 3 * 8 + 1024}


def tc_bwd_scratch_floats(b: int, l: int, h: int, p: int, g: int, n: int,
                          q: int) -> int:
    """The tensor-core backward's f32 scratch
    (``csrc/ssd_scan.cu::bwd_tc::scratch_floats``; l a multiple of q):
    S_in and dS_out per (batch, head, chunk) in bf16; each chunk's own
    state and cotangent contributions X and Y in f32, whose room the summed
    Wd^T and the per-block dB and dC then reuse; L per step; the parts of
    <dS_out, S_in>; each (batch, head, chunk)'s part of dA."""
    bhc, pn = b * h * (l // q), p * n
    blocks = b * (l // q) * g * -(-(h // g) // TC_BWD_HEADS)
    return (bhc * pn + max(2 * bhc * pn, blocks * (q * q + 2 * q * n))
            + b * h * l + bhc * (pn // _TC_BWD_SPLIT) + bhc)


def kernel_for_bwd(dtype: torch.dtype, p: int, n: int, q: int) -> str:
    """The backward kernels a CUDA call with this dtype, head dim p, state
    n and chunk q launches: ``"tc"`` (bf16 at the forward's tensor-core
    shapes, p = 64, n in (64, 128), q in (64, 128): the models' shapes) or
    ``"simt"`` (plain f32 FMAs, x, B and C in f32 or bf16: f32, and bf16
    elsewhere, for p <= 64, n <= 128 and chunk <= 128 within the shared
    memory, :func:`bwd_smem_bytes`; f32 on tensor cores would be TF32,
    outside the f32 tolerance).  Raises for anything else; a pure function
    of its arguments."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan backward takes x, B and C as float32 or "
                        f"bfloat16, got {dtype}")
    if (dtype == torch.bfloat16 and p == TC_HEAD_DIM and n in TC_STATES
            and q in TC_CHUNKS):
        return "tc"
    if not (1 <= q <= MAX_CHUNK and 1 <= p <= MAX_HEAD_DIM
            and 1 <= n <= MAX_STATE and bwd_smem_bytes(q, p) <= SMEM_LIMIT):
        raise ValueError(
            f"ssd_scan backward takes chunk <= {MAX_CHUNK}, head dim <= "
            f"{MAX_HEAD_DIM} and state <= {MAX_STATE}; got chunk {q}, p {p}, "
            f"n {n}")
    return "simt"


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
        fn = lib.ssd_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.ssd_scan_bwd_tc_launch
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.ssd_scan_bwd_tc_smem
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
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
    if ssd_scan.shapes is not None:
        ssd_scan.shapes.add(_shape_key(x, B, chunk))
    return y, state


def _shape_key(x, B, chunk):
    return (*x.shape, *B.shape[2:], chunk,
            str(x.dtype).removeprefix("torch."))


def _ssd_scan_bwd_cuda(x, dt, A, B, C, dy, dstate, chunk, kernel=None):
    """The backward kernels on CUDA tensors: ``(dx, ddt, dA, dB, dC)``;
    ``dstate`` (the final state's cotangent) may be None.  ``kernel``
    defaults to :func:`kernel_for_bwd`'s route (the smoke names ``"simt"``
    to time the plain-FMA kernels on bf16).  A length that is not a
    multiple of the chunk is padded with identity steps and the pad's
    gradients cut away."""
    _check_cuda(x, dt, A, B, C, chunk)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    route = kernel_for_bwd(x.dtype, p, n, chunk)
    kernel = route if kernel is None else kernel
    if kernel not in (route, "simt"):
        raise ValueError(f"the {kernel!r} ssd_scan backward does not take "
                         f"{x.dtype} at p {p}, n {n}, chunk {chunk}")
    for name, t, shape in (("dy", dy, x.shape),
                           ("dstate", dstate, (b, h, p, n))):
        if t is None:
            continue
        want = x.dtype if name == "dy" else torch.float32
        if (t.dtype != want or tuple(t.shape) != tuple(shape)
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {want} tensor of "
                             f"shape {tuple(shape)} on {x.device}")
    if kernel == "tc" and any(t.data_ptr() % 16 for t in (x, B, C, dy)):
        raise ValueError("the tensor-core ssd_scan backward needs 16-byte "
                         "aligned x, B, C and dy")
    if l % chunk:
        pad = chunk - l % chunk
        dx, ddt, dA, dB, dC = _ssd_scan_bwd_cuda(
            *(pad_steps(t, pad) for t in (x, dt)), A,
            *(pad_steps(t, pad) for t in (B, C, dy)), dstate, chunk, kernel)
        return dx[:, :l], ddt[:, :l], dA, dB[:, :l], dC[:, :l]
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    if kernel == "tc":
        floats = tc_bwd_scratch_floats(b, l, h, p, g, n, chunk)
    else:
        floats = bwd_scratch_floats(b, l, h, p, g, n, chunk)
    scratch = torch.empty((floats,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), dy.data_ptr(),
                None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                scratch.data_ptr(), floats)
        if kernel == "tc":
            err = _library().ssd_scan_bwd_tc_launch(*ptrs, b, l, h, p, g, n,
                                                    chunk, stream)
        else:
            err = _library().ssd_scan_bwd_launch(
                *ptrs, _DTYPE_CODES[x.dtype], b, l, h, p, g, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan {kernel} backward launch failed: "
                           f"cudaError {err}")
    ssd_scan.bwd_launches += 1
    if kernel == "tc":
        ssd_scan.tc_bwd_launches += 1
    if ssd_scan.bwd_shapes is not None:
        ssd_scan.bwd_shapes.add(_shape_key(x, B, chunk))
    return dx, ddt, dA, dB, dC


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        return {"cuda": "cuda", "meta": "meta"}.get(x.device.type, "chunked")
    if impl not in ("cuda", "chunked", "meta"):
        raise ValueError(f"SsdScan takes impl 'auto', 'cuda', 'chunked' or "
                         f"'meta', got {impl!r}")
    if impl == "meta" and x.device.type != "meta":
        raise ValueError(f"impl='meta' needs meta tensors, x is on {x.device}")
    return impl


def _dims(x, B, chunk) -> tuple:
    """The work formulas' ``(b, l, h, p, g, n, chunk, itemsize)``."""
    return (*x.shape, *B.shape[2:], chunk, x.element_size())


# The axis of heads (or groups) of each operand, where a vmapped dimension
# folds in: a ctypes launch cannot be vmapped, and the heads are independent
# of each other (A differs per head, so the batch axis would not do).
_FWD_AXES = (2, 2, 0, 2, 2)  # x, dt, A, B, C
_BWD_AXES = (*_FWD_AXES, 2, 1)  # ..., dy, dstate


class SsdScan(torch.autograd.Function):
    """Differentiable SSD scan (what :func:`ssd_scan` runs): ``SsdScan.apply(
    x, dt, A, B, C, chunk, impl)`` -> ``(y, final_state)``.  ``impl="auto"`` runs CUDA tensors on
    the forward kernel and, in the backward, the backward kernel (or
    raises), CPU tensors on the plain versions; ``"chunked"`` takes the
    plain versions wherever the tensors lie.  Under ``torch.func.vmap`` the
    vmapped dimension is folded into the heads."""

    @staticmethod
    def forward(x, dt, A, B, C, chunk, impl):
        chunk, impl = min(chunk, x.shape[1]), _resolve(impl, x)
        if op_analysis.ARMED:
            return op_analysis.kernel_call(
                "ssd_scan", op_analysis.ssd_scan_work(*_dims(x, B, chunk)),
                _ssd_scan, x, dt, A, B, C, chunk, impl)
        return _ssd_scan(x, dt, A, B, C, chunk, impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, B, C, chunk, impl = inputs
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.args = (min(chunk, x.shape[1]), _resolve(impl, x))

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = _SsdScanBackward.apply(*ctx.saved_tensors, dy, dstate,
                                       *ctx.args)
        return (*grads, None, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B, C, chunk, impl):
        n = info.batch_size
        y, state = SsdScan.apply(
            *(fold(t, d, n, a) for t, d, a in zip((x, dt, A, B, C),
                                                  in_dims, _FWD_AXES)),
            chunk, impl)
        return (unfold(y, n, 2), unfold(state, n, 1)), (2, 1)


class _SsdScanBackward(torch.autograd.Function):
    """``SsdScan``'s backward as a function of its own, so that
    ``torch.func`` can vmap it (the backward of ``vmap(grad(...))`` runs on
    vmapped tensors).  It has no backward itself."""

    @staticmethod
    def forward(x, dt, A, B, C, dy, dstate, chunk, impl):
        if op_analysis.ARMED:
            work = op_analysis.ssd_scan_bwd_work(*_dims(x, B, chunk),
                                                 dstate is not None)
            return op_analysis.kernel_call(
                "ssd_scan_bwd", work, _ssd_scan_bwd, x, dt, A, B, C, dy,
                dstate, chunk, impl)
        return _ssd_scan_bwd(x, dt, A, B, C, dy, dstate, chunk, impl)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("ssd_scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, dt, A, B, C, dy, dstate, chunk, impl):
        n = info.batch_size
        if dstate is None:
            in_dims = in_dims[:6]
        ops = (x, dt, A, B, C, dy) + (() if dstate is None else (dstate,))
        folded = [fold(t, d, n, a) for t, d, a in zip(ops, in_dims,
                                                      _BWD_AXES)]
        grads = _SsdScanBackward.apply(
            *folded, *([None] if dstate is None else []), chunk, impl)
        return (tuple(unfold(gr, n, a) for gr, a in zip(grads, _FWD_AXES)),
                _FWD_AXES)


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
    """Returns (y (b,l,h,p), final_state (b,h,p,n)), differentiable in x,
    dt, A, B and C (through :class:`SsdScan`; ``impl="ref"`` through
    autograd of the sequential oracle)."""
    b, l, h, p = x.shape
    if (dt.shape != (b, l, h) or A.shape != (h,) or B.ndim != 4
            or B.shape[:2] != (b, l) or C.shape != B.shape
            or h % B.shape[2]):
        raise ValueError(
            f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B {tuple(B.shape)}, "
            f"C {tuple(C.shape)} do not fit x {tuple(x.shape)}")
    if impl == "ref":
        return ssd_ref(x, dt, A, B, C)
    if impl not in ("auto", "cuda", "chunked", "meta"):
        raise ValueError(f"unknown impl {impl!r}")
    return SsdScan.apply(x, dt, A, B, C, chunk, impl)


def _ssd_scan_bwd(x, dt, A, B, C, dy, dstate, chunk, impl):
    """The backward of ``impl`` ("cuda", "chunked" or "meta")."""
    if impl == "meta":  # shaped as the kernel's: padded steps cut away
        pad = -x.shape[1] % chunk

        def grad(t, steps=True):
            shape = ((t.shape[0], t.shape[1] + pad, *t.shape[2:]) if steps
                     else t.shape)
            g = torch.empty(shape, dtype=t.dtype, device=t.device)
            return g[:, :x.shape[1]] if steps and pad else g
        return (grad(x), grad(dt), grad(A, False), grad(B), grad(C))
    args = (x, dt, A, B, C, dy.contiguous(),
            None if dstate is None else dstate.contiguous())
    if impl == "cuda":
        return _ssd_scan_bwd_cuda(*args, chunk)
    return ssd_bwd_ref(*args, chunk=chunk)


def _ssd_scan(x, dt, A, B, C, chunk, impl):
    """The forward of ``impl`` ("cuda", "chunked" or "meta") at ``chunk``
    (<= l)."""
    l = x.shape[1]
    if impl == "cuda":
        _check_cuda(x, dt, A, B, C, chunk)  # before any padding copies
    if l % chunk:
        # Pad to a chunk multiple with identity steps: dt=0 gives decay
        # exp(0)=1 and zero input contribution, so y/state are exact.
        pad = chunk - l % chunk
        y, s = _ssd_scan(*(pad_steps(t, pad) for t in (x, dt)), A,
                         *(pad_steps(t, pad) for t in (B, C)), chunk, impl)
        return y[:, :l], s
    if impl == "cuda":
        return _ssd_scan_cuda(x, dt, A, B, C, chunk)
    if impl == "meta":
        b, _, h, p = x.shape
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty((b, h, p, B.shape[3]), dtype=torch.float32,
                            device=x.device))
    return ssd_chunked(x, dt, A, B, C, chunk=chunk)


ssd_scan.launches = 0
ssd_scan.tc_launches = 0
ssd_scan.bwd_launches = 0
ssd_scan.tc_bwd_launches = 0
ssd_scan.shapes = None
ssd_scan.bwd_shapes = None
