"""Public entry point for Mamba2's depthwise causal conv + bias + SiLU.

``causal_conv(x, w, b, *, impl)``: x ``(batch, len, channels)``, w
``(width, channels)``, b ``(channels,)`` -> ``silu(conv(x) + b)`` of x's
shape and dtype, tap ``width - 1`` on the current step.  Routes
(``impl``, the block's scan route):

* ``"auto"`` — :class:`CausalConv`, on the route of x's device: a CUDA
  tensor launches the hand-written kernel (``csrc/causal_conv.cu``, built
  with ``nvcc`` at first use, launched through ``ctypes`` on the current
  stream); a ``meta`` tensor (the dry run) gets an empty tensor of y's
  shape after the kernel's checks; any other tensor runs the plain chain
  (:mod:`.ref`).  There is no fallback: a CUDA tensor the kernel does not
  take raises;
* ``"cuda"`` — the kernel, or raises (a CPU tensor among them);
* ``"chunked"``, ``"ref"`` — the plain chain's ops wherever the tensors lie
  (a model whose ``attention_impl`` asks for its plain ops passes these).

The kernel takes x, w and b in one dtype, float32 or bfloat16, all
contiguous, and width <= 4.

:class:`CausalConv` is a ``torch.autograd.Function`` (``setup_context``
style, with a ``vmap`` rule that folds the vmapped dimension into the
channels, which are independent) that saves only x, w and b.  Its backward
on a card is the hand-written backward: dx from dy times SiLU's derivative
at the pre-activation recomputed from x, dw and db as per-block f32
partials summed in a fixed order by a second kernel; on the meta device
empty gradients of the right shapes; elsewhere autograd through the plain
chain (:func:`.ref.causal_conv_bwd_ref`).  Under
:func:`repro_torch.roofline.op_analysis.analyze` each forward
(``"causal_conv"``) and backward (``"causal_conv_bwd"``) call of it records
the kernel's work (``op_analysis.causal_conv_work``,
``causal_conv_bwd_work``) on every device, so a step's analysis on the CPU
or the meta device is the card's; ``"chunked"`` and ``"ref"`` are counted
op by op.

``causal_conv.launches`` counts the forward's calls that reach the kernel
(one launch each) and ``causal_conv.bwd_launches`` the backward's (two
launches each); nothing else touches them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._vmap import fold, unfold
from repro_torch.kernels.causal_conv.ref import (
    causal_conv_bwd_ref,
    causal_conv_ref,
)
from repro_torch.roofline import op_analysis

__all__ = ["causal_conv", "causal_conv_ref", "CausalConv", "plan", "Plan",
           "MAX_WIDTH"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_WIDTH = 4
_THREADS = 256  # threads per block (csrc THREADS)
_VEC_BYTES = 8  # bytes a thread loads and stores per step (csrc vec)
# Steps a thread walks, longest first (csrc rows), and the most threads of
# a block across channels: the settings measured fastest at mamba2-1.3b's
# shapes on an H100 (PERF.md, the kernel table).
_ROWS = {False: (8, 4), True: (16, 8, 4)}  # by backward
_MAX_TX = {False: 32, True: 16}
_WAVES = 3  # blocks wanted per SM before a shorter run is taken
_ROUTES = ("auto", "cuda", "chunked", "ref")

_lib = None
_sm_counts: dict[int, int] = {}  # device index -> multiprocessor count


class Plan(NamedTuple):
    """One launch: ``vec`` channels per thread, ``rows`` steps per thread,
    a block of ``tx`` threads across channel groups by ``ty`` across runs,
    ``blocks`` blocks of runs (grid.x; the backward's partial rows) and
    ``tiles`` tiles of channels (grid.y)."""

    vec: int
    rows: int
    tx: int
    ty: int
    blocks: int
    tiles: int


@functools.lru_cache(maxsize=256)
def plan(batch: int, length: int, channels: int, itemsize: int,
         aligned: bool, *, backward: bool, sm_count: int) -> Plan:
    """Launch shape for ``(batch, length, channels)`` on a card with
    ``sm_count`` multiprocessors.

    ``vec`` channels per 8-byte access (4 bf16, 2 f32) where the pointers
    and the channels allow, else 1; ``tx`` threads across channel groups
    (at most 32 forward, 16 backward; fewer for narrow tensors) and ``ty =
    256 / tx`` across runs; ``rows`` the longest run (8 or 4 steps forward,
    16, 8 or 4 backward) whose grid still gives each SM three blocks, else
    4 (each run reads its width - 1 steps before again).  A pure function
    of shapes, alignment and the card: the same input on the same card
    always sums in the same order."""
    vec = _VEC_BYTES // itemsize
    if not aligned or channels % vec:
        vec = 1
    groups = -(-channels // vec)
    tx = min(_MAX_TX[backward], 1 << (groups - 1).bit_length())
    ty = _THREADS // tx
    tiles = -(-groups // tx)
    for rows in _ROWS[backward]:
        blocks = -(-batch * -(-length // rows) // ty)
        if blocks * tiles >= _WAVES * sm_count:
            break
    return Plan(vec, rows, tx, ty, blocks, tiles)


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load_library

        lib = load_library("causal_conv")
        fn = lib.causal_conv_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.causal_conv_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
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


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           meta: bool = False) -> None:
    """Raises unless the kernel takes these tensors as they are (it never
    copies a strided or mistyped tensor into shape); ``meta`` lets meta
    tensors through, whose shapes the dry run checks as the card would."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"causal_conv kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if not 1 <= w.shape[0] <= MAX_WIDTH:
        raise ValueError(f"causal_conv kernel takes width <= {MAX_WIDTH}, "
                         f"got {w.shape[0]}")
    for name, t in (("w", w), ("b", b)):
        if t.dtype != x.dtype:
            raise TypeError(f"causal_conv kernel takes {name} as {x.dtype}, "
                            f"got {t.dtype}")
    if x.device.type != "cuda" and not (meta and x.device.type == "meta"):
        raise ValueError(f"the causal_conv kernel needs CUDA tensors, x is on "
                         f"{x.device}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"causal_conv kernel needs a contiguous {name}")


def _plan(x: torch.Tensor, tensors, backward: bool) -> Plan:
    return plan(*x.shape, x.element_size(),
                all(t.data_ptr() % _VEC_BYTES == 0 for t in tensors),
                backward=backward, sm_count=_sm_count(x.device))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    _check(x, w, b)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    p = _plan(x, (x, w, b, y), backward=False)
    with torch.cuda.device(x.device):
        err = _library().causal_conv_fwd_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[x.dtype], p.vec, p.rows, *x.shape, w.shape[0], p.tx,
            p.ty, _stream(x))
    if err != 0:
        raise RuntimeError(f"causal_conv kernel launch failed: cudaError {err}")
    causal_conv.launches += 1
    return y


def _bwd_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dy: torch.Tensor) -> tuple:
    _check(x, w, b)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be a {x.dtype} tensor of shape "
                         f"{tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    if x.numel() == 0:
        return dx, dw.zero_(), db.zero_()
    p = _plan(x, (x, w, b, dy, dx, dw, db), backward=True)
    width = w.shape[0]
    partial = torch.empty((p.blocks, width + 1, x.shape[2]),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().causal_conv_bwd_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), db.data_ptr(), partial.data_ptr(),
            _DTYPE_CODES[x.dtype], p.vec, p.rows, *x.shape, width, p.tx,
            p.ty, _stream(x))
    if err != 0:
        raise RuntimeError(f"causal_conv backward launch failed: cudaError "
                           f"{err}")
    causal_conv.bwd_launches += 1
    return dx, dw, db


def _dims(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The work formulas' ``(batch, len, channels, width, itemsize)``."""
    return (*x.shape, w.shape[0], x.element_size())


def _forward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """y on the route of x's device (see the module docstring)."""
    if x.device.type == "cuda":
        return _fwd_cuda(x, w, b)
    if x.device.type == "meta":
        _check(x, w, b, meta=True)
        return torch.empty_like(x)
    return causal_conv_ref(x, w, b)


def _backward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dy: torch.Tensor) -> tuple:
    """``(dx, dw, db)`` on the route :func:`_forward` takes."""
    if x.device.type == "cuda":
        return _bwd_cuda(x, w, b, dy)
    if x.device.type == "meta":
        return tuple(torch.empty_like(t) for t in (x, w, b))
    return causal_conv_bwd_ref(x, w, b, dy)


# The channel axis of x, w, b (and dy): where a vmapped dimension folds in
# (vmapped index outermost; the channels are independent).
_AXES = (2, 1, 0)


class CausalConv(torch.autograd.Function):
    """:func:`causal_conv`'s ``"auto"`` route: ``CausalConv.apply(x, w,
    b)`` -> y, differentiable in x, w and b (on a card through the
    hand-written backward).  Under ``torch.func.vmap`` the vmapped
    dimension is folded into the channels."""

    @staticmethod
    def forward(x, w, b):
        if op_analysis.ARMED:
            return op_analysis.kernel_call(
                "causal_conv", op_analysis.causal_conv_work(*_dims(x, w)),
                _forward, x, w, b)
        return _forward(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dy):
        return _CausalConvBackward.apply(*ctx.saved_tensors, dy)

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        n = info.batch_size
        y = CausalConv.apply(*(fold(t, d, n, a) for t, d, a in
                               zip((x, w, b), in_dims, _AXES)))
        return unfold(y, n, 2), 2


class _CausalConvBackward(torch.autograd.Function):
    """``CausalConv``'s backward as a function of its own, so that
    ``torch.func`` can vmap it.  It has no backward itself."""

    @staticmethod
    def forward(x, w, b, dy):
        if op_analysis.ARMED:
            return op_analysis.kernel_call(
                "causal_conv_bwd",
                op_analysis.causal_conv_bwd_work(*_dims(x, w)),
                _backward, x, w, b, dy)
        return _backward(x, w, b, dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("causal_conv has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, w, b, dy):
        n = info.batch_size
        grads = _CausalConvBackward.apply(
            *(fold(t, d, n, a) for t, d, a in zip((x, w, b, dy), in_dims,
                                                  (*_AXES, 2))))
        return (tuple(unfold(g, n, a) for g, a in zip(grads, _AXES)),
                _AXES)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                impl: str = "auto") -> torch.Tensor:
    """``silu(conv(x) + b)`` (see the module docstring for the routes)."""
    if (x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2]
            or tuple(b.shape) != (x.shape[2],)):
        raise ValueError(f"w {tuple(w.shape)} and b {tuple(b.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if impl not in _ROUTES:
        raise ValueError(f"causal_conv takes impl {_ROUTES}, got {impl!r}")
    if impl in ("chunked", "ref"):
        return causal_conv_ref(x, w, b)
    if impl == "cuda" and x.device.type != "cuda":
        _check(x, w, b)  # raises: the kernel takes CUDA tensors only
    return CausalConv.apply(x, w, b)


causal_conv.launches = 0
causal_conv.bwd_launches = 0
