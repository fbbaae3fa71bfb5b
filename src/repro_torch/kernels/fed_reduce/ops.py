"""Public entry point for the fused federated update reduction.

``fed_reduce`` reduces one stacked ``(rows, ...)`` leaf to an
*unnormalized* f32 weighted sum, so partial reductions over several buffers
can be combined before dividing by the total weight (see
``federation.fused_fedavg_delta``, which maps it over every ``(rows,
size)`` leaf of an ``UpdateBuffer``).

Implementations (``impl``):

* ``"cuda"`` — the hand-written Hopper kernel (``csrc/fed_reduce.cu``),
  built with ``nvcc`` at first use and launched through ``ctypes`` on the
  current stream: one launch per call, whose last block per column tile
  folds the row splits' partials (an integer ticket per tile, no float
  atomics);
* ``"ref"`` — the plain PyTorch version (:mod:`.ref`);
* ``"auto"`` — chosen by where the tensor lies: a CPU tensor takes the
  plain version, a CUDA tensor the kernel.  There is no fallback: a CUDA
  tensor the kernel does not take raises.

**Fused dequantize-and-reduce.**  ``fed_reduce(stack, weights,
scales=...)`` consumes a *quantized* int8 stack (``UpdateBuffer(wire=
"int8")`` leaves): ``out[d] = sum_i weights[i] * scales[i] * stack[i, d]``.
Symmetric per-row quantization is linear per row, so the scales fold into
the row weights — in the kernel's registers on the card, as one f32
multiply before the reduction in the plain version — and no dense f32 copy
of the stack is ever built.

``fed_reduce.launches`` counts kernel launches (one per call that reaches
the kernel); nothing else touches it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.analysis.sanitizers import hot_path
from repro_torch.kernels.fed_reduce.ref import fed_reduce_ref

__all__ = ["fed_reduce", "fed_reduce_ref", "plan", "Plan"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_THREADS = 256  # threads per block
_BLOCKS_PER_SM = 4
UNROLL = 8  # independent row loads in flight per thread (csrc UNROLL)
_MIN_ROWS_PER_THREAD = UNROLL
_MAX_SPLITS = 65535  # grid.y limit

_lib = None
_sm_counts: dict[int, int] = {}  # device index -> multiprocessor count
# device index -> the kernel's int32 tickets, one per column tile, zeroed
# once here and left at zero by every launch.  Launches on one stream share
# them safely; two in flight on different streams would not.
_tickets: dict[int, torch.Tensor] = {}


class Plan(NamedTuple):
    """One launch of the kernel: ``vec`` elements per load, a block of
    ``tx x ty`` threads, ``splits`` row splits of ``rows_per_split`` rows
    (grid.y) and ``tiles`` column tiles (grid.x, one ticket each)."""

    vec: int
    tx: int
    ty: int
    splits: int
    rows_per_split: int
    tiles: int


def plan(n: int, d: int, itemsize: int, aligned: bool, *, sm_count: int
         ) -> Plan:
    """Launch shape for an ``(n, d)`` stack on a card with ``sm_count``
    multiprocessors.

    ``vec`` elements per 16-byte load when the rows allow it (else 1);
    ``tx`` threads across column groups (at most 32, fewer for narrow
    leaves, one for the d = 1 bias) and ``ty = 256 / tx`` across rows;
    ``splits`` row splits so that about four blocks run per SM while each
    thread still reduces at least one unrolled batch of ``UNROLL`` (eight)
    rows, all loaded at once; ``tiles`` column tiles.  The plan depends on
    shapes, alignment and the card only, so the same input on the same card
    always reduces in the same order.
    """
    vec = 16 // itemsize
    if not aligned or d % vec:
        vec = 1
    groups = -(-d // vec)
    tx = min(32, 1 << (groups - 1).bit_length())
    ty = _THREADS // tx
    tiles = -(-groups // tx)
    splits = max(1, min(-(-sm_count * _BLOCKS_PER_SM // tiles),
                        -(-n // (ty * _MIN_ROWS_PER_THREAD)), _MAX_SPLITS))
    rows_per_split = -(-n // splits)
    splits = -(-n // rows_per_split)  # no empty split
    return Plan(vec, tx, ty, splits, rows_per_split, tiles)


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import load_library

        lib = load_library("fed_reduce")
        fn = lib.fed_reduce_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
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


def _ticket_buffer(device: torch.device, tiles: int) -> torch.Tensor:
    """At least ``tiles`` zeroed int32 tickets on ``device``, allocated
    once (and again only for a wider stack)."""
    idx = _device_index(device)
    buf = _tickets.get(idx)
    if buf is None or buf.numel() < tiles:
        buf = _tickets[idx] = torch.zeros(max(tiles, 64), dtype=torch.int32,
                                          device=device)
    return buf


def _check_operand(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the stack on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the kernel, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fed_reduce_cuda(stack2d: torch.Tensor, weights: torch.Tensor,
                     scales: "torch.Tensor | None") -> torch.Tensor:
    if stack2d.device.type != "cuda":
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, the stack is on {stack2d.device}")
    code = _DTYPE_CODES.get(stack2d.dtype)
    if code is None:
        raise TypeError(
            f"fed_reduce kernel takes float32, bfloat16 or int8 stacks, "
            f"got {stack2d.dtype}")
    if not stack2d.is_contiguous():
        raise ValueError("fed_reduce kernel needs a contiguous (rows, size) "
                         "stack")
    _check_operand("weights", weights, stack2d.device)
    if scales is not None:
        _check_operand("scales", scales, stack2d.device)
    n, d = stack2d.shape
    out = torch.empty(d, dtype=torch.float32, device=stack2d.device)
    if n == 0 or d == 0:
        return out.zero_()
    p = plan(n, d, stack2d.element_size(), stack2d.data_ptr() % 16 == 0,
             sm_count=_sm_count(stack2d.device))
    partial = tickets = None
    if p.splits > 1:
        partial = torch.empty((p.splits, d), dtype=torch.float32,
                              device=stack2d.device)
        tickets = _ticket_buffer(stack2d.device, p.tiles)
    with torch.cuda.device(stack2d.device):
        stream = torch.cuda.current_stream(stack2d.device).cuda_stream
        err = _library().fed_reduce_launch(
            stack2d.data_ptr(), code, p.vec, weights.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if tickets is None else tickets.data_ptr(), n, d, p.tx,
            p.ty, p.splits, p.rows_per_split, stream)
    if err != 0:
        raise RuntimeError(f"fed_reduce kernel launch failed: cudaError {err}")
    fed_reduce.launches += 1
    return out


@hot_path
def fed_reduce(stack: torch.Tensor, weights: torch.Tensor, *,
               scales: "torch.Tensor | None" = None,
               impl: str = "auto") -> torch.Tensor:
    """Weighted row-sum ``sum_i weights[i] * stack[i]`` -> f32 of
    ``stack[0]``'s shape.  ``stack``: (n, ...); ``weights``: (n,).

    ``scales`` (f32 ``(n,)``, a quantized ``UpdateBuffer`` scale column)
    selects the fused dequantize-and-reduce variant:
    ``sum_i weights[i] * scales[i] * stack[i]`` over an int8 stack.
    """
    if not isinstance(stack, torch.Tensor):
        stack = torch.as_tensor(stack)
    if not isinstance(weights, torch.Tensor):
        weights = torch.as_tensor(weights)
    if scales is not None and not isinstance(scales, torch.Tensor):
        scales = torch.as_tensor(scales)
    if stack.ndim < 1 or weights.shape != (stack.shape[0],):
        raise ValueError(
            f"stack rows {tuple(stack.shape)} must match weights "
            f"{tuple(weights.shape)}")
    if scales is not None and scales.shape != weights.shape:
        raise ValueError(
            f"scales {tuple(scales.shape)} must match weights "
            f"{tuple(weights.shape)}")
    if impl == "auto":
        impl = "cuda" if stack.device.type == "cuda" else "ref"
    if impl == "ref":
        if scales is not None:
            # Per-row dequantization is linear, so it folds into the weight
            # vector; a zero weight still zeroes the whole row.
            weights = weights.to(torch.float32) * scales.to(torch.float32)
        return fed_reduce_ref(stack, weights)
    if impl == "cuda":
        n = stack.shape[0]
        out = _fed_reduce_cuda(stack.reshape(n, -1), weights, scales)
        return out.reshape(stack.shape[1:])
    raise ValueError(f"unknown impl {impl!r}")


fed_reduce.launches = 0
