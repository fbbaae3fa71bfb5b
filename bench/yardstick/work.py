"""What one kernel call must do: its flops and the bytes it must move.

Frozen copies of the formulas in the port's ``roofline/op_analysis.py``
(``ssd_scan_work``, ``ssd_scan_bwd_work``, ``bound`` as they stood when the
benchmark was defined; ``causal_conv_work``, ``causal_conv_bwd_work`` as
they stood when the conv's roofline was added);
``bench/tests/test_bench_yardstick.py`` ties them to the program's at the
cells' shapes.  A formula counts the work of the call's
shapes whatever kernel computes it: inputs read once, outputs written once.
"""
from __future__ import annotations

from typing import NamedTuple


class Work(NamedTuple):
    flops: int
    bytes: int


def ssd_scan_work(b, l, h, p, g, n, q, itemsize) -> Work:
    """K4: x, dt, A, B, C read once, y and the f32 state written once; per
    head and chunk, C.B and M.x over the causal triangle, C.S^T and the
    state update."""
    moved = (2 * b * l * h * p * itemsize + 4 * b * l * h + 4 * h
             + 2 * b * l * g * n * itemsize + 4 * b * h * p * n)
    chunks = -(-l // q)
    return Work(2 * b * h * chunks * (q * (q + 1) // 2 * (n + p)
                                      + 2 * q * p * n), moved)


def ssd_scan_bwd_work(b, l, h, p, g, n, q, itemsize, dstate) -> Work:
    """K4b: x, dy, B, C, dt, A and the state's cotangent read once; dx, dB,
    dC, ddt and dA written once; the products of the chunked backward,
    two flops per multiply-add."""
    nc = -(-l // q)
    tri = q * (q + 1) // 2
    moved = (3 * b * l * h * p * itemsize + 4 * b * l * g * n * itemsize
             + 8 * b * l * h + 8 * h + (4 * b * h * p * n if dstate else 0))
    fma = (b * g * nc * tri * n
           + b * h * nc * (2 * tri * p + 2 * tri * n + 5 * q * p * n))
    return Work(2 * fma, moved)


def causal_conv_work(b, l, c, width, itemsize) -> Work:
    """The depthwise causal conv + bias + SiLU over ``c`` channels: x read
    once, y written once, w and the bias read; ``width`` multiply-adds per
    output."""
    return Work(2 * width * b * l * c,
                (2 * b * l * c + (width + 1) * c) * itemsize)


def causal_conv_bwd_work(b, l, c, width, itemsize) -> Work:
    """Its backward: x and dy read once, dx written once, w and the bias
    read and their gradients written; ``width`` multiply-adds per element
    for dx and as many for dw."""
    return Work(4 * width * b * l * c,
                (3 * b * l * c + 2 * (width + 1) * c) * itemsize)


def bound_s(work: Work, flops_per_s: float, bytes_per_s: float) -> float:
    """The least time the card could take for ``work``: the larger of its
    bytes over the memory rate and its flops over the compute rate."""
    return max(work.bytes / bytes_per_s, work.flops / flops_per_s)
