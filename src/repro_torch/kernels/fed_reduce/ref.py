"""Plain PyTorch version of the fused federated weighted reduction.

``fed_reduce_ref`` is the single-leaf oracle (f32 accumulation, like the
kernel).  The CPU tests use it, ``fed_reduce(impl="auto")`` takes it for
CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel against it on the
card.  Nothing on the main path calls it when the tensors are on a card.
"""
from __future__ import annotations

import torch


def fed_reduce_ref(stack: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted row-sum ``out = sum_i weights[i] * stack[i]`` in f32.

    ``stack``: (n, ...) — any trailing shape; ``weights``: (n,).  Returns
    the trailing shape in float32 (accumulation dtype; callers cast).
    """
    n = stack.shape[0]
    flat = stack.reshape(n, -1).to(torch.float32)
    out = (weights.to(torch.float32)[:, None] * flat).sum(0)
    return out.reshape(stack.shape[1:])
