"""Plain PyTorch version of Mamba2's depthwise causal conv + bias + SiLU.

``causal_conv_ref`` is the chain the JAX package writes out
(``src/repro/models/mamba2.py::_causal_conv``), op for op, and
``causal_conv_bwd_ref`` its gradients as autograd takes them through that
chain.  The CPU runs them (``causal_conv(impl="auto")`` takes them for
tensors that are neither on a card nor on the meta device), the tests hold
the kernel to them, and ``chip_smoke.py`` times the chain beside the kernel
on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def causal_conv_ref(xbc: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  xbc (b, l, c); w (width, c).

    The taps are summed in the input dtype, in tap order, then the bias is
    added and silu taken in f32 — the reference's rounding (``F.conv1d``
    would round differently).
    """
    width = w.shape[0]
    xbc_p = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):  # width is 4: unrolled elementwise adds
        out = out + xbc_p[:, i: i + xbc.shape[1]] * w[i]
    return F.silu((out + b).float()).to(xbc.dtype)


def causal_conv_bwd_ref(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        dy: torch.Tensor) -> tuple:
    """``(dx, dw, db)`` of :func:`causal_conv_ref` at ``dy``: autograd
    through the chain, recomputed from its inputs (the same ops and the
    same rounding as a backward through the chain itself)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xbc, w, b)]
        return torch.autograd.grad(causal_conv_ref(*leaves), leaves, dy)
