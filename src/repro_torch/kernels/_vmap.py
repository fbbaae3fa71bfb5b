"""The layout the kernels' ``vmap`` rules share.

A ctypes launch cannot be vmapped, so an autograd Function's ``vmap`` rule
folds the vmapped dimension into an axis whose slices the kernel treats
independently (the heads of the SSD scan, the channels of the causal
conv), launches once, and unfolds the result.
"""
from __future__ import annotations

import torch


def fold(t: torch.Tensor, dim: "int | None", batch: int,
         axis: int) -> torch.Tensor:
    """A vmapped operand with its vmapped dimension ``dim`` (``None``:
    unbatched, expanded) folded into its ``axis``, vmapped index outermost;
    contiguous."""
    t = t.expand(batch, *t.shape) if dim is None else t.movedim(dim, 0)
    t = t.movedim(0, axis)
    return t.reshape(*t.shape[:axis], -1, *t.shape[axis + 2:]).contiguous()


def unfold(t: torch.Tensor, batch: int, axis: int) -> torch.Tensor:
    """:func:`fold`'s inverse: ``axis`` split into ``(batch, -1)``."""
    return t.reshape(*t.shape[:axis], batch, -1, *t.shape[axis + 1:])
