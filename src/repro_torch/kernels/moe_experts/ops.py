"""Public entry point for a MoE layer's expert products, grouped by expert.

``moe_experts(x, w1, w2, offs, *, impl)``: x ``(rows, d)`` the dispatched
rows sorted by expert, w1 ``(E, d, 2f)`` and w2 ``(E, f, d)`` the held
experts' SwiGLU weights, offs ``(E,)`` int32 the end of each expert's
rows -> y ``(rows, d)``: row r of expert e is ``(silu(a) * b) @ w2[e]``
with ``[a, b] = x[r] @ w1[e]`` (SiLU in f32, rounded to x's dtype).  Rows
past ``offs[-1]`` belong to no expert: their outputs and their gradients
are undefined, and a caller reads neither.  The offsets stay on the
device, so no route waits for the card.  Routes (``impl``):

* ``"auto"`` — ``"grouped"`` for bfloat16 CUDA tensors, else ``"plain"``;
* ``"grouped"`` — ``torch._grouped_mm``, one grouped product per weight
  (each expert's rows against its matrix, differentiable in x and the
  weights), on any device that takes it;
* ``"plain"`` — every row against every expert's matrices, each row's
  own expert's result kept (E times the products: small shapes and
  float32 only).

``moe_experts.launches`` counts the grouped products launched on a card
(two a call); nothing else touches it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["moe_experts"]

_ROUTES = ("auto", "grouped", "plain")


def _swiglu(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    gate, up = a.chunk(2, dim=-1)
    return F.silu(gate.float()).to(dtype) * up


def _grouped(x, w1, w2, offs):
    h = _swiglu(torch._grouped_mm(x, w1, offs=offs), x.dtype)
    return torch._grouped_mm(h.contiguous(), w2, offs=offs)


def _plain(x, w1, w2, offs):
    rows = torch.arange(x.shape[0], device=x.device)
    expert = torch.searchsorted(offs.to(torch.int64), rows, right=True)
    out = torch.zeros(x.shape[0], w2.shape[-1], dtype=x.dtype,
                      device=x.device)
    for e in range(w1.shape[0]):
        y = _swiglu(x @ w1[e], x.dtype) @ w2[e]
        out = torch.where((expert == e)[:, None], y, out)
    return out


def moe_experts(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                offs: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """The held experts' SwiGLU over their rows (see the module
    docstring)."""
    E, d, f2 = w1.shape
    if (x.ndim != 2 or x.shape[1] != d or tuple(w2.shape) != (E, f2 // 2, d)
            or tuple(offs.shape) != (E,) or offs.dtype != torch.int32):
        raise ValueError(f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
                         f"{tuple(w2.shape)}, offs {tuple(offs.shape)} "
                         f"{offs.dtype} do not fit")
    if impl not in _ROUTES:
        raise ValueError(f"moe_experts takes impl {_ROUTES}, got {impl!r}")
    if impl == "auto":
        impl = ("grouped" if x.device.type == "cuda"
                and x.dtype == torch.bfloat16 else "plain")
    if impl == "plain":
        return _plain(x, w1, w2, offs)
    if x.device.type == "cuda":
        moe_experts.launches += 2
    return _grouped(x, w1, w2, offs)


moe_experts.launches = 0
