"""The control: the reference's products with their operands rounded to
float8 (e4m3, one scale per tensor, as fp8 training scales them), the
nearest precision below the bfloat16 the configurations state: both
operands of every weight product, and the SSD scan's operands x, B and C.
The rounding is straight-through, so gradients flow to the f32 weights."""
from __future__ import annotations

import torch

from reference.matmul import Plain

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 at a per-tensor scale that maps its largest
    magnitude to the format's largest, in ``t``'s dtype."""
    with torch.no_grad():
        scale = t.detach().abs().amax().clamp_min(1e-12) / E4M3_MAX
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class Fp8(Plain):
    def __call__(self, a, w):
        return fp8(a) @ fp8(w)

    def operand(self, t):
        return fp8(t)


fp8_matmul = Fp8()
