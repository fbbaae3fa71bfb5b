"""The precision of the reference's products: ``matmul(a, w)`` is every
weight product and ``matmul.operand`` is applied to the operands of a
kernel's own products (the SSD scan's x, B and C).  ``Plain`` keeps both in
float32; the control (``lowp.Fp8``) rounds them."""
from __future__ import annotations


class Plain:
    """The products in f32."""

    def __call__(self, a, w):
        return a @ w

    def operand(self, t):
        return t


plain_matmul = Plain()
