"""Model flops: what the model's mathematics needs, with no recomputation.

A configuration file lists its ``model_flop_terms``; each term is a
function here of the file's widths and of the tokens run.  Dot products
count two flops per multiply-add.  A training step counts each matrix
product three times (forward, and the two products of its backward), and
the scan's backward by its own formula; the port's
rematerialized forward is recomputation and is not counted.
"""
from __future__ import annotations

from yardstick import work as W


def _mamba_dims(c: dict):
    d = c["d_model"]
    di = c["expand"] * d
    h = di // c["headdim"]
    g, n = c["ngroups"], c["d_state"]
    return d, di, h, c["headdim"], g, n, di + 2 * g * n


def mamba2_block(c: dict, b: int, l: int, kind: str) -> float:
    """One Mamba2 layer over ``b`` sequences of ``l`` tokens (``kind``
    ``train`` or ``forward``): in_proj, the depthwise conv, the SSD scan by
    its chunked algorithm's formula, out_proj."""
    d, di, h, p, g, n, conv_dim = _mamba_dims(c)
    tokens = b * l
    mm = 2 * tokens * (d * (2 * di + 2 * g * n + h) + di * d)
    conv = 2 * tokens * c["d_conv"] * conv_dim
    q = c["chunk_size"]
    scan = W.ssd_scan_work(b, l, h, p, g, n, q, 2).flops
    if kind == "train":
        return 3 * (mm + conv) + scan + W.ssd_scan_bwd_work(
            b, l, h, p, g, n, q, 2, True).flops
    return mm + conv + scan


def mamba2_block_decode(c: dict, b: int, pos: int) -> float:
    """One Mamba2 layer's single-token step for ``b`` sequences: the
    products, the conv and the state's update and read-out."""
    d, di, h, p, g, n, conv_dim = _mamba_dims(c)
    return (2 * b * (d * (2 * di + 2 * g * n + h) + di * d)
            + 2 * b * c["d_conv"] * conv_dim + 4 * b * h * p * n)


def lm_head(c: dict, b: int, l: int, kind: str) -> float:
    """The output projection onto the published vocabulary."""
    f = 2 * b * l * c["d_model"] * c["vocab_size"]
    return 3 * f if kind == "train" else f


def lm_head_decode(c: dict, b: int, pos: int) -> float:
    return 2 * b * c["d_model"] * c["vocab_size"]


_PER_LAYER = {"mamba2_block": "num_hidden_layers"}


def model_flops(c: dict, b: int, l: int, kind: str) -> float:
    """Flops of ``b`` sequences of ``l`` tokens: ``kind`` ``train`` (a
    forward and backward) or ``forward`` (a prefill)."""
    total = 0.0
    for term in c["model_flop_terms"]:
        f = globals()[term](c, b, l, kind)
        total += f * (c[_PER_LAYER[term]] if term in _PER_LAYER else 1)
    return total


def decode_flops(c: dict, b: int, pos: int) -> float:
    """Flops of one decode step of ``b`` sequences after ``pos`` tokens."""
    total = 0.0
    for term in c["model_flop_terms"]:
        f = globals()[f"{term}_decode"](c, b, pos)
        total += f * (c[_PER_LAYER[term]] if term in _PER_LAYER else 1)
    return total
