"""Mamba2 (arXiv:2405.21060): everything of the benchmark that depends on
the architecture, for a configuration file that says ``"model": "mamba2"``.

* ``leaves(c)``: the seeded leaves (``harness/weights.py``), laid out as the
  port's param tree holds them: ``embed``, ``ln_f``, ``layers[i]``;
* ``FIELDS``: configuration-file key -> the port's ``ModelConfig`` field,
  each checked by ``harness/program.py``;
* the model-flop terms (``yardstick/flops.py``): ``mamba2_block`` and
  ``lm_head`` with their ``_decode`` forms, and ``repeats(c)``;
* ``kernel_shapes(c, b, l, kind)``: the arguments of the yardstick's work
  formula of each kernel call and the calls;
* the plain f32 reference (``reference/mamba2.py``): ``hidden``,
  ``logits_of``, ``loss``, ``logits_at``.

A hybrid's module reuses ``layer_leaves``, ``FIELDS``, ``mamba2_block``
and ``layer_kernel_shapes`` (and ``reference.mamba2.mamba_block``).
"""
from __future__ import annotations

import math

from harness.weights import Leaf, lm_leaves
from reference.mamba2 import hidden, logits_at, logits_of, loss  # noqa: F401
from yardstick import work as W
from yardstick.flops import lm_head, lm_head_decode  # noqa: F401

# configuration-file key -> the port's ModelConfig field
FIELDS = {
    "d_model": "d_model", "num_hidden_layers": "num_layers",
    "vocab_size": "vocab_size", "expand": "ssm_expand",
    "headdim": "ssm_head_dim", "d_state": "ssm_state",
    "ngroups": "ssm_groups", "d_conv": "ssm_conv_width",
    "chunk_size": "ssm_chunk", "rms_norm_eps": "norm_eps",
    "tie_embeddings": "tie_embeddings", "dtype": "dtype",
}


def layer_leaves(c: dict, prefix: tuple) -> list[Leaf]:
    """One Mamba2 layer's leaves under ``prefix``."""
    d, L = c["d_model"], c["num_hidden_layers"]
    di = c["expand"] * d
    h, g, n, w = di // c["headdim"], c["ngroups"], c["d_state"], c["d_conv"]
    out_scale = 0.02 / math.sqrt(2 * L)
    return [
        Leaf(prefix + ("ln",), (d,), "bf16", "ones"),
        Leaf(prefix + ("in_z",), (d, di), "bf16", "normal", 0.02),
        Leaf(prefix + ("in_x",), (d, di), "bf16", "normal", 0.02),
        Leaf(prefix + ("in_BC",), (d, 2 * g * n), "bf16", "normal", 0.02),
        Leaf(prefix + ("in_dt",), (d, h), "bf16", "normal", 0.02),
        Leaf(prefix + ("conv_x_w",), (w, di), "bf16", "normal", 0.5 / w),
        Leaf(prefix + ("conv_x_b",), (di,), "bf16", "normal", 0.02),
        Leaf(prefix + ("conv_BC_w",), (w, 2 * g * n), "bf16", "normal",
             0.5 / w),
        Leaf(prefix + ("conv_BC_b",), (2 * g * n,), "bf16", "normal", 0.02),
        Leaf(prefix + ("A_log",), (h,), "f32", "alog"),
        Leaf(prefix + ("dt_bias",), (h,), "f32", "dt_bias"),
        Leaf(prefix + ("D_skip",), (h,), "f32", "ones"),
        Leaf(prefix + ("norm_w",), (di,), "bf16", "ones"),
        Leaf(prefix + ("out_proj",), (di, d), "bf16", "normal", out_scale),
    ]


def leaves(c: dict) -> list[Leaf]:
    """Every leaf of configuration ``c`` in a fixed order."""
    out = lm_leaves(c)
    for i in range(c["num_hidden_layers"]):
        out += layer_leaves(c, ("layers", i))
    return out


def _dims(c: dict):
    d = c["d_model"]
    di = c["expand"] * d
    h = di // c["headdim"]
    g, n = c["ngroups"], c["d_state"]
    return d, di, h, c["headdim"], g, n, di + 2 * g * n


def mamba2_block(c: dict, b: int, l: int, kind: str) -> float:
    """One Mamba2 layer over ``b`` sequences of ``l`` tokens (``kind``
    ``train`` or ``forward``): in_proj, the depthwise conv, the SSD scan by
    its chunked algorithm's formula, out_proj."""
    d, di, h, p, g, n, conv_dim = _dims(c)
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
    d, di, h, p, g, n, conv_dim = _dims(c)
    return (2 * b * (d * (2 * di + 2 * g * n + h) + di * d)
            + 2 * b * c["d_conv"] * conv_dim + 4 * b * h * p * n)


def repeats(c: dict) -> dict:
    return {"mamba2_block": c["num_hidden_layers"]}


def layer_kernel_shapes(c: dict, b: int, l: int, kind: str,
                        layers: int) -> dict:
    """The kernel calls of ``layers`` Mamba2 layers (see
    ``kernel_shapes``)."""
    di = c["expand"] * c["d_model"]
    scan = dict(b=b, l=l, h=di // c["headdim"], p=c["headdim"],
                g=c["ngroups"], n=c["d_state"], q=c["chunk_size"], itemsize=2)
    convs = [dict(b=b, l=l, c=ch, width=c["d_conv"], itemsize=2)
             for ch in (di, 2 * c["ngroups"] * c["d_state"])]
    if kind != "train":
        return {"ssd_scan": [(scan, layers)],
                "causal_conv": [(s, layers) for s in convs]}
    # The port's training step checkpoints every block: the backward runs
    # each block's forward again.  Autograd hands the scan's backward a
    # (zero) state cotangent.
    return {"ssd_scan": [(scan, 2 * layers)],
            "ssd_scan_bwd": [(dict(scan, dstate=True), layers)],
            "causal_conv": [(s, 2 * layers) for s in convs],
            "causal_conv_bwd": [(s, layers) for s in convs]}


def kernel_shapes(c: dict, b: int, l: int, kind: str) -> dict:
    """``{kernel: [(its work formula's arguments, calls), ...]}`` of one
    call of the model over ``b`` sequences of ``l`` tokens: a microbatch's
    forward and backward (``kind`` ``train``) or a prefill (``forward``)."""
    return layer_kernel_shapes(c, b, l, kind, c["num_hidden_layers"])
