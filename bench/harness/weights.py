"""Seeded weights, made by the benchmark and handed to both sides.

A configuration's leaves come from its architecture's ``leaves(c)``
(``models/<model>.py``), named and laid out as the port's param tree holds
them (``harness/program.py`` checks that against the port's own shapes).
Values come from a few large draws on the device: the leaves are
packed into chunks of at most ``CHUNK`` elements, each chunk is one
``torch.randn`` call of a generator seeded from ``(seed, chunk)``, and each
leaf is a slice of its chunk, transformed by its rule and cast to the dtype
it is served in.  A chunk can be made again alone (``chunk_leaves``), so the
initial value of any leaf can be recomputed later without holding a copy.
"""
from __future__ import annotations

import dataclasses
import math

CHUNK = 1 << 27
_MIX = 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: tuple
    shape: tuple
    dtype: str      # "bf16" or "f32"
    rule: str       # normal | ones | alog | dt_bias
    scale: float = 0.0

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def padded_vocab(c: dict) -> int:
    """The vocabulary rows the port holds: the published vocabulary padded
    to the config's ``vocab_pad_multiple`` (the pad is never a target and
    is masked out of the logits on both sides)."""
    m = c["vocab_pad_multiple"]
    return -(-c["vocab_size"] // m) * m


def lm_leaves(c: dict) -> list[Leaf]:
    """A language model's leaves outside its layers, in a fixed order: the
    embedding, the output head (both of the padded vocabulary's rows) and
    the final norm."""
    d, vp = c["d_model"], padded_vocab(c)
    return [Leaf(("embed", "embedding"), (vp, d), "bf16", "normal", 0.02),
            Leaf(("embed", "lm_head"), (d, vp), "bf16", "normal", 0.02),
            Leaf(("ln_f",), (d,), "bf16", "ones")]


def chunks(spec: list[Leaf]) -> list[list[int]]:
    """Leaf indices packed in order into chunks of at most ``CHUNK``
    elements (a larger leaf is a chunk of its own)."""
    out, cur, size = [], [], 0
    for i, leaf in enumerate(spec):
        if cur and size + leaf.numel > CHUNK:
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += leaf.numel
    if cur:
        out.append(cur)
    return out


def torch_dtype(name: str):
    import torch
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]


def _make(leaf: Leaf, z):
    """A leaf's value from its slice ``z`` of standard normals (f32)."""
    import torch
    if leaf.rule == "normal":
        v = z.clamp(-2.0, 2.0) * leaf.scale
    elif leaf.rule == "ones":
        v = torch.ones_like(z)
    elif leaf.rule == "alog":  # A = -(1 .. h), the Mamba2 default
        v = torch.log(torch.arange(1, z.numel() + 1, dtype=torch.float32,
                                   device=z.device))
    elif leaf.rule == "dt_bias":  # softplus(dt_bias) log-uniform in [1e-3, 0.1]
        u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        v = dt + torch.log(-torch.expm1(-dt))
    else:
        raise ValueError(f"unknown init rule {leaf.rule!r}")
    return v.reshape(leaf.shape).to(torch_dtype(leaf.dtype))


def chunk_leaves(spec: list[Leaf], plan: list[list[int]], k: int, seed: int,
                 device) -> dict:
    """``{leaf index: tensor}`` of chunk ``k``, made on ``device``."""
    import torch
    ids = plan[k]
    total = sum(spec[i].numel for i in ids)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * _MIX + k) % (1 << 63))
    buf = torch.randn(total, generator=gen, dtype=torch.float32,
                      device=device)
    out, off = {}, 0
    for i in ids:
        n = spec[i].numel
        out[i] = _make(spec[i], buf[off: off + n])
        off += n
    return out


def make_all(spec: list[Leaf], seed: int, device) -> list:
    """Every leaf's tensor, in ``spec``'s order."""
    plan = chunks(spec)
    out = [None] * len(spec)
    for k in range(len(plan)):
        for i, t in chunk_leaves(spec, plan, k, seed, device).items():
            out[i] = t
    return out


def nest(spec: list[Leaf], tensors: list) -> dict:
    """The leaves as the nested tree their paths name (an int key is a
    list index)."""
    root: dict = {}
    for leaf, t in zip(spec, tensors):
        node = root
        for key, nxt in zip(leaf.path[:-1], leaf.path[1:]):
            if isinstance(nxt, int):
                node = node.setdefault(key, [])
            elif isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, {})
        last = leaf.path[-1]
        if isinstance(last, int):
            while len(node) <= last:
                node.append(None)
        node[last] = t
    return root


def get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree
