"""Model flops: what the model's mathematics needs, with no recomputation.

A configuration file lists its ``model_flop_terms``; each term is a
function of the configuration's architecture (``models/<model>.py``), of
the file's widths and of the tokens run, with a ``<term>_decode`` form for
one decode step, and the architecture's ``repeats(c)`` says how many times
a term repeats in the model (a term it does not name counts once).  Dot
products count two flops per multiply-add.  A training step counts each
matrix product three times (forward, and the two products of its
backward), and a kernel's backward by its own formula; the port's
rematerialized forward is recomputation and is not counted.
"""
from __future__ import annotations


def lm_head(c: dict, b: int, l: int, kind: str) -> float:
    """The output projection onto the published vocabulary."""
    f = 2 * b * l * c["d_model"] * c["vocab_size"]
    return 3 * f if kind == "train" else f


def lm_head_decode(c: dict, b: int, pos: int) -> float:
    return 2 * b * c["d_model"] * c["vocab_size"]


def model_flops(arch, c: dict, b: int, l: int, kind: str) -> float:
    """Flops of ``b`` sequences of ``l`` tokens through architecture
    ``arch``: ``kind`` ``train`` (a forward and backward) or ``forward`` (a
    prefill)."""
    reps = arch.repeats(c)
    total = 0.0
    for term in c["model_flop_terms"]:
        total += getattr(arch, term)(c, b, l, kind) * reps.get(term, 1)
    return total


def decode_flops(arch, c: dict, b: int, pos: int) -> float:
    """Flops of one decode step of ``b`` sequences after ``pos`` tokens."""
    reps = arch.repeats(c)
    total = 0.0
    for term in c["model_flop_terms"]:
        total += getattr(arch, f"{term}_decode")(c, b, pos) * reps.get(term, 1)
    return total
