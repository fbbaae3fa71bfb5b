"""The benchmark's token source: rows of a Zipf stream drawn from the seed.

Every row of every batch differs; the same seed gives the same rows in the
same order, so the reference can be handed the batches the program ran.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Batch:
    tokens: np.ndarray   # (rows, seq) int32
    targets: np.ndarray  # (rows, seq) int32, the next tokens
    mask: np.ndarray     # (rows, seq) float32, all ones


class TokenFeed:
    """An iterator of :class:`Batch` (what the port's ``make_cloud_step``
    takes as its ``pipe``): ``rows`` rows of ``seq`` tokens, Zipf(``a``)
    ids below ``vocab``; stream ``stream`` of ``seed``."""

    def __init__(self, seed: int, vocab: int, seq: int, rows: int, *,
                 a: float, stream: int = 0):
        self.rng = np.random.default_rng([int(seed), int(stream)])
        self.vocab, self.seq, self.rows, self.a = vocab, seq, rows, a

    def draw(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        filled = 0
        while filled < n:
            cand = self.rng.zipf(self.a, size=2 * (n - filled))
            cand = cand[cand < self.vocab][: n - filled]
            out[filled: filled + len(cand)] = cand
            filled += len(cand)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        s = self.draw(self.rows * (self.seq + 1)).reshape(self.rows,
                                                          self.seq + 1)
        return Batch(tokens=s[:, :-1].astype(np.int32),
                     targets=s[:, 1:].astype(np.int32),
                     mask=np.ones((self.rows, self.seq), np.float32))
