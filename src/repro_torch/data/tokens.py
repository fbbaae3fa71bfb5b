"""Token data pipeline for LM training/serving.

Production shape: a sharded, host-local, deterministic pipeline that yields
``(tokens, targets, mask)`` batches.  Offline here, the source is a synthetic
corpus (mixture of Zipf-distributed token streams with per-shard seeds so
every data-parallel host draws disjoint streams — the property that matters
for multi-host correctness).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenBatch:
    tokens: np.ndarray  # (batch, seq) int32 inputs
    targets: np.ndarray  # (batch, seq) int32 next-token targets
    mask: np.ndarray  # (batch, seq) float32 loss mask

    @property
    def num_tokens(self) -> int:
        return int(self.mask.sum())


class TokenPipeline:
    """Deterministic per-host shard of a synthetic Zipf corpus."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch_size: int,
        *,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
        zipf_a: float = 1.2,
    ):
        if not 0 <= host_id < num_hosts:
            raise ValueError("host_id out of range")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.rng = np.random.default_rng((seed * num_hosts + host_id) ^ 0xA5A5)
        self.zipf_a = zipf_a
        self._step = 0

    def _draw(self, n: int) -> np.ndarray:
        # Zipf with rejection to the vocab range; vectorized.
        out = np.empty(n, dtype=np.int64)
        filled = 0
        while filled < n:
            cand = self.rng.zipf(self.zipf_a, size=2 * (n - filled))
            cand = cand[cand < self.vocab_size][: n - filled]
            out[filled : filled + len(cand)] = cand
            filled += len(cand)
        return out

    def __iter__(self) -> Iterator[TokenBatch]:
        return self

    def __next__(self) -> TokenBatch:
        n = self.batch_size * (self.seq_len + 1)
        stream = self._draw(n).reshape(self.batch_size, self.seq_len + 1)
        self._step += 1
        return TokenBatch(
            tokens=stream[:, :-1].astype(np.int32),
            targets=stream[:, 1:].astype(np.int32),
            mask=np.ones((self.batch_size, self.seq_len), np.float32),
        )

    # -- deterministic restart (checkpoint integration) ----------------------
    def state_dict(self) -> dict:
        return {"step": self._step, "rng": self.rng.bit_generator.state}

    def load_state_dict(self, d: dict) -> None:
        self._step = d["step"]
        self.rng.bit_generator.state = d["rng"]


def synthetic_token_batches(
    vocab_size: int, seq_len: int, batch_size: int, n_batches: int, *, seed: int = 0
) -> list[TokenBatch]:
    pipe = TokenPipeline(vocab_size, seq_len, batch_size, seed=seed)
    return [next(pipe) for _ in range(n_batches)]
