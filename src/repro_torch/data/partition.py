"""Federated data partitioners: IID, label-skew, Dirichlet (non-IID)."""
from __future__ import annotations

import numpy as np


def iid_partition(n_records: int, n_clients: int, *, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_records)
    return [np.sort(s) for s in np.array_split(perm, n_clients)]


def label_skew_partition(
    labels: np.ndarray, n_clients: int, *, frac_positive_heavy: float = 0.7,
    heavy_pos_share: float = 0.8, seed: int = 0,
) -> list[np.ndarray]:
    """Paper Fig. 11(b): a fraction of clients get mostly-positive samples."""
    rng = np.random.default_rng(seed)
    pos = rng.permutation(np.flatnonzero(labels > 0.5))
    neg = rng.permutation(np.flatnonzero(labels <= 0.5))
    n_heavy = int(frac_positive_heavy * n_clients)
    per_client = len(labels) // n_clients
    out, pi, ni = [], 0, 0
    for c in range(n_clients):
        share = heavy_pos_share if c < n_heavy else 1.0 - heavy_pos_share
        n_pos = min(int(per_client * share), len(pos) - pi)
        n_neg = min(per_client - n_pos, len(neg) - ni)
        idx = np.concatenate([pos[pi : pi + n_pos], neg[ni : ni + n_neg]])
        pi += n_pos
        ni += n_neg
        rng.shuffle(idx)
        out.append(idx)
    return out


def dirichlet_partition(
    labels: np.ndarray, n_clients: int, *, alpha: float = 0.5, seed: int = 0,
) -> list[np.ndarray]:
    """Classic Dirichlet(alpha) label partition (Hsu et al.)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = rng.permutation(np.flatnonzero(labels == c))
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, cuts)):
            client_idx[cl].extend(part.tolist())
    return [np.array(sorted(ix), dtype=np.int64) for ix in client_idx]
