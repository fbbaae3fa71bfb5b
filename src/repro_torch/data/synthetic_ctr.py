"""Synthetic Avazu-like CTR dataset (paper §VI.A.1).

The paper trains logistic regression for click-through-rate prediction on a
2 M-record subset of Avazu covering 100 000 unique ``device_id``s.  Avazu
cannot be shipped offline, so we generate a statistically analogous dataset:

* hashed categorical features (site/app category, banner position, device
  attributes, anonymized C14–C21) one-hot folded into a fixed-width hashed
  feature space — the standard LR-on-Avazu treatment;
* a ground-truth sparse logit vector generates labels, so the Bayes-optimal
  accuracy is controlled and learnable by LR;
* per-device preference offsets create natural non-IID-ness, with an explicit
  ``positive_rate`` knob per device for the paper's Fig. 11 "70 % of devices
  high-positive / 30 % high-negative" split.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CTRDataset:
    """Federated CTR data: features hashed to ``dim`` dims, one shard per device."""

    features: np.ndarray  # (num_records, dim) float32 (multi-hot hashed)
    labels: np.ndarray  # (num_records,) float32 in {0, 1}
    device_ids: np.ndarray  # (num_records,) int32
    num_devices: int
    dim: int

    def device_shard(self, device_id: int) -> tuple[np.ndarray, np.ndarray]:
        m = self.device_ids == device_id
        return self.features[m], self.labels[m]

    def stacked_shards(
        self, device_ids: np.ndarray, records_per_device: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fixed-size per-device batches (pad/trim) for vectorized simulation.

        Returns (features (D, R, dim), labels (D, R), num_samples (D,)).

        Each device's records are one contiguous range of a stable sort by
        device id (for ``make_federated_ctr`` data the ids are already
        sorted, ``np.repeat`` order), so the whole gather is a few vector
        ops instead of one boolean mask over every record per device.
        """
        device_ids = np.asarray(device_ids)
        n = len(device_ids)
        R = int(records_per_device)
        order = np.argsort(self.device_ids, kind="stable")
        sorted_ids = self.device_ids[order]
        starts = np.searchsorted(sorted_ids, device_ids, side="left")
        ends = np.searchsorted(sorted_ids, device_ids, side="right")
        counts = np.minimum(ends - starts, R).astype(np.int32)
        valid = np.arange(R)[None, :] < counts[:, None]
        src = order[(starts[:, None] + np.arange(R)[None, :])[valid]]
        X = np.zeros((n, R, self.dim), np.float32)
        Y = np.zeros((n, R), np.float32)
        X[valid] = self.features[src]
        Y[valid] = self.labels[src]
        return X, Y, counts


_N_RAW_FIELDS = 14  # site/app/banner/device fields + C14..C21 analogues


def make_federated_ctr(
    *,
    num_devices: int = 1000,
    records_per_device: int = 20,
    dim: int = 256,
    seed: int = 0,
    noniid_alpha: float | None = None,
    positive_rate_split: tuple[float, float, float] | None = None,
) -> CTRDataset:
    """Generate the synthetic federated CTR dataset.

    ``noniid_alpha``: if set, per-device feature distributions are skewed by a
    Dirichlet(alpha) mixture over latent user segments (smaller = more skew).

    ``positive_rate_split``: ``(frac_high, rate_high, rate_low)`` reproduces
    Fig. 11(b): ``frac_high`` of devices get positive-label rate
    ``rate_high``, the rest ``rate_low``.
    """
    rng = np.random.default_rng(seed)
    n = num_devices * records_per_device

    # Latent segments drive both feature values and CTR propensity.
    n_segments = 8
    seg_field_prefs = rng.integers(0, 1000, size=(n_segments, _N_RAW_FIELDS))
    if noniid_alpha is not None:
        dev_seg_probs = rng.dirichlet([noniid_alpha] * n_segments, size=num_devices)
    else:
        dev_seg_probs = np.full((num_devices, n_segments), 1.0 / n_segments)

    device_ids = np.repeat(np.arange(num_devices, dtype=np.int32), records_per_device)
    # One ``rng.choice(n_segments, p=...)`` per record draws one uniform
    # double and returns ``searchsorted(cdf, u, side="right")`` over the
    # normalized cumulative probabilities; drawing all uniforms at once and
    # counting the CDF entries <= u gives the same segments and leaves the
    # generator in the same state.
    cdf = np.cumsum(dev_seg_probs, axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random(n)
    seg = np.empty(n, np.int32)
    step = 1 << 18  # bounds the (step, n_segments) temporary
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        seg[lo:hi] = (cdf[device_ids[lo:hi]] <= u[lo:hi, None]).sum(axis=1)

    # Raw categorical values: segment preference + noise, then feature-hashed.
    raw = seg_field_prefs[seg] + rng.integers(0, 50, size=(n, _N_RAW_FIELDS))
    feats = np.zeros((n, dim), np.float32)
    for f in range(_N_RAW_FIELDS):
        h = (raw[:, f] * 2654435761 + f * 97) % dim
        feats[np.arange(n), h] += 1.0
    feats /= np.sqrt(_N_RAW_FIELDS)

    # Ground-truth sparse logit vector => learnable-by-LR labels.
    w_true = rng.normal(0.0, 1.5, size=dim) * (rng.random(dim) < 0.3)
    logits = feats @ w_true - 1.0
    if positive_rate_split is not None:
        frac_high, rate_high, rate_low = positive_rate_split
        is_high = (device_ids % num_devices) < int(frac_high * num_devices)
        target = np.where(is_high, rate_high, rate_low)
        # Shift each device's logits to hit its target positive rate.
        logits = logits + np.log(target / (1.0 - target))
    probs = 1.0 / (1.0 + np.exp(-logits))
    labels = (rng.random(n) < probs).astype(np.float32)

    return CTRDataset(
        features=feats,
        labels=labels,
        device_ids=device_ids,
        num_devices=num_devices,
        dim=dim,
    )
