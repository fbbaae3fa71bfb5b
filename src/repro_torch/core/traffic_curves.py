"""Traffic-curve library for DeviceFlow time-interval dispatching (paper §V.B).

A traffic curve is a single-valued, bounded, non-negative continuous (or
piecewise-continuous) function ``y = f(t)`` over a closed domain ``[a, b]``.
The curves below are the ones evaluated in the paper (Table II) plus the
right-tailed normal used for the federated-learning traffic experiments
(Fig. 9: N(0, sigma) restricted to t >= 0).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable


@dataclasses.dataclass(frozen=True)
class TrafficCurve:
    """A named rate curve ``f`` on closed domain ``[lo, hi]``."""

    name: str
    fn: Callable[[float], float]
    lo: float
    hi: float

    def __post_init__(self):
        if not self.hi > self.lo:
            raise ValueError("domain must be a nonempty closed interval")

    def __call__(self, t: float) -> float:
        v = self.fn(t)
        if v < -1e-12:
            raise ValueError(f"curve {self.name} negative at t={t}: {v}")
        return max(0.0, v)


def normal_pdf(sigma: float, mu: float = 0.0) -> Callable[[float], float]:
    c = 1.0 / (sigma * math.sqrt(2.0 * math.pi))
    return lambda t: c * math.exp(-0.5 * ((t - mu) / sigma) ** 2)


def right_tailed_normal(sigma: float, hi: float | None = None) -> TrafficCurve:
    """N(0, sigma) restricted to t >= 0 (paper Fig. 9 response curves)."""
    return TrafficCurve(
        name=f"right_normal(sigma={sigma})",
        fn=normal_pdf(sigma),
        lo=0.0,
        hi=4.0 * sigma if hi is None else hi,
    )


# The Table II evaluation set.
def table2_curves() -> tuple[TrafficCurve, ...]:
    return (
        TrafficCurve("N(0,1)", normal_pdf(1.0), -4.0, 4.0),
        TrafficCurve("N(0,2)", normal_pdf(2.0), -4.0, 4.0),
        TrafficCurve("sin(t)+1", lambda t: math.sin(t) + 1.0, 0.0, 6.0 * math.pi),
        TrafficCurve("cos(t)+1", lambda t: math.cos(t) + 1.0, 0.0, 6.0 * math.pi),
        TrafficCurve("2^t", lambda t: 2.0**t, 0.0, 3.0),
        TrafficCurve("10^t", lambda t: 10.0**t, 0.0, 3.0),
    )


def diurnal(day_s: float = 86400.0, *, trough: float = 0.12,
            peaks: tuple[tuple[float, float, float], ...] = (
                (0.36, 0.055, 0.75), (0.82, 0.075, 1.0)),
            days: float = 1.0, name: str = "diurnal") -> TrafficCurve:
    """Double-peaked diurnal access-load curve (million-user serving shape).

    ``peaks`` are ``(center, width, amplitude)`` Gaussian bumps in
    day-fraction units (defaults: a morning shoulder and a taller evening
    peak) on a ``trough`` base rate — the "fluctuating access load" profile
    SimDC's traffic controller replays against the cloud (§I challenge 2).
    The curve is periodic, so ``days > 1`` spans multiple days.
    """
    if not 0.0 <= trough:
        raise ValueError("trough must be non-negative")

    def fn(t: float) -> float:
        x = (t / day_s) % 1.0
        v = trough
        for c, w, a in peaks:
            # Wrap-around distance so a peak near midnight stays smooth.
            dx = min(abs(x - c), 1.0 - abs(x - c))
            v += a * math.exp(-0.5 * (dx / w) ** 2)
        return v

    return TrafficCurve(name, fn, 0.0, day_s * days)


def arrival_quantiles(curve: TrafficCurve, n: int,
                      duration_s: float | None = None,
                      *, samples: int = 4096) -> "list[float]":
    """Deterministic request arrival times shaped by ``curve``.

    Places ``n`` arrivals at the equal-AUC quantiles of the curve (inverse
    CDF at ``(i + 0.5) / n``), scaled onto ``[0, duration_s]`` (defaults to
    the curve's own domain span).  Deterministic by construction — the same
    trace drives every serving mode in a comparison.
    """
    import numpy as np
    if n < 0:
        raise ValueError("n must be non-negative")
    if n == 0:
        return []
    ts = np.linspace(curve.lo, curve.hi, samples + 1)
    ys = np.array([curve(float(t)) for t in ts])
    seg = 0.5 * (ys[1:] + ys[:-1]) * np.diff(ts)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    if cdf[-1] <= 0.0:
        raise ValueError("curve has zero area — cannot place arrivals")
    cdf /= cdf[-1]
    q = (np.arange(n) + 0.5) / n
    t_curve = np.interp(q, cdf, ts)
    span = curve.hi - curve.lo
    scale = (span if duration_s is None else duration_s) / span
    return [float((t - curve.lo) * scale) for t in t_curve]


def piecewise(segments: list[tuple[float, float, Callable[[float], float]]],
              name: str = "piecewise") -> TrafficCurve:
    """Piecewise-continuous curve from ``(lo, hi, fn)`` segments (paper allows
    piecewise continuity)."""
    if not segments:
        raise ValueError("need at least one segment")
    segs = sorted(segments, key=lambda s: s[0])
    for (l0, h0, _), (l1, _, _) in zip(segs, segs[1:]):
        if h0 > l1 + 1e-12:
            raise ValueError("overlapping segments")

    def fn(t: float) -> float:
        for lo, hi, f in segs:
            if lo - 1e-12 <= t <= hi + 1e-12:
                return f(t)
        return 0.0

    return TrafficCurve(name, fn, segs[0][0], segs[-1][1])
