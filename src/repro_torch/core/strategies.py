"""DeviceFlow message-dispatching strategies (paper §V.B).

Two families:

* **Real-time accumulated dispatching** — fires *during* a round: once the
  shelf has accumulated ``n`` messages they are dispatched immediately.  ``n``
  cycles through a user sequence (paper §VI.C.2 example ``[20, 100, 50]``);
  ``n = 1`` degenerates to real-time transmission.  Each message independently
  fails with probability ``p`` (device-dropout simulation).

* **Rule-based dispatching** — fires *after* a round completes:

  - *specific time-point*: user-defined ``(time, count)`` pairs, relative to
    round end or absolute; per-point failure probability and/or random discard.
  - *specific time-interval*: a user-defined rate curve ``y = f(t)`` is
    discretized by (1) equating total pending messages to the curve's AUC,
    (2) choosing a tick small enough that no single tick exceeds the dispatch
    capacity limit (e.g. 700 msg/s single-threaded), and (3) assigning each
    tick the message count proportional to its AUC share — reducing the
    interval mechanism to the time-point mechanism (paper §V.B).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.traffic_curves import TrafficCurve


@dataclasses.dataclass(frozen=True)
class DispatchPoint:
    """One scheduled dispatch: ``count`` messages at time ``t``."""

    t: float
    count: int
    failure_prob: float = 0.0
    random_discard: int = 0

    def __post_init__(self):
        if self.count < 0 or self.random_discard < 0:
            raise ValueError("count/discard must be non-negative")
        if not 0.0 <= self.failure_prob <= 1.0:
            raise ValueError("failure_prob in [0, 1]")


@dataclasses.dataclass(frozen=True)
class AccumulatedStrategy:
    """Real-time accumulated dispatching with cycling thresholds."""

    thresholds: tuple[int, ...] = (1,)
    failure_prob: float = 0.0

    def __post_init__(self):
        if not self.thresholds or any(n < 1 for n in self.thresholds):
            raise ValueError("thresholds must be positive")
        if not 0.0 <= self.failure_prob <= 1.0:
            raise ValueError("failure_prob in [0, 1]")

    def threshold_at(self, cycle: int) -> int:
        return self.thresholds[cycle % len(self.thresholds)]


@dataclasses.dataclass(frozen=True)
class TimePointStrategy:
    """Rule-based dispatching at user-defined time points."""

    points: tuple[DispatchPoint, ...]
    relative: bool = True  # times measured from round end (else absolute)

    def __post_init__(self):
        if not self.points:
            raise ValueError("need at least one dispatch point")
        ts = [p.t for p in self.points]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("dispatch points must be time-ordered")


@dataclasses.dataclass(frozen=True)
class TimeIntervalStrategy:
    """Rule-based dispatching along a user-defined rate curve."""

    curve: TrafficCurve
    interval: float  # real-time span the curve domain is scaled onto (seconds)
    relative: bool = True
    capacity_per_second: float = 700.0  # paper: single-thread dispatch limit
    failure_prob: float = 0.0
    random_discard_per_tick: int = 0

    def __post_init__(self):
        if self.interval <= 0:
            raise ValueError("interval must be positive")
        if self.capacity_per_second <= 0:
            raise ValueError("capacity must be positive")
        if not 0.0 <= self.failure_prob <= 1.0:
            raise ValueError("failure_prob in [0, 1]")

    def discretize(self, total_messages: int) -> TimePointStrategy:
        pts = discretize_curve(
            self.curve,
            total_messages,
            self.interval,
            self.capacity_per_second,
        )
        return TimePointStrategy(
            points=tuple(
                DispatchPoint(
                    t=t,
                    count=c,
                    failure_prob=self.failure_prob,
                    random_discard=self.random_discard_per_tick,
                )
                for t, c in pts
            ),
            relative=self.relative,
        )


def discretize_curve(
    curve: TrafficCurve,
    total_messages: int,
    interval: float,
    capacity_per_second: float,
    *,
    min_ticks: int = 64,
    samples_per_tick: int = 16,
) -> list[tuple[float, int]]:
    """Paper §V.B discretization: AUC-proportional per-tick counts.

    1. Scale the curve domain ``[lo, hi]`` onto ``[0, interval]`` seconds.
    2. Pick a tick ``dt`` such that the *peak*-rate tick never exceeds the
       per-tick capacity ``capacity_per_second * dt`` and there are at least
       ``min_ticks`` ticks ("the interval is sufficiently small").
    3. Each tick gets ``round(total * AUC_tick / AUC_total)`` messages
       (largest-remainder rounding so the counts sum exactly to ``total``),
       stamped at the tick's start.
    """
    if total_messages < 0:
        raise ValueError("total_messages must be non-negative")
    if total_messages == 0:
        return []
    span = curve.hi - curve.lo
    # Dense sampling of the curve for integration (trapezoid).
    n_dense = max(min_ticks * samples_per_tick, 4096)
    ts = np.linspace(curve.lo, curve.hi, n_dense + 1)
    ys = np.array([curve(float(t)) for t in ts])
    auc_total = float(np.trapezoid(ys, ts))
    if auc_total <= 0.0:
        raise ValueError("curve has zero area — cannot allocate messages")
    peak = float(ys.max())
    # Peak messages per second after scaling mass to total/interval:
    # rate(t_real) = total * f(t_curve) / (auc_total * interval/span) ... but
    # capacity constrains messages-per-tick: n_tick <= capacity * dt.  With
    # AUC-proportional allocation, max tick mass ~= total * peak * dt_curve /
    # auc_total, and dt_real = dt_curve * interval / span.
    # => need total * peak * dt_curve / auc_total <= capacity * dt_curve * interval/span
    # dt cancels: a *rate* requirement; if violated no dt helps -> densify until
    # per-tick count fits capacity*dt_real >= 1 granularity.
    # Resolution: enough ticks that the curve is well sampled, few enough
    # that per-tick counts stay meaningful.  NOTE densification cannot fix a
    # capacity violation — both the per-tick mass and the per-tick budget
    # scale linearly with dt — so when peak demand exceeds the dispatcher's
    # capacity we clip at capacity and spill forward (paper Fig. 10(b): "the
    # cloud service actually receives the full messages over a period
    # spanning the designated time point and subsequent certain intervals").
    n_ticks = int(min(max(min_ticks, 64), 512))
    edges = np.linspace(curve.lo, curve.hi, n_ticks + 1)
    masses = []
    for a, b in zip(edges[:-1], edges[1:]):
        sel = (ts >= a - 1e-15) & (ts <= b + 1e-15)
        tt, yy = ts[sel], ys[sel]
        if len(tt) < 2:
            tt = np.array([a, b])
            yy = np.array([curve(float(a)), curve(float(b))])
        masses.append(float(np.trapezoid(yy, tt)))
    masses = np.array(masses)
    raw = total_messages * masses / masses.sum()
    dt_real = interval / n_ticks
    # Largest-remainder rounding.
    floors = np.floor(raw).astype(int)
    rem = total_messages - int(floors.sum())
    order = np.argsort(-(raw - floors))
    counts = floors.copy()
    counts[order[:rem]] += 1
    # Clip to capacity; spill overflow forward in time.
    cap = max(1, int(math.floor(capacity_per_second * dt_real)))
    spill = 0
    out: list[tuple[float, int]] = []
    for i, c in enumerate(counts):
        c = int(c) + spill
        send = min(c, cap)
        spill = c - send
        t_real = i * dt_real
        if send > 0:
            out.append((t_real, send))
    extra_i = len(counts)
    while spill > 0:  # tail spill past the nominal interval
        send = min(spill, cap)
        out.append((extra_i * dt_real, send))
        spill -= send
        extra_i += 1
    return out


DispatchStrategy = AccumulatedStrategy | TimePointStrategy | TimeIntervalStrategy
