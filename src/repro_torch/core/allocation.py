"""Hybrid allocation optimization (paper §IV.B, Eq. 1).

Given ``c`` device grades, choose how many devices ``x_i`` of each grade run on
the Logical Simulation tier (the rest run on the Device Simulation tier) to
minimize the task makespan::

    T_l  = max_i ceil(k_i * x_i / f_i) * alpha_i                (logical tier)
    T_p  = max_i ceil((N_i - q_i - x_i) / m_i) * beta_i + lambda_i   (device tier)
    T    = max(T_l, T_p)

subject to ``0 <= x_i <= N_i - q_i``.  The paper formulates this as an ILP; the
objective is *separable* — ``x_i`` only influences grade ``i``'s two terms — so
the exact optimum is ``T* = max_i min_{x_i} g_i(x_i)`` with
``g_i(x) = max(logical_i(x), physical_i(x))``.  ``logical_i`` is nondecreasing
and ``physical_i`` nonincreasing in ``x``, so each inner minimum is found at
the crossing of two staircase functions by binary search (O(log N) per grade).

A secondary objective (paper: "prioritizing the use of Logical Simulation
resources") maximizes ``sum_i x_i`` over all makespan-optimal solutions; by the
same monotonicity each grade independently takes the largest feasible ``x_i``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.task import GradeSpec


@dataclasses.dataclass(frozen=True)
class GradeRuntime:
    """Pre-measured runtime parameters for one grade (paper symbols)."""

    alpha: float  # avg round duration of a logical-simulation bundle-group
    beta: float  # avg round duration on a physical phone
    lam: float  # startup time of the on-phone compute framework (lambda_i)

    def __post_init__(self):
        if self.alpha <= 0 or self.beta <= 0 or self.lam < 0:
            raise ValueError("alpha, beta must be > 0 and lambda >= 0")


@dataclasses.dataclass(frozen=True)
class GradeAllocation:
    grade: str
    logical_devices: int  # x_i
    physical_devices: int  # N_i - q_i - x_i
    logical_time: float
    physical_time: float


@dataclasses.dataclass(frozen=True)
class AllocationResult:
    makespan: float  # T*
    per_grade: tuple[GradeAllocation, ...]

    @property
    def total_logical(self) -> int:
        return sum(g.logical_devices for g in self.per_grade)


_INF = float("inf")


def _logical_time(x: int, spec: GradeSpec, rt: GradeRuntime) -> float:
    """ceil(k*x/f) * alpha; +inf when x devices are requested but f == 0."""
    if x == 0:
        return 0.0
    if spec.logical_bundles <= 0:
        return _INF
    return math.ceil(spec.bundles_per_device * x / spec.logical_bundles) * rt.alpha


def _physical_time(y: int, spec: GradeSpec, rt: GradeRuntime) -> float:
    """ceil(y/m) * beta + lambda; +inf when y devices requested but m == 0."""
    if y == 0:
        return 0.0
    if spec.physical_devices <= 0:
        return _INF
    return math.ceil(y / spec.physical_devices) * rt.beta + rt.lam


def _grade_makespan(x: int, spec: GradeSpec, rt: GradeRuntime) -> float:
    n = spec.allocatable_devices
    return max(_logical_time(x, spec, rt), _physical_time(n - x, spec, rt))


def _min_single_grade(spec: GradeSpec, rt: GradeRuntime) -> tuple[float, int]:
    """Exact ``min_x max(logical(x), physical(n-x))`` via crossing search.

    Returns ``(T_i, x_i)``.  ``logical`` is nondecreasing in x, ``physical``
    nonincreasing, so binary-search the largest x where physical >= logical and
    inspect the boundary pair.
    """
    n = spec.allocatable_devices
    if n == 0:
        return 0.0, 0
    lo, hi = 0, n
    # Invariant target: find largest x with physical(n-x) >= logical(x).
    if _physical_time(n - lo, spec, rt) < _logical_time(lo, spec, rt):
        # physical already below logical at x=0 -> optimum at x=0.
        candidates = [0]
    else:
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if _physical_time(n - mid, spec, rt) >= _logical_time(mid, spec, rt):
                lo = mid
            else:
                hi = mid - 1
        candidates = [lo] + ([lo + 1] if lo + 1 <= n else [])
    best_x = min(candidates, key=lambda x: (_grade_makespan(x, spec, rt), -x))
    return _grade_makespan(best_x, spec, rt), best_x


def _max_x_within(spec: GradeSpec, rt: GradeRuntime, budget: float) -> int:
    """Largest feasible x_i with both tier times <= budget (secondary obj)."""
    n = spec.allocatable_devices
    lo, hi = -1, n
    # logical(x) nondecreasing: binary search largest x with logical <= budget.
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _logical_time(mid, spec, rt) <= budget + 1e-12:
            lo = mid
        else:
            hi = mid - 1
    x_hi = lo
    # physical(n-x) <= budget gives a LOWER bound on x.
    x_lo = 0
    while _physical_time(n - x_lo, spec, rt) > budget + 1e-12:
        # physical is nonincreasing in x -> binary search the smallest ok x.
        a, b = x_lo + 1, n
        while a < b:
            mid = (a + b) // 2
            if _physical_time(n - mid, spec, rt) <= budget + 1e-12:
                b = mid
            else:
                a = mid + 1
        x_lo = a
        break
    if x_lo > x_hi:
        raise ValueError("budget infeasible for grade (internal inconsistency)")
    return x_hi


def solve_allocation(
    specs: Sequence[GradeSpec],
    runtimes: Sequence[GradeRuntime],
    *,
    prefer_logical: bool = True,
) -> AllocationResult:
    """Exact solution of the paper's hybrid-allocation ILP (Eq. 1).

    When ``prefer_logical`` is set, among all makespan-optimal solutions the
    one maximizing ``sum_i x_i`` is returned (paper's stated tie-break).
    """
    if len(specs) != len(runtimes):
        raise ValueError("specs and runtimes must align")
    mins = [_min_single_grade(s, r) for s, r in zip(specs, runtimes)]
    makespan = max((t for t, _ in mins), default=0.0)
    if math.isinf(makespan):
        raise ValueError(
            "infeasible: some grade has devices but no resources on either tier"
        )
    out = []
    for (t_i, x_i), spec, rt in zip(mins, specs, runtimes):
        n = spec.allocatable_devices
        x = _max_x_within(spec, rt, makespan) if prefer_logical else x_i
        out.append(
            GradeAllocation(
                grade=spec.grade,
                logical_devices=x,
                physical_devices=n - x,
                logical_time=_logical_time(x, spec, rt),
                physical_time=_physical_time(n - x, spec, rt),
            )
        )
    return AllocationResult(makespan=makespan, per_grade=tuple(out))


def solve_allocation_bruteforce(
    specs: Sequence[GradeSpec],
    runtimes: Sequence[GradeRuntime],
    *,
    prefer_logical: bool = True,
) -> AllocationResult:
    """O(sum N_i) oracle used by property tests (exhaustive per grade)."""
    out = []
    makespan = 0.0
    per_grade_best: list[tuple[float, int]] = []
    for spec, rt in zip(specs, runtimes):
        n = spec.allocatable_devices
        best = min(
            ((_grade_makespan(x, spec, rt), x) for x in range(n + 1)),
            key=lambda p: (p[0], -p[1] if prefer_logical else p[1]),
        )
        per_grade_best.append(best)
        makespan = max(makespan, best[0])
    if math.isinf(makespan):
        raise ValueError("infeasible")
    for (t_i, _), spec, rt in zip(per_grade_best, specs, runtimes):
        n = spec.allocatable_devices
        feas = [
            x for x in range(n + 1) if _grade_makespan(x, spec, rt) <= makespan + 1e-12
        ]
        x = max(feas) if prefer_logical else min(feas, key=lambda x: _grade_makespan(x, spec, rt))
        out.append(
            GradeAllocation(
                grade=spec.grade,
                logical_devices=x,
                physical_devices=n - x,
                logical_time=_logical_time(x, spec, rt),
                physical_time=_physical_time(n - x, spec, rt),
            )
        )
    return AllocationResult(makespan=makespan, per_grade=tuple(out))


def fixed_ratio_allocation(
    specs: Sequence[GradeSpec],
    runtimes: Sequence[GradeRuntime],
    logical_fraction: float,
) -> AllocationResult:
    """Paper Fig. 7 baselines: fixed (logical, device) split ratios."""
    if not 0.0 <= logical_fraction <= 1.0:
        raise ValueError("logical_fraction in [0, 1]")
    out = []
    for spec, rt in zip(specs, runtimes):
        n = spec.allocatable_devices
        x = round(n * logical_fraction)
        out.append(
            GradeAllocation(
                grade=spec.grade,
                logical_devices=x,
                physical_devices=n - x,
                logical_time=_logical_time(x, spec, rt),
                physical_time=_physical_time(n - x, spec, rt),
            )
        )
    makespan = max(
        (max(g.logical_time, g.physical_time) for g in out), default=0.0
    )
    return AllocationResult(makespan=makespan, per_grade=tuple(out))
