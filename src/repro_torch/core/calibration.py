"""Fleet-driven runtime calibration — closing the §IV.C → §IV.B loop.

The paper measures real phones (PhoneMgr over ADB) and feeds the measured
per-grade round statistics back into the hybrid allocator as the
``GradeRuntime`` constants (alpha_i, beta_i, lambda_i).  Here the measurement
source is the calibrated stochastic ``DeviceFleet`` — every simulated round
produces a ``FleetRoundSample``, and the q_i benchmarking devices materialize
full ``RoundReport``s.  ``RuntimeCalibrator`` accumulates those observations
per grade and produces *measured* runtimes, so ``solve_allocation`` and the
task scheduler run on data instead of hand-coded constants (the
virtual-vs-real discrepancy IoTSim-Edge's behavior-modeling critique warns
about).

Estimation contract (all in virtual seconds):

* ``lambda_i`` — mean APK_LAUNCH stage duration: the on-phone compute
  framework's startup cost, paid once per device batch.
* ``beta_i`` — mean device round duration *excluding* startup: the serial
  per-batch cost of a phone in ``ceil(y/m) * beta + lambda``.
* ``alpha_i`` — mean of the logical bundle-group durations recorded via
  ``observe_logical`` when the caller measured any; otherwise the mean
  TRAINING stage duration — the logical tier simulates the training
  computation only, with no APK lifecycle around it.

``sample_runtimes`` draws one *observed round* per grade instead of the mean,
so allocation can be driven by sampled (not mean) durations — e.g. to stress
the makespan estimate against round-to-round jitter.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.allocation import GradeRuntime
from repro_torch.core.devicemodel import (
    GRADES,
    DeviceGrade,
    FleetRoundSample,
    RoundReport,
    Stage,
    startup_duration_s,
    training_duration_s,
)

def table1_runtime(grade: DeviceGrade, *, train_cost_scale: float = 1.0
                   ) -> GradeRuntime:
    """Deterministic Table-I prior: what calibration converges to at scale.

    Used for grades with no observations yet (cold-start allocation before
    the first round has produced any fleet samples).
    """
    lam = startup_duration_s(grade)
    train = training_duration_s(grade, train_cost_scale=train_cost_scale)
    other = sum(grade.cost(s).duration_min for s in Stage
                if s not in (Stage.APK_LAUNCH, Stage.TRAINING)) * 60.0
    return GradeRuntime(alpha=train, beta=train + other, lam=lam)


@dataclasses.dataclass
class _GradeObservations:
    """Raw per-round duration draws for one grade (seconds)."""

    total_s: list = dataclasses.field(default_factory=list)
    launch_s: list = dataclasses.field(default_factory=list)
    train_s: list = dataclasses.field(default_factory=list)
    logical_s: list = dataclasses.field(default_factory=list)

    @property
    def num_device_rounds(self) -> int:
        return len(self.total_s)


class RuntimeCalibrator:
    """Accumulates fleet/report observations and estimates ``GradeRuntime``s.

    Feed it from the round engine (``HybridSimulation.run_plan_round(...,
    calibrator=...)``), from raw ``FleetRoundSample``s, or from benchmarking
    devices' ``RoundReport``s; read back measured runtimes with ``runtime`` /
    ``runtimes_for``, or plug it straight into ``TaskRunner`` (it exposes the
    ``for_task`` adapter the scheduler consumes).
    """

    def __init__(self, *, prior: Mapping[str, GradeRuntime] | None = None,
                 min_rounds: int = 1):
        if min_rounds < 1:
            raise ValueError("min_rounds must be >= 1")
        self._obs: dict[str, _GradeObservations] = defaultdict(_GradeObservations)
        self._prior = dict(prior or {})
        self.min_rounds = min_rounds

    # -- observation ingestion ---------------------------------------------
    def observe_fleet(self, sample: FleetRoundSample) -> None:
        """Ingest one vectorized round: every device row is one observation."""
        if np.asarray(sample.stage_duration_min).size == 0:
            return
        obs = self._obs[sample.grade]
        obs.total_s.extend((sample.total_duration_min * 60.0).tolist())
        obs.launch_s.extend(sample.stage_duration_s(Stage.APK_LAUNCH).tolist())
        obs.train_s.extend(sample.stage_duration_s(Stage.TRAINING).tolist())

    def observe_report(self, report: RoundReport) -> None:
        """Ingest one benchmarking device's round (paper §IV.C measurement)."""
        obs = self._obs[report.grade]
        obs.total_s.append(report.total_duration_min * 60.0)
        obs.launch_s.append(report.stage_duration_min[Stage.APK_LAUNCH] * 60.0)
        obs.train_s.append(report.stage_duration_min[Stage.TRAINING] * 60.0)

    def observe_logical(self, grade: str, duration_s: float) -> None:
        """Record one measured logical bundle-group round duration (alpha)."""
        if duration_s <= 0:
            raise ValueError("logical round duration must be positive")
        self._obs[grade].logical_s.append(float(duration_s))

    # -- introspection ------------------------------------------------------
    def num_observations(self, grade: str) -> int:
        return self._obs[grade].num_device_rounds if grade in self._obs else 0

    @property
    def grades(self) -> tuple[str, ...]:
        return tuple(sorted(self._obs))

    def is_calibrated(self, grade: str) -> bool:
        return self.num_observations(grade) >= self.min_rounds

    # -- estimation ---------------------------------------------------------
    def _fallback(self, grade: str) -> GradeRuntime:
        if grade in self._prior:
            return self._prior[grade]
        if grade in GRADES:
            return table1_runtime(GRADES[grade])
        raise KeyError(
            f"grade {grade!r} has no observations, no prior, and no Table-I "
            "default — observe a fleet round or pass a prior runtime")

    def runtime(self, grade: str) -> GradeRuntime:
        """Measured ``GradeRuntime`` for ``grade`` (prior/Table-I fallback).

        Device-side rounds measure beta/lambda (and the alpha default);
        ``observe_logical`` recordings override alpha even when no device
        rounds have been seen yet (beta/lambda then come from the fallback).
        """
        obs = self._obs.get(grade)
        logical_s = obs.logical_s if obs is not None else []
        if not self.is_calibrated(grade):
            fb = self._fallback(grade)
            if not logical_s:
                return fb
            return GradeRuntime(alpha=float(np.mean(logical_s)),
                                beta=fb.beta, lam=fb.lam)
        lam = float(np.mean(obs.launch_s))
        beta = float(np.mean(obs.total_s)) - lam
        alpha = (float(np.mean(logical_s)) if logical_s
                 else float(np.mean(obs.train_s)))
        return GradeRuntime(alpha=alpha, beta=beta, lam=lam)

    def runtimes_for(self, grades: Iterable) -> list[GradeRuntime]:
        """Runtimes aligned with ``grades`` (names or ``GradeSpec``-likes)."""
        names = [g if isinstance(g, str) else g.grade for g in grades]
        return [self.runtime(name) for name in names]

    def for_task(self, task) -> list[GradeRuntime]:
        """Adapter matching ``TaskRunner``'s ``runtimes`` callable contract."""
        return self.runtimes_for(task.grades)

    def sample_for_task(self, task, rng: np.random.Generator
                        ) -> list[GradeRuntime]:
        """Sampled (not mean) runtimes for a task's grades.

        The event engine calls this when constructed with a
        ``duration_rng``: each scheduled round's timestamp is solved from one
        *observed* round per grade, so event times carry the fleet's measured
        round-to-round jitter instead of collapsing to the mean (the
        Monte-Carlo makespan direction from the PR 2 notes).
        """
        return self.sample_runtimes(task.grades, rng)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Resume-safe observation state (plain floats, JSON-friendly).

        A checkpointed ``TaskEngine`` re-solves allocations on restore with
        whatever runtimes provider it is given; when that provider is a
        calibrator, restoring these observations is what makes the resumed
        timeline reproduce the saved one (``table1_runtime`` cold-start
        fallbacks would otherwise replace the measured runtimes mid-task).
        """
        return {
            grade: {"total_s": list(obs.total_s),
                    "launch_s": list(obs.launch_s),
                    "train_s": list(obs.train_s),
                    "logical_s": list(obs.logical_s)}
            for grade, obs in self._obs.items()
        }

    def load_state_dict(self, d: Mapping) -> None:
        self._obs.clear()
        for grade, obs in d.items():
            self._obs[grade] = _GradeObservations(
                total_s=[float(x) for x in obs["total_s"]],
                launch_s=[float(x) for x in obs["launch_s"]],
                train_s=[float(x) for x in obs["train_s"]],
                logical_s=[float(x) for x in obs["logical_s"]],
            )

    def sample_runtimes(self, grades: Iterable, rng: np.random.Generator
                        ) -> list[GradeRuntime]:
        """Draw one observed round per grade instead of the mean.

        Feeding these into ``solve_allocation`` makes the makespan estimate
        reflect sampled (not mean) durations; grades without observations
        fall back to their prior/Table-I runtime.
        """
        out = []
        names = [g if isinstance(g, str) else g.grade for g in grades]
        for name in names:
            if not self.is_calibrated(name):
                out.append(self._fallback(name))
                continue
            obs = self._obs[name]
            i = int(rng.integers(len(obs.total_s)))
            lam = obs.launch_s[i]
            beta = max(obs.total_s[i] - lam, 1e-9)
            alpha = (obs.logical_s[int(rng.integers(len(obs.logical_s)))]
                     if obs.logical_s else obs.train_s[i])
            out.append(GradeRuntime(alpha=alpha, beta=beta, lam=lam))
        return out


# --------------------------------------------------------------------------- #
# Monte-Carlo schedule estimation (sampled timelines, not the mean)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ScheduleEstimate:
    """Distribution of one scheduling policy across N sampled timelines.

    Every array is one value per sampled timeline; the per-task dicts are
    keyed by ``task_id``.  Tasks that never completed in a sample carry
    ``nan`` there (stranded — e.g. nothing fits after a pool shrink), so
    ``nanmean``/``nanpercentile`` are the right reductions.
    """

    makespan_s: np.ndarray  # (n_samples,)
    queueing_delay_s: dict[int, np.ndarray]  # task_id -> (n_samples,)
    grant_utilization: dict[int, np.ndarray]  # task_id -> (n_samples,)

    @property
    def mean_makespan_s(self) -> float:
        return float(np.nanmean(self.makespan_s))

    @property
    def p95_makespan_s(self) -> float:
        return float(np.nanpercentile(self.makespan_s, 95))

    def mean_queueing_delay_s(self, task_id: int) -> float:
        return float(np.nanmean(self.queueing_delay_s[task_id]))

    def mean_grant_utilization(self, task_id: int) -> float:
        return float(np.nanmean(self.grant_utilization[task_id]))


def monte_carlo_schedules(
    tasks: Sequence,
    pool,
    runtimes,
    *,
    arrivals: Mapping[int, float] | None = None,
    modes: Sequence[bool] = (False, True),
    n_samples: int = 32,
    seed: int = 0,
    elastic: bool = True,
) -> dict[bool, ScheduleEstimate]:
    """Monte-Carlo makespan comparison: preemptive vs non-preemptive.

    Replays the same task set through a pure virtual-time ``TaskEngine``
    (no ``round_runner`` — round durations come from allocations solved on
    runtimes *sampled per round* via ``sample_for_task``/``duration_rng``)
    ``n_samples`` times per scheduling mode, each sample on an independent
    rng stream.  Both modes of sample ``i`` share one seed, so the
    comparison is paired: the same drawn timeline, scheduled two ways.

    ``tasks`` are template ``Task``s (re-submitted per sample — the engine
    never mutates them); ``pool`` is the ``ResourcePool`` to contend for;
    ``runtimes`` is anything ``TaskEngine`` accepts, but only a
    ``RuntimeCalibrator`` (with observations) gives the samples any spread.
    ``arrivals`` maps ``task_id`` to its submission time (default: all at
    t=0).  ``modes`` selects the preemptive flags to run (default: both).

    Returns ``{preemptive_flag: ScheduleEstimate}`` — per-task
    queueing-delay and grant-utilization distributions plus the makespan
    distribution, the quantitative case for (or against) preemption on a
    given workload.
    """
    # Engine imports live here: calibration is otherwise scheduler-free, and
    # the estimator is the one place the measurement loop drives scheduling.
    from repro_torch.core.scheduler import ResourceManager, TaskEngine

    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    arrivals = dict(arrivals or {})
    out: dict[bool, ScheduleEstimate] = {}
    for preemptive in modes:
        mk = np.full(n_samples, np.nan)
        qd = {t.task_id: np.full(n_samples, np.nan) for t in tasks}
        gu = {t.task_id: np.full(n_samples, np.nan) for t in tasks}
        for i in range(n_samples):
            engine = TaskEngine(
                ResourceManager(pool.copy()), runtimes,
                elastic=elastic, preemptive=preemptive,
                duration_rng=np.random.default_rng(
                    np.random.SeedSequence([seed, i])),
            )
            for t in tasks:
                engine.submit(t, at=arrivals.get(t.task_id))
            engine.run_until()
            mk[i] = engine.makespan
            for ex in engine.completed:
                qd[ex.task.task_id][i] = ex.queueing_delay_s
                gu[ex.task.task_id][i] = ex.grant_utilization
        out[preemptive] = ScheduleEstimate(
            makespan_s=mk, queueing_delay_s=qd, grant_utilization=gu)
    return out


def calibrate_runtimes(
    *,
    samples: Sequence[FleetRoundSample] = (),
    reports: Sequence[RoundReport] = (),
    logical_durations: Mapping[str, Sequence[float]] | None = None,
    prior: Mapping[str, GradeRuntime] | None = None,
) -> dict[str, GradeRuntime]:
    """One-shot calibration: observations in, per-grade ``GradeRuntime``s out.

    Returns measured runtimes for every grade that appears in the
    observations.  Convenience wrapper over ``RuntimeCalibrator`` for the
    common batch case (e.g. ``calibrate_runtimes(reports=tier.reports)``).
    """
    cal = RuntimeCalibrator(prior=prior)
    for s in samples:
        cal.observe_fleet(s)
    for r in reports:
        cal.observe_report(r)
    for grade, durs in (logical_durations or {}).items():
        for d in durs:
            cal.observe_logical(grade, d)
    return {g: cal.runtime(g) for g in cal.grades}
