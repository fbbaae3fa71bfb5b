"""Task Manager + Resource Manager (paper §III.B) + event-driven engine.

* ``ResourceManager`` — tracks the hybrid pool (logical bundles per grade and
  physical phones per grade), supports query/freeze/release and dynamic
  scale-up/down; ``subscribe`` notifies listeners (the event engine) of pool
  changes so allocations can be re-solved mid-task.
* ``TaskScheduler`` — greedy: repeatedly admit the highest-benefit task whose
  demand fits the free pool (benefit = scheduling priority, ties broken by
  submission order).
* ``TaskRunner`` — serial reference executor: solves the hybrid-allocation
  ILP (``core.allocation``) and drives one task's rounds to completion.  With
  a ``clock`` it also charges simulated time per round, which makes it the
  *serial baseline* the ``multi_task_schedule`` benchmark gates against.
* ``TaskEngine`` — the event-driven multi-task round engine (paper §IV.B's
  time-shared resource pool): per-task round events interleave on a shared
  ``VirtualClock`` instead of draining tasks back to back, queued tasks are
  admitted at event boundaries, and a task's allocation is re-solved when
  ``ResourceManager.scale`` changes the pool mid-task (elastic
  re-allocation, vs the paper's static split).  With ``preemptive=True`` a
  higher-priority arrival — or a ``scale(reclaim=True)`` pool shrink — may
  *refreeze down* lower-priority running grants at their next round-event
  boundary (pausing a task back to the queue when its grant clamps to
  zero), so priority expresses reclamation, not just admission order.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Iterable, Mapping

from repro_torch.core import allocation as alloc
from repro_torch.core.deviceflow import VirtualClock
from repro_torch.core.task import Task, TaskQueue


class TaskState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PAUSED = "paused"  # preempted to the queue; resumes with progress kept
    COMPLETED = "completed"
    FAILED = "failed"


@dataclasses.dataclass
class ResourcePool:
    """Free resources per grade: (logical bundles, physical phones)."""

    logical_bundles: dict[str, int]
    physical_devices: dict[str, int]

    def copy(self) -> "ResourcePool":
        return ResourcePool(dict(self.logical_bundles), dict(self.physical_devices))


class ResourceManager:
    def __init__(self, pool: ResourcePool):
        self._total = pool.copy()
        self._free = pool.copy()
        self._frozen: dict[int, dict[str, tuple[int, int]]] = {}
        self._listeners: list[Callable[[], None]] = []

    # -- query ---------------------------------------------------------------
    def free(self) -> ResourcePool:
        return self._free.copy()

    def total(self) -> ResourcePool:
        return self._total.copy()

    def deficit(self, grade: str) -> tuple[int, int]:
        """How far the free pool is below zero for ``grade``.

        Non-zero only after ``scale(..., reclaim=True)`` removed capacity
        that running tasks still hold; pool listeners (the ``TaskEngine``)
        pay it down by shrinking grants at round-event boundaries.
        """
        return (max(0, -self._free.logical_bundles.get(grade, 0)),
                max(0, -self._free.physical_devices.get(grade, 0)))

    def fits(self, demand: dict[str, tuple[int, int]]) -> bool:
        # Per component, and only where something is actually requested: a
        # zero component takes nothing, so it fits even while that
        # component's free pool is in deficit (``scale(reclaim=True)``).
        for grade, (bundles, phones) in demand.items():
            if bundles > 0 and self._free.logical_bundles.get(grade, 0) < bundles:
                return False
            if phones > 0 and self._free.physical_devices.get(grade, 0) < phones:
                return False
        return True

    def frozen(self, task_id: int) -> dict[str, tuple[int, int]] | None:
        """The grant currently frozen for ``task_id`` (None if none)."""
        got = self._frozen.get(task_id)
        return dict(got) if got is not None else None

    # -- freeze / release -------------------------------------------------------
    def freeze(self, task_id: int, demand: dict[str, tuple[int, int]]) -> None:
        if not self.fits(demand):
            raise ValueError(f"demand for task {task_id} does not fit free pool")
        for grade, (bundles, phones) in demand.items():
            self._free.logical_bundles[grade] = (
                self._free.logical_bundles.get(grade, 0) - bundles
            )
            self._free.physical_devices[grade] = (
                self._free.physical_devices.get(grade, 0) - phones
            )
        self._frozen[task_id] = dict(demand)

    def release(self, task_id: int) -> None:
        demand = self._frozen.pop(task_id, None)
        if demand is None:
            return
        for grade, (bundles, phones) in demand.items():
            self._free.logical_bundles[grade] = (
                self._free.logical_bundles.get(grade, 0) + bundles
            )
            self._free.physical_devices[grade] = (
                self._free.physical_devices.get(grade, 0) + phones
            )

    def refreeze(self, task_id: int, demand: dict[str, tuple[int, int]]) -> None:
        """Atomically replace a task's frozen grant (elastic re-allocation).

        Validates against the pool *as it would look after releasing the old
        grant* and raises without mutating anything when the new grant does
        not fit — a release-then-rollback would itself fail whenever the
        free pool is in deficit (``scale(reclaim=True)``), stranding the
        task's resources half-released.
        """
        old = self._frozen.get(task_id)
        if old is None:
            raise KeyError(f"task {task_id} holds no frozen resources")
        for grade, (bundles, phones) in demand.items():
            old_b, old_p = old.get(grade, (0, 0))
            # Validate per component, and only the GROWING ones: a component
            # at or below its old value releases capacity and is always
            # legal — even while that component's free pool is in deficit
            # (paying a deficit down must not be blocked by the deficit).
            if (bundles > old_b
                    and self._free.logical_bundles.get(grade, 0)
                    < bundles - old_b) or (
                    phones > old_p
                    and self._free.physical_devices.get(grade, 0)
                    < phones - old_p):
                raise ValueError(
                    f"refreeze for task {task_id} does not fit free pool")
        self.release(task_id)
        for grade, (bundles, phones) in demand.items():
            self._free.logical_bundles[grade] = (
                self._free.logical_bundles.get(grade, 0) - bundles
            )
            self._free.physical_devices[grade] = (
                self._free.physical_devices.get(grade, 0) - phones
            )
        self._frozen[task_id] = dict(demand)

    # -- elastic scaling (paper: "dynamic scaling up or down") ------------------
    def subscribe(self, fn: Callable[[], None]) -> None:
        """Register a pool-change listener (fired after every ``scale``)."""
        self._listeners.append(fn)

    def scale(self, grade: str, *, bundles_delta: int = 0,
              phones_delta: int = 0, reclaim: bool = False) -> None:
        """Add/remove capacity.

        Removal never takes frozen resources — unless ``reclaim=True``,
        which lets the free pool go *negative*: the shortfall is a recorded
        ``deficit`` that pool listeners (the ``TaskEngine``) pay down by
        refreezing running grants *down* at their next round-event boundary.
        ``free + frozen == total`` holds throughout either way.

        Both fields are validated before either is mutated (a rejected
        shrink must not leave the free/total pools inconsistent), and a
        zero-delta call is a no-op that does not fire listeners (no spurious
        re-solves).
        """
        deltas = (("logical_bundles", bundles_delta),
                  ("physical_devices", phones_delta))
        if bundles_delta == 0 and phones_delta == 0:
            return
        for field, delta in deltas:
            limit = getattr(self._total if reclaim else self._free, field)
            if delta < 0 and limit.get(grade, 0) + delta < 0:
                raise ValueError(
                    f"cannot remove {-delta} {field} of grade {grade}: "
                    f"only {limit.get(grade, 0)} "
                    f"{'total' if reclaim else 'free'}"
                )
        for field, delta in deltas:
            free = getattr(self._free, field)
            total = getattr(self._total, field)
            free[grade] = free.get(grade, 0) + delta
            total[grade] = total.get(grade, 0) + delta
        for fn in self._listeners:
            fn()


@dataclasses.dataclass
class ScheduledTask:
    task: Task
    allocation: alloc.AllocationResult
    state: TaskState = TaskState.QUEUED


class TaskScheduler:
    """Greedy scheduler (paper: maximize expected benefit under resources)."""

    def __init__(self, resources: ResourceManager):
        self.resources = resources

    def select(self, queue: TaskQueue) -> list[Task]:
        """Admit tasks in priority order while their demand fits."""
        admitted = []
        for task in queue.pending():
            demand = task.demand()
            if self.resources.fits(demand):
                self.resources.freeze(task.task_id, demand)
                queue.remove(task.task_id)
                admitted.append(task)
        return admitted


def _normalize_runtimes(runtimes) -> Callable[[Task], list[alloc.GradeRuntime]]:
    return runtimes.for_task if hasattr(runtimes, "for_task") else runtimes


def _run_tiers(tier_runners: Mapping[str, Callable[..., Any]], task: Task,
               allocation: alloc.AllocationResult, round_idx: int) -> None:
    """Execute one round's per-grade split through the tier callables."""
    for ga in allocation.per_grade:
        if ga.logical_devices:
            tier_runners["logical"](task, ga.grade, ga.logical_devices, round_idx)
        if ga.physical_devices:
            tier_runners["device"](task, ga.grade, ga.physical_devices, round_idx)


# RoundRunner contract: (task, round_idx, allocation, t) -> measured round
# duration in virtual seconds, or None to fall back to allocation.makespan.
RoundRunner = Callable[[Task, int, alloc.AllocationResult, float],
                       "float | None"]


class TaskRunner:
    """Serial reference executor for admitted tasks.

    ``runtimes`` supplies the per-grade ``GradeRuntime``s the allocator runs
    on: either a callable ``task -> list[GradeRuntime]`` or any object with a
    ``for_task`` method — e.g. a ``calibration.RuntimeCalibrator``, so the
    scheduler allocates on *measured* fleet durations instead of hand-coded
    constants.

    Round execution is either ``tier_runners`` (a map of tier name
    ("logical"/"device") to ``run(task, grade, num_devices, round_idx)``) or
    a ``round_runner`` callable ``(task, round_idx, allocation, t) ->
    duration_s | None`` shared with ``TaskEngine`` — so the serial baseline
    and the event engine execute rounds through identical code.

    With a ``clock``, each round advances the shared ``VirtualClock`` by the
    round's (measured or estimated) duration, so a serial drain reports a
    *simulated makespan* directly comparable to the event engine's.  This is
    deliberately the run-to-completion baseline: one task drains fully
    before the next starts.
    """

    def __init__(
        self,
        resources: ResourceManager,
        runtimes: Callable[[Task], list[alloc.GradeRuntime]],
        tier_runners: dict[str, Callable[..., list[Any]]] | None = None,
        *,
        round_runner: RoundRunner | None = None,
        clock: VirtualClock | None = None,
        on_round_complete: Callable[[Task, int], None] | None = None,
    ):
        if tier_runners is None and round_runner is None:
            raise ValueError("pass tier_runners or round_runner")
        self.resources = resources
        self.runtimes = _normalize_runtimes(runtimes)
        self.tier_runners = tier_runners
        self.round_runner = round_runner
        self.clock = clock
        self.on_round_complete = on_round_complete
        self.records: dict[int, ScheduledTask] = {}

    def run(self, task: Task) -> ScheduledTask:
        rts = self.runtimes(task)
        result = alloc.solve_allocation(list(task.grades), rts)
        rec = ScheduledTask(task=task, allocation=result, state=TaskState.RUNNING)
        self.records[task.task_id] = rec
        try:
            for round_idx in range(task.rounds):
                duration = None
                if self.round_runner is not None:
                    t = self.clock.now if self.clock is not None else 0.0
                    duration = self.round_runner(task, round_idx, result, t)
                else:
                    _run_tiers(self.tier_runners, task, result, round_idx)
                if self.on_round_complete is not None:
                    self.on_round_complete(task, round_idx)
                if self.clock is not None:
                    self.clock.advance(
                        duration if duration is not None else result.makespan)
            rec.state = TaskState.COMPLETED
        except Exception:
            rec.state = TaskState.FAILED
            raise
        finally:
            self.resources.release(task.task_id)
        return rec


# --------------------------------------------------------------------------- #
# Event-driven multi-task engine
# --------------------------------------------------------------------------- #
def _encode_allocation(a: alloc.AllocationResult) -> dict:
    return {"makespan": a.makespan,
            "per_grade": [dataclasses.asdict(g) for g in a.per_grade]}


def _decode_allocation(d: Mapping) -> alloc.AllocationResult:
    return alloc.AllocationResult(
        makespan=float(d["makespan"]),
        per_grade=tuple(
            alloc.GradeAllocation(
                grade=g["grade"],
                logical_devices=int(g["logical_devices"]),
                physical_devices=int(g["physical_devices"]),
                logical_time=float(g["logical_time"]),
                physical_time=float(g["physical_time"]))
            for g in d["per_grade"]))


@dataclasses.dataclass
class TaskExecution:
    """Live state of one admitted task inside ``TaskEngine``."""

    task: Task
    grant: dict[str, tuple[int, int]]  # resources currently frozen for it
    allocation: alloc.AllocationResult
    state: TaskState = TaskState.RUNNING
    rounds_done: int = 0
    started_t: float = 0.0
    submitted_t: float = 0.0
    next_event_t: float | None = None
    finished_t: float | None = None
    reallocations: int = 0  # elastic grant changes applied mid-task (both ways)
    preemptions: int = 0  # times this task was shrunk or paused by preemption
    # Reclamation marked by a higher-priority arrival / pool shrink; applied
    # (refreeze-down or pause) at this task's next round-event boundary.
    pending_shrink: dict[str, tuple[int, int]] | None = None
    # Admission cost-model audit trail (``preemption_cost_model=True``): one
    # entry per judged preemption attempt against this task —
    # {"t", "preemptor", "benefit_s", "cost_s", "preempted"}.
    preemption_decisions: list[dict] = dataclasses.field(default_factory=list)
    paused_t: float | None = None  # when the current pause began
    queued_s: float = 0.0  # total virtual time spent waiting in the queue
    running_s: float = 0.0  # total virtual time spent RUNNING (grant held)
    grant_seconds: float = 0.0  # ∫ (grant / full demand) dt while RUNNING
    accrued_t: float = 0.0  # last time the two integrals above were updated
    generation: int = 0  # invalidates stale scheduled events

    @property
    def full_grant(self) -> bool:
        return self.grant == self.task.demand()

    @property
    def queueing_delay_s(self) -> float:
        """Total virtual time spent waiting: submission→first start plus
        every preemption pause (the fairness metric preemptive scheduling
        trades against low-priority progress)."""
        return self.queued_s

    @property
    def grant_utilization(self) -> float:
        """Time-averaged fraction of the full demand actually held while
        running (1.0 = never clamped or shrunk)."""
        return self.grant_seconds / self.running_s if self.running_s > 0 else 0.0


class StrandedTasksError(RuntimeError):
    """Raised by ``TaskManager.drain(strict=True)`` when tasks are left in
    the queue (nothing fits, or ``max_cycles`` ran out)."""

    def __init__(self, stranded: list[Task], reason: str):
        self.stranded = stranded
        self.reason = reason
        super().__init__(
            f"{len(stranded)} task(s) stranded in queue ({reason}): "
            f"{[t.task_id for t in stranded]}")


class DrainResult(list):
    """``TaskManager.drain`` result: the completed ``ScheduledTask``s (list
    behavior preserved) plus explicit stranded-task reporting — a drain that
    leaves work in the queue is no longer indistinguishable from success."""

    def __init__(self, done: Iterable = (), stranded: Iterable[Task] = (),
                 reason: str | None = None):
        super().__init__(done)
        self.stranded: list[Task] = list(stranded)
        self.stranded_reason = reason if self.stranded else None


class TaskEngine:
    """Event-driven multi-task round engine on a shared ``VirtualClock``.

    Instead of draining each admitted task to completion (``TaskRunner``),
    every admitted task schedules its next *round event* on the clock; rounds
    of different tasks interleave in virtual-time order, so several tasks'
    ``RoundPlan``s time-share the same resource pool — the contention regime
    run-to-completion scheduling structurally cannot express.

    * **Admission at event boundaries** — whenever a task completes (or the
      pool changes), queued tasks are re-checked in priority order and
      admitted if a feasible grant exists.
    * **Elastic grants** — with ``elastic=True`` a task whose full demand
      does not fit may be admitted with its demand *clamped to the free
      pool* (any grant whose effective allocation is solvable); when
      resources free up — a task finishing, or ``ResourceManager.scale``
      growing the pool — running tasks top their grants back up toward the
      full request and their allocation is re-solved for the remaining
      rounds (``TaskExecution.reallocations`` counts the upgrades).
    * **Measured durations drive event timestamps** — round execution goes
      through the same ``round_runner``/``tier_runners`` contracts as
      ``TaskRunner``; a ``round_runner`` returning a measured duration (e.g.
      ``FederatedRoundOutcome.makespan_s``) times the next event, otherwise
      the allocation's estimated makespan does.  With both executors omitted
      the engine runs a pure virtual-time schedule (useful for scheduling
      studies and tests).  Passing a ``RuntimeCalibrator`` as ``runtimes``
      plus a ``duration_rng`` draws *sampled* observed runtimes per round,
      so event timestamps carry measured round-to-round jitter.
    * **Preemption** (``preemptive=True``) — a queued task whose demand does
      not fit may *reclaim* resources from strictly-lower-priority running
      tasks: victims are marked with a ``pending_shrink`` that applies at
      their next round-event boundary — the grant is refrozen *down* (the
      remaining rounds re-solved on the shrunken ``effective_grades``, and
      re-timed via ``RuntimeCalibrator.sample_for_task`` when a
      ``duration_rng`` is set) or, when clamped to zero, the task is PAUSED
      back to the queue with its round progress kept.  ``scale(...,
      reclaim=True)`` pool shrinks are paid down the same way (victims in
      ascending priority order), so the traffic controller's "dynamic
      scaling down" works even when the whole pool is frozen.  Every shrink
      and regrow counts in ``TaskExecution.reallocations``; per-task
      ``queueing_delay_s`` / ``grant_utilization`` quantify what preemption
      costs the victims.

    Share the clock with a ``DeviceFlow`` (``clock=flow.clock``) and round
    events interleave with dispatch/delivery events on one timeline.
    """

    def __init__(
        self,
        resources: ResourceManager,
        runtimes: Callable[[Task], list[alloc.GradeRuntime]],
        tier_runners: dict[str, Callable[..., list[Any]]] | None = None,
        *,
        round_runner: RoundRunner | None = None,
        clock: VirtualClock | None = None,
        elastic: bool = True,
        preemptive: bool = False,
        preemption_cost_model: bool = False,
        duration_rng=None,
        on_round_complete: Callable[[Task, int], None] | None = None,
        on_task_complete: Callable[[TaskExecution], None] | None = None,
    ):
        self.resources = resources
        self.runtimes = _normalize_runtimes(runtimes)
        self._calibrator = (runtimes if hasattr(runtimes, "sample_for_task")
                            else None)
        self.duration_rng = duration_rng
        self.tier_runners = tier_runners
        self.round_runner = round_runner
        self.clock = clock or VirtualClock()
        self.elastic = elastic
        self.preemptive = preemptive
        self.preemption_cost_model = preemption_cost_model
        self.on_round_complete = on_round_complete
        self.on_task_complete = on_task_complete
        self.queue = TaskQueue()
        self.executions: dict[int, TaskExecution] = {}
        self.completed: list[TaskExecution] = []
        self._submitted_t: dict[int, float] = {}
        # Deferred arrivals not yet on the queue: task -> arrival time.
        # Tracked (not just scheduled) so state_dict can serialize them —
        # clock callbacks themselves never survive a checkpoint.
        self._pending_arrivals: dict[int, tuple[Task, float]] = {}
        resources.subscribe(self._on_pool_change)

    # -- submission ---------------------------------------------------------
    def submit(self, task: Task, *, at: float | None = None) -> int:
        """Queue ``task``; with ``at`` the submission itself becomes a clock
        event (an *arrival*), so queueing delay is measured from then."""
        if at is not None and at > self.clock.now:
            self._pending_arrivals[task.task_id] = (task, float(at))
            self.clock.schedule(at, lambda: self._arrive(task.task_id))
            return task.task_id
        self._submitted_t.setdefault(task.task_id, self.clock.now)
        tid = self.queue.submit(task)
        self.clock.schedule(self.clock.now, self._admit)
        return tid

    def _arrive(self, tid: int) -> None:
        got = self._pending_arrivals.pop(tid, None)
        if got is not None:  # None: stale callback (restored elsewhere)
            self.submit(got[0])

    # -- allocation ---------------------------------------------------------
    def _round_runtimes(self, task: Task) -> list[alloc.GradeRuntime]:
        if self._calibrator is not None and self.duration_rng is not None:
            return self._calibrator.sample_for_task(task, self.duration_rng)
        return self.runtimes(task)

    def _solve(self, task: Task,
               grant: Mapping[str, tuple[int, int]]) -> alloc.AllocationResult:
        return alloc.solve_allocation(
            list(task.effective_grades(grant)), self._round_runtimes(task))

    def _grant_for(self, task: Task) -> dict[str, tuple[int, int]] | None:
        demand = task.demand()
        if self.resources.fits(demand):
            return demand
        if not self.elastic:
            return None
        free = self.resources.free()
        clamped = {
            # max(0): a reclaim deficit makes free components NEGATIVE — a
            # grant must never carry one (it would silently absorb the
            # deficit and oversubscribe the pool).
            g: (max(0, min(b, free.logical_bundles.get(g, 0))),
                max(0, min(p, free.physical_devices.get(g, 0))))
            for g, (b, p) in demand.items()
        }
        if not any(b or p for b, p in clamped.values()):
            return None
        return clamped

    # -- accounting ----------------------------------------------------------
    def _grant_frac(self, ex: TaskExecution) -> float:
        """Fraction of the task's full demand currently held (mean across
        the requested resource components)."""
        fracs = []
        for g, (rb, rp) in ex.task.demand().items():
            gb, gp = ex.grant.get(g, (0, 0))
            if rb:
                fracs.append(gb / rb)
            if rp:
                fracs.append(gp / rp)
        return sum(fracs) / len(fracs) if fracs else 1.0

    def _accrue(self, ex: TaskExecution) -> None:
        """Fold elapsed virtual time into the running/utilization integrals.

        Must be called *before* any grant or state change so the closing
        interval is weighted by the grant that was actually held."""
        now = self.clock.now
        dt = now - ex.accrued_t
        if ex.state is TaskState.RUNNING and dt > 0:
            ex.running_s += dt
            ex.grant_seconds += self._grant_frac(ex) * dt
        ex.accrued_t = now

    # -- event handlers ------------------------------------------------------
    def _admit(self) -> None:
        """Admit every queued task (priority order) with a feasible grant.

        PAUSED tasks ride the queue like fresh submissions (same priority
        ordering) and *resume* their existing execution — round progress,
        reallocation counts, and delay accounting carry over.  In
        ``preemptive`` mode, tasks still queued afterwards may mark
        refreeze-down shrinks on lower-priority running tasks.
        """
        now = self.clock.now
        for task in list(self.queue.pending()):
            tid = task.task_id
            paused = self.executions.get(tid)
            if paused is not None and paused.state is not TaskState.PAUSED:
                continue  # stale queue entry for a live/finished execution
            grant = self._grant_for(task)
            if grant is None:
                continue
            try:
                allocation = self._solve(task, grant)
            except ValueError:  # grant infeasible (a grade got no resources)
                continue
            self.resources.freeze(tid, grant)
            self.queue.remove(tid)
            if paused is not None:  # resume a preempted task
                ex = paused
                ex.queued_s += now - (ex.paused_t if ex.paused_t is not None
                                      else now)
                ex.paused_t = None
                ex.state = TaskState.RUNNING
                ex.grant = grant
                ex.allocation = allocation
                ex.reallocations += 1  # the regrow is a recorded re-allocation
                ex.accrued_t = now
            else:
                sub_t = self._submitted_t.get(tid, now)
                ex = TaskExecution(task=task, grant=grant,
                                   allocation=allocation, started_t=now,
                                   submitted_t=sub_t, queued_s=now - sub_t,
                                   accrued_t=now)
                self.executions[tid] = ex
            self._schedule(ex, now, self._round_event)
        if self.preemptive:
            for task in list(self.queue.pending()):
                self._mark_preemption(task)
            # A high-priority task elastically admitted on a *partial* grant
            # still deserves its remainder: reclaim it from lower-priority
            # running tasks too (its own held grant counts toward demand).
            for ex in sorted((e for e in self.executions.values()
                              if e.state is TaskState.RUNNING
                              and not e.full_grant),
                             key=lambda e: (-e.task.priority, e.task.task_id)):
                self._mark_preemption(ex.task, held=ex.grant)

    def _pending_totals(self) -> dict[str, list[int]]:
        """Per-grade reclamation already marked but not yet applied."""
        tot: dict[str, list[int]] = {}
        for ex in self.executions.values():
            if ex.state is TaskState.RUNNING and ex.pending_shrink:
                for g, (b, p) in ex.pending_shrink.items():
                    cur = tot.setdefault(g, [0, 0])
                    cur[0] += b
                    cur[1] += p
        return tot

    def _mark_shrinks(self, deficit: dict[str, list[int]],
                      victims: Iterable[TaskExecution],
                      judge: Callable[[TaskExecution,
                                       dict[str, tuple[int, int]]],
                                      bool] | None = None) -> None:
        """Spread ``deficit`` across ``victims`` as pending shrinks (applied
        at each victim's next round-event boundary).  ``judge`` — the
        preemption admission cost model — may veto a victim's marked take;
        the vetoed share stays in the deficit for later victims (or goes
        unmet: partial preemption is still progress)."""
        for ex in victims:
            if not deficit:
                return
            take: dict[str, tuple[int, int]] = {}
            for g in list(deficit):
                db, dp = deficit[g]
                gb, gp = ex.grant.get(g, (0, 0))
                pb, pp = (ex.pending_shrink or {}).get(g, (0, 0))
                tb, tp = min(gb - pb, db), min(gp - pp, dp)
                if tb or tp:
                    take[g] = (tb, tp)
            if not take:
                continue
            if judge is not None and not judge(ex, take):
                continue
            for g, (tb, tp) in take.items():
                db, dp = deficit[g]
                db, dp = db - tb, dp - tp
                if db <= 0 and dp <= 0:
                    deficit.pop(g)
                else:
                    deficit[g] = [db, dp]
            merged = dict(ex.pending_shrink or {})
            for g, (tb, tp) in take.items():
                ob, op = merged.get(g, (0, 0))
                merged[g] = (ob + tb, op + tp)
            ex.pending_shrink = merged

    def _mark_preemption(self, task: Task,
                         held: Mapping[str, tuple[int, int]] | None = None,
                         ) -> None:
        """Mark enough lower-priority running grants for reclamation that
        ``task``'s full demand would fit (what can't be covered stays
        unmarked — partial preemption is still progress under elastic
        admission).  ``held`` is the task's own current grant when it is
        already running on a partial one."""
        held = held or {}
        free = self.resources.free()
        pending = self._pending_totals()
        deficit: dict[str, list[int]] = {}
        for g, (b, p) in task.demand().items():
            hb, hp = held.get(g, (0, 0))
            db = (b - hb - free.logical_bundles.get(g, 0)
                  - pending.get(g, [0, 0])[0])
            dp = (p - hp - free.physical_devices.get(g, 0)
                  - pending.get(g, [0, 0])[1])
            if db > 0 or dp > 0:
                deficit[g] = [max(db, 0), max(dp, 0)]
        if not deficit:
            return
        victims = sorted(
            (ex for ex in self.executions.values()
             if ex.state is TaskState.RUNNING
             and ex.task.task_id != task.task_id
             and ex.task.priority < task.priority),
            key=lambda ex: (ex.task.priority, -ex.started_t, -ex.task.task_id))
        judge = (self._preemption_judge(task, victims)
                 if self.preemption_cost_model else None)
        self._mark_shrinks(deficit, victims, judge)

    # -- preemption admission cost model -------------------------------------
    def _preemption_judge(self, task: Task, victims: list[TaskExecution]):
        """Admission cost model (``preemption_cost_model=True``): preempt a
        victim only when the preemptor's priority-weighted benefit exceeds
        the victim's priority-weighted re-timed lost work.

        *Benefit* — the wait the preemptor avoids: without preemption it
        queues until the earliest natural completion among the candidate
        victims, weighted by its priority.  *Cost* — what the victim loses:
        its remaining rounds re-timed on the shrunken grant (solved through
        the allocator), or, for a full pause, the span it sits paused (the
        preemptor's own estimated runtime), weighted by the victim's
        priority.  Every judged attempt is logged on the victim's
        ``TaskExecution.preemption_decisions``.
        """
        waits = [max(ex.task.rounds - ex.rounds_done, 0)
                 * ex.allocation.makespan for ex in victims]
        wait_s = min((w for w in waits if w > 0), default=0.0)
        benefit = max(task.priority, 1) * wait_s

        def judge(ex: TaskExecution,
                  take: dict[str, tuple[int, int]]) -> bool:
            cost = self._shrink_cost_s(task, ex, take)
            ok = benefit > cost
            ex.preemption_decisions.append({
                "t": self.clock.now, "preemptor": task.task_id,
                "benefit_s": benefit, "cost_s": cost, "preempted": ok})
            return ok

        return judge

    def _shrink_cost_s(self, task: Task, ex: TaskExecution,
                       take: dict[str, tuple[int, int]]) -> float:
        """Victim's re-timed lost work if ``take`` is reclaimed from it."""
        remaining = max(ex.task.rounds - ex.rounds_done, 0)
        old_span = ex.allocation.makespan
        pending = ex.pending_shrink or {}
        new_grant = {
            g: (max(0, b - pending.get(g, (0, 0))[0]
                    - take.get(g, (0, 0))[0]),
                max(0, p - pending.get(g, (0, 0))[1]
                    - take.get(g, (0, 0))[1]))
            for g, (b, p) in ex.grant.items()
        }
        weight = max(ex.task.priority, 1)
        if any(b or p for b, p in new_grant.values()):
            try:
                new_span = self._solve(ex.task, new_grant).makespan
                return weight * remaining * max(new_span - old_span, 0.0)
            except ValueError:
                pass  # infeasible shrink — the victim would pause instead
        # Full pause: the victim's lost work is the span it sits paused,
        # i.e. the preemptor's own estimated runtime on its full demand.
        try:
            pre_span = self._solve(task, task.demand()).makespan
        except ValueError:
            pre_span = old_span
        return weight * task.rounds * pre_span

    def _reclaim_deficit(self) -> None:
        """Mark shrinks that pay down a ``scale(reclaim=True)`` pool deficit
        (negative free).  Victims in ascending priority order — capacity
        loss is not a priority contest, but the cheapest tasks shed first."""
        free = self.resources.free()
        pending = self._pending_totals()
        deficit: dict[str, list[int]] = {}
        for pool, i in ((free.logical_bundles, 0), (free.physical_devices, 1)):
            for g, v in pool.items():
                short = -v - pending.get(g, [0, 0])[i]
                if short > 0:
                    deficit.setdefault(g, [0, 0])[i] = short
        if not deficit:
            return
        victims = sorted(
            (ex for ex in self.executions.values()
             if ex.state is TaskState.RUNNING),
            key=lambda ex: (ex.task.priority, -ex.started_t, -ex.task.task_id))
        self._mark_shrinks(deficit, victims)

    def _rebalance(self) -> None:
        """Top running tasks' grants back up toward their full demand and
        re-solve their allocations (elastic re-allocation).  The in-flight
        round keeps its already-scheduled completion time; the new split
        applies from the next round."""
        if not self.elastic:
            return
        queued_prio = max((t.priority for t in self.queue.pending()),
                          default=None)
        running = sorted(
            (ex for ex in self.executions.values()
             if ex.state is TaskState.RUNNING and not ex.full_grant),
            key=lambda ex: (-ex.task.priority, ex.task.task_id))
        for ex in running:
            if ex.pending_shrink:
                continue  # marked for reclamation; don't fight the preemption
            if (self.preemptive and queued_prio is not None
                    and queued_prio > ex.task.priority):
                # A higher-priority task is waiting: freed resources belong
                # to it, not to lower-priority top-ups (priority inversion).
                continue
            free = self.resources.free()
            demand = ex.task.demand()
            upgraded = {
                # max(): with a reclaim deficit the free pool can be
                # negative — top-ups never shrink a grant (that only happens
                # at round boundaries via pending_shrink).
                g: (max(ex.grant[g][0],
                        min(rb, ex.grant[g][0]
                            + free.logical_bundles.get(g, 0))),
                    max(ex.grant[g][1],
                        min(rp, ex.grant[g][1]
                            + free.physical_devices.get(g, 0))))
                for g, (rb, rp) in demand.items()
            }
            if upgraded == ex.grant:
                continue
            try:
                allocation = self._solve(ex.task, upgraded)
            except ValueError:
                continue
            self.resources.refreeze(ex.task.task_id, upgraded)
            self._accrue(ex)
            ex.grant = upgraded
            ex.allocation = allocation
            ex.reallocations += 1

    def _on_pool_change(self) -> None:
        # Deferred to an event so mid-round scale() calls take effect at the
        # next event boundary, like every other engine state change.
        self.clock.schedule(self.clock.now, self._pool_change_event)

    def _pool_change_event(self) -> None:
        self._reclaim_deficit()
        self._rebalance()
        self._admit()

    def _schedule(self, ex: TaskExecution, t: float, handler) -> None:
        ex.generation += 1
        gen = ex.generation
        ex.next_event_t = t
        tid = ex.task.task_id
        self.clock.schedule(t, lambda: handler(tid, gen))

    def _apply_shrink(self, ex: TaskExecution) -> None:
        """Refreeze a victim's grant *down* at its round-event boundary.

        The grant loses the marked reclamation; the remaining rounds are
        re-solved (and re-timed, when sampling) on the shrunken
        ``effective_grades``.  A grant clamped to zero — or one the
        allocator can't solve (a grade lost both tiers while still owing
        devices) — pauses the task back to the queue instead, progress kept.
        """
        shrink = ex.pending_shrink or {}
        ex.pending_shrink = None
        new_grant = {
            g: (max(0, b - shrink.get(g, (0, 0))[0]),
                max(0, p - shrink.get(g, (0, 0))[1]))
            for g, (b, p) in ex.grant.items()
        }
        self._accrue(ex)
        if not any(b or p for b, p in new_grant.values()):
            self._pause(ex)
            return
        try:
            allocation = self._solve(ex.task, new_grant)
            self.resources.refreeze(ex.task.task_id, new_grant)
        except ValueError:
            # Infeasible shrink (or a pool deficit deeper than the marked
            # reclamation): shed the whole grant instead of wedging.
            self._pause(ex)
            return
        ex.grant = new_grant
        ex.allocation = allocation
        ex.reallocations += 1
        ex.preemptions += 1

    def _pause(self, ex: TaskExecution) -> None:
        """Preempt ``ex`` entirely: release its resources and send the task
        back to the queue.  ``rounds_done`` is kept — a resumed task picks
        up where it was paused, it does not restart."""
        self._accrue(ex)
        self.resources.release(ex.task.task_id)
        ex.state = TaskState.PAUSED
        ex.paused_t = self.clock.now
        ex.next_event_t = None
        ex.generation += 1  # invalidate any scheduled round event
        ex.preemptions += 1
        self.queue.submit(ex.task)

    def _round_event(self, tid: int, gen: int) -> None:
        ex = self.executions.get(tid)
        if ex is None or ex.generation != gen or ex.state is not TaskState.RUNNING:
            return  # stale event (task rescheduled/failed meanwhile)
        if ex.pending_shrink:
            # Round-event boundary: apply the marked reclamation before the
            # next round runs, then let the freed capacity admit/top-up the
            # preemptor at this same timestamp.  Any deficit the shrink
            # could not fully cover is re-marked on the remaining victims.
            self._apply_shrink(ex)
            self._reclaim_deficit()
            self._rebalance()
            self._admit()
            if ex.state is not TaskState.RUNNING:
                return  # paused to the queue; no round to run
        round_idx = ex.rounds_done
        t = self.clock.now
        duration = None
        try:
            if self.round_runner is not None:
                duration = self.round_runner(ex.task, round_idx, ex.allocation, t)
            elif self.tier_runners is not None:
                _run_tiers(self.tier_runners, ex.task, ex.allocation, round_idx)
        except Exception:
            self._accrue(ex)
            ex.state = TaskState.FAILED
            ex.next_event_t = None
            self.resources.release(tid)
            raise
        if duration is None:
            duration = ex.allocation.makespan
        ex.rounds_done += 1
        if self.on_round_complete is not None:
            self.on_round_complete(ex.task, round_idx)
        if ex.rounds_done >= ex.task.rounds:
            # The task occupies its resources until the last round's slowest
            # device reports — release at t + duration, not at dispatch.
            self._schedule(ex, t + duration, self._completion_event)
        else:
            self._schedule(ex, t + duration, self._round_event)

    def _completion_event(self, tid: int, gen: int) -> None:
        ex = self.executions.get(tid)
        if ex is None or ex.generation != gen or ex.state is not TaskState.RUNNING:
            return
        self._accrue(ex)
        ex.state = TaskState.COMPLETED
        ex.finished_t = self.clock.now
        ex.next_event_t = None
        self.resources.release(tid)
        self.completed.append(ex)
        if self.on_task_complete is not None:
            self.on_task_complete(ex)
        # Event boundary: freed resources may fit queued tasks or top up
        # running elastic grants (or settle a leftover reclaim deficit).
        self._reclaim_deficit()
        self._rebalance()
        self._admit()

    # -- driving -------------------------------------------------------------
    def run_until(self, t_end: float = float("inf")) -> list[TaskExecution]:
        """Drive the clock; returns tasks completed so far."""
        self.clock.run_until(t_end)
        return self.completed

    def drain(self) -> DrainResult:
        """Run until the event heap empties; reports stranded tasks."""
        self.run_until()
        stranded = list(self.queue.pending())
        return DrainResult(self.completed, stranded,
                           "nothing-fits" if stranded else None)

    @property
    def makespan(self) -> float:
        """Virtual time of the latest task completion so far."""
        return max((ex.finished_t for ex in self.completed
                    if ex.finished_t is not None), default=0.0)

    # -- checkpointing --------------------------------------------------------
    def state_dict(self, deviceflow=None, *, fleets=None,
                   services=None) -> dict:
        """Resume-safe engine state (JSON-friendly; no Task objects).

        Captures the queue order, every live execution's grant/progress and
        its next scheduled event time, and the clock.  Tasks themselves are
        *not* serialized — like ``DeviceFlow.load_state_dict`` after
        ``register_task``, the caller re-supplies the ``Task`` objects on
        restore.

        ``deviceflow`` (optional) embeds the message plane's shelves and
        dispatcher state in the same snapshot — one unified engine state
        covering scheduled round events AND in-flight arrivals (including
        columnar ``ArrivalBatch`` segments, whose update buffers are
        materialized to host arrays by ``Shelf.state_dict``).

        ``fleets`` (optional, ``{name: DeviceFleet}`` — e.g.
        ``HybridSimulation.fleets``) folds every fleet's per-device RNG
        counters into the same snapshot, and ``services`` (optional,
        ``{task_id: AggregationService}``) folds in aggregation state
        including streaming partial sums.  Together this makes ONE manifest
        the atomic unit of a running simulation — engine events, message
        plane, fleet randomness, and half-reduced rounds snapshot/restore
        as a unit instead of as separate ``extra`` entries (the
        coordinator/worker contract of ``runtime.workers``: workers hold
        no authoritative state, so this manifest IS the simulation).
        """
        def enc(ex: TaskExecution) -> dict:
            return {
                "task_id": ex.task.task_id,
                "grant": {g: list(bp) for g, bp in ex.grant.items()},
                "state": ex.state.value,
                "rounds_done": ex.rounds_done,
                "started_t": ex.started_t,
                "submitted_t": ex.submitted_t,
                "next_event_t": ex.next_event_t,
                "finished_t": ex.finished_t,
                "reallocations": ex.reallocations,
                "preemptions": ex.preemptions,
                "pending_shrink": (
                    None if ex.pending_shrink is None
                    else {g: list(bp) for g, bp in ex.pending_shrink.items()}),
                "preemption_decisions": [dict(d)
                                         for d in ex.preemption_decisions],
                "paused_t": ex.paused_t,
                "queued_s": ex.queued_s,
                "running_s": ex.running_s,
                "grant_seconds": ex.grant_seconds,
                "accrued_t": ex.accrued_t,
                # The solved allocation is saved verbatim: restoring it
                # (instead of re-solving) keeps a sampling engine's
                # duration_rng stream aligned with the uninterrupted run.
                "allocation": _encode_allocation(ex.allocation),
            }

        state = {
            "now": self.clock.now,
            "queue": [t.task_id for t in self.queue.pending()],
            "submitted_t": {int(tid): t
                            for tid, t in self._submitted_t.items()},
            "arrivals": {int(tid): t
                         for tid, (_, t) in self._pending_arrivals.items()},
            "executions": [enc(ex) for ex in self.executions.values()],
        }
        if self.duration_rng is not None:
            # PCG64-style state dicts are plain ints/strings — JSON-safe —
            # so a restored engine draws the exact same sampled runtimes.
            state["duration_rng"] = self.duration_rng.bit_generator.state
        if deviceflow is not None:
            state["deviceflow"] = deviceflow.state_dict()
        if fleets is not None:
            state["fleets"] = {str(name): fleet.state_dict()
                               for name, fleet in dict(fleets).items()}
        if services is not None:
            state["aggregation"] = {int(tid): svc.state_dict()
                                    for tid, svc in dict(services).items()}
        return state

    def load_state_dict(self, state: Mapping,
                        tasks: Iterable[Task],
                        deviceflow=None, *, fleets=None,
                        services=None) -> None:
        """Rebuild engine state from ``state_dict`` output.

        ``tasks`` supplies the Task objects referenced by the saved state
        (any iterable; matched by ``task_id``).  Requires a fresh engine on
        a fresh ``ResourceManager`` (grants are re-frozen here).  Pending
        round events are rescheduled at their saved timestamps and each
        execution's solved allocation is restored *verbatim* (legacy states
        without one are re-solved), so a restored run continues on the
        exact same virtual timeline — a ``RuntimeCalibrator`` runtimes
        provider must still have its observations reloaded first
        (``RuntimeCalibrator.load_state_dict``), and a ``duration_rng``
        engine additionally restores the saved generator state so resumed
        sampled event times match the uninterrupted run draw for draw.
        PAUSED (preempted) executions restore un-frozen and un-scheduled;
        they sit in the restored queue and resume at the next event
        boundary that fits them, exactly like the live engine.

        ``deviceflow`` (optional) receives the embedded message-plane state
        when the snapshot carries one (``state_dict(deviceflow=...)``) —
        call ``register_task`` for every task first so dispatchers rebind.
        ``fleets`` / ``services`` likewise receive the fleet RNG counters
        and aggregation partials the one-manifest snapshot carries (matched
        by name / task id; missing sections are ignored for legacy states).
        """
        by_id = {t.task_id: t for t in tasks}
        if deviceflow is not None and "deviceflow" in state:
            deviceflow.load_state_dict(state["deviceflow"])
        if fleets is not None:
            for name, fstate in state.get("fleets", {}).items():
                fleet = dict(fleets).get(name)
                if fleet is not None:
                    fleet.load_state_dict(fstate)
        if services is not None:
            for tid, sstate in state.get("aggregation", {}).items():
                svc = dict(services).get(int(tid))
                if svc is not None:
                    svc.load_state_dict(sstate)
        self.clock.now = float(state["now"])
        if self.duration_rng is not None and "duration_rng" in state:
            self.duration_rng.bit_generator.state = state["duration_rng"]
        for tid in state["queue"]:
            self.queue.submit(by_id[int(tid)])
        for tid, t in state.get("submitted_t", {}).items():
            self._submitted_t[int(tid)] = float(t)
        for tid, t in state.get("arrivals", {}).items():
            # Re-schedule deferred arrivals saved before they fired.
            self.submit(by_id[int(tid)], at=float(t))
        for enc in state["executions"]:
            tid = int(enc["task_id"])
            task = by_id[tid]
            grant = {g: (int(bp[0]), int(bp[1]))
                     for g, bp in enc["grant"].items()}
            pending = enc.get("pending_shrink")
            ex = TaskExecution(
                task=task, grant=grant,
                allocation=(_decode_allocation(enc["allocation"])
                            if enc.get("allocation") is not None
                            else self._solve(task, grant)),
                state=TaskState(enc["state"]),
                rounds_done=int(enc["rounds_done"]),
                started_t=float(enc["started_t"]),
                submitted_t=float(enc.get("submitted_t", enc["started_t"])),
                finished_t=(None if enc["finished_t"] is None
                            else float(enc["finished_t"])),
                reallocations=int(enc["reallocations"]),
                preemptions=int(enc.get("preemptions", 0)),
                pending_shrink=(
                    None if pending is None
                    else {g: (int(bp[0]), int(bp[1]))
                          for g, bp in pending.items()}),
                preemption_decisions=[
                    dict(d) for d in enc.get("preemption_decisions", [])],
                paused_t=(None if enc.get("paused_t") is None
                          else float(enc["paused_t"])),
                queued_s=float(enc.get("queued_s", 0.0)),
                running_s=float(enc.get("running_s", 0.0)),
                grant_seconds=float(enc.get("grant_seconds", 0.0)),
                accrued_t=float(enc.get("accrued_t", self.clock.now)),
            )
            self.executions[tid] = ex
            if ex.state is TaskState.RUNNING:
                self.resources.freeze(tid, grant)
                if enc["next_event_t"] is not None:
                    t = float(enc["next_event_t"])
                    handler = (self._completion_event
                               if ex.rounds_done >= task.rounds
                               else self._round_event)
                    self._schedule(ex, t, handler)
            elif ex.state is TaskState.COMPLETED:
                self.completed.append(ex)
        self.clock.schedule(self.clock.now, self._admit)


class TaskManager:
    """Facade: queue + scheduler + runner (paper's *Task Manager* service).

    ``drain`` is the serial run-to-completion path — kept as the measured
    baseline; use a ``TaskEngine`` on a shared clock for event-driven
    multi-task rounds.
    """

    def __init__(self, resources: ResourceManager, runner: TaskRunner):
        self.queue = TaskQueue()
        self.scheduler = TaskScheduler(resources)
        self.runner = runner

    def submit(self, task: Task) -> int:
        return self.queue.submit(task)

    def step(self) -> list[ScheduledTask]:
        """One scheduling cycle: admit what fits, run to completion."""
        done = []
        for task in self.scheduler.select(self.queue):
            done.append(self.runner.run(task))
        return done

    def drain(self, max_cycles: int = 1000, *, strict: bool = False
              ) -> DrainResult:
        """Run scheduling cycles until the queue empties.

        Previously a non-empty queue at exit (nothing fits, or
        ``max_cycles`` exhausted) looked identical to success; the result
        now reports ``stranded`` tasks and ``stranded_reason`` explicitly,
        and ``strict=True`` raises ``StrandedTasksError`` instead.
        """
        done: list[ScheduledTask] = []
        reason = None
        for _ in range(max_cycles):
            if not len(self.queue):
                break
            got = self.step()
            if not got:  # nothing fits — resources exhausted for now
                reason = "nothing-fits"
                break
            done.extend(got)
        else:
            if len(self.queue):
                reason = "max-cycles-exhausted"
        out = DrainResult(done, self.queue.pending(), reason)
        if strict and out.stranded:
            raise StrandedTasksError(out.stranded, reason or "unknown")
        return out
