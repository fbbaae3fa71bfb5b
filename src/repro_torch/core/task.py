"""Task design specification (paper §III.A).

A *task* is SimDC's core operational unit: a unique ``task_id``, a single
*operator flow* (an ordered sequence of named operators that every simulated
device executes uniformly), per-grade device counts, the number of rounds
(repetitions of the operator flow), requested resources, and a scheduling
priority.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Mapping, Sequence

_TASK_COUNTER = itertools.count()

# Registry of named operators usable inside an operator flow.  Operators are
# pure callables ``op(state, ctx) -> state`` so flows are replayable and
# checkpointable.
_OPERATOR_REGISTRY: dict[str, Callable[..., Any]] = {}


def register_operator(name: str):
    """Decorator registering an operator implementation under ``name``."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        if name in _OPERATOR_REGISTRY:
            raise ValueError(f"operator {name!r} already registered")
        _OPERATOR_REGISTRY[name] = fn
        return fn

    return deco


def get_operator(name: str) -> Callable[..., Any]:
    try:
        return _OPERATOR_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"operator {name!r} not registered; known: {sorted(_OPERATOR_REGISTRY)}"
        ) from None


def clear_operator_registry() -> None:  # test hook
    _OPERATOR_REGISTRY.clear()


@dataclasses.dataclass(frozen=True)
class OperatorFlow:
    """An ordered sequence of operator names, executed uniformly per device."""

    operators: tuple[str, ...]

    def __post_init__(self):
        if not self.operators:
            raise ValueError("operator flow must contain at least one operator")

    def resolve(self) -> tuple[Callable[..., Any], ...]:
        return tuple(get_operator(n) for n in self.operators)


@dataclasses.dataclass(frozen=True)
class GradeSpec:
    """Per-grade simulation demand within a task (paper §IV.B symbols)."""

    grade: str
    num_devices: int  # N_i — total devices of this grade to simulate
    benchmarking_devices: int = 0  # q_i — physical devices reserved for measurement
    logical_bundles: int = 0  # f_i — resource bundles requested in Logical Simulation
    bundles_per_device: int = 1  # k_i — bundles needed to emulate ONE device
    physical_devices: int = 0  # m_i — physical phones requested in Device Simulation

    def __post_init__(self):
        if self.num_devices < 0 or self.benchmarking_devices < 0:
            raise ValueError("device counts must be non-negative")
        if self.benchmarking_devices > self.num_devices:
            raise ValueError("q_i cannot exceed N_i")
        if self.bundles_per_device <= 0:
            raise ValueError("k_i must be positive")

    @property
    def allocatable_devices(self) -> int:
        """N_i - q_i — devices the §IV.B allocator may split across tiers
        (the q_i benchmarking devices are reserved for measurement)."""
        return self.num_devices - self.benchmarking_devices

    def with_resources(self, logical_bundles: int,
                       physical_devices: int) -> "GradeSpec":
        """This grade under an elastic resource grant: same devices to
        simulate, granted (instead of requested) tier resources.  The event
        engine re-solves allocations against these effective specs whenever
        a task's grant changes mid-run."""
        return dataclasses.replace(
            self, logical_bundles=logical_bundles,
            physical_devices=physical_devices)


@dataclasses.dataclass
class Task:
    """A SimDC task (paper §III.A)."""

    flow: OperatorFlow
    grades: tuple[GradeSpec, ...]
    rounds: int = 1
    priority: int = 0  # higher = more urgent (expected benefit proxy)
    deviceflow_strategy: Any | None = None  # strategy object from core.strategies
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    task_id: int = dataclasses.field(default_factory=lambda: next(_TASK_COUNTER))

    def __post_init__(self):
        if self.rounds <= 0:
            raise ValueError("rounds must be positive")
        if not self.grades:
            raise ValueError("task must request at least one device grade")
        seen = set()
        for g in self.grades:
            if g.grade in seen:
                raise ValueError(f"duplicate grade {g.grade!r} in task")
            seen.add(g.grade)

    @property
    def total_devices(self) -> int:
        return sum(g.num_devices for g in self.grades)

    def demand(self) -> dict[str, tuple[int, int]]:
        """Resource demand per grade: (logical bundles, physical devices)."""
        return {g.grade: (g.logical_bundles, g.physical_devices) for g in self.grades}

    def effective_grades(
        self, grant: Mapping[str, tuple[int, int]]
    ) -> tuple[GradeSpec, ...]:
        """Grade specs under a (possibly clamped) resource grant.

        Grades absent from ``grant`` keep their requested resources.  This is
        how the event engine expresses elastic allocation: a task admitted
        with less than its full demand is solved against the resources it
        actually holds, and re-solved when the grant changes.
        """
        out = []
        for g in self.grades:
            bundles, phones = grant.get(
                g.grade, (g.logical_bundles, g.physical_devices))
            out.append(g.with_resources(bundles, phones))
        return tuple(out)


class TaskQueue:
    """FIFO-with-priority queue of submitted tasks (paper: *Task Queue*).

    Preempted (paused) tasks re-enter through the same ``submit`` path: they
    keep their original ``task_id``, so ``pending`` ranks a resumed task
    exactly where its priority and submission order put it the first time —
    a pause changes *when* a task runs, never its place in line.
    """

    def __init__(self) -> None:
        self._tasks: list[Task] = []

    def submit(self, task: Task) -> int:
        if task.task_id in self:
            # A duplicate would double-admit and double-freeze resources
            # (e.g. pausing a task that was never removed from the queue).
            raise ValueError(f"task {task.task_id} already queued")
        self._tasks.append(task)
        return task.task_id

    def __len__(self) -> int:
        return len(self._tasks)

    def __contains__(self, task_id: int) -> bool:
        return any(t.task_id == task_id for t in self._tasks)

    def pending(self) -> Sequence[Task]:
        # Stable order: priority desc, then submission order (task_id asc).
        return sorted(self._tasks, key=lambda t: (-t.priority, t.task_id))

    def remove(self, task_id: int) -> Task:
        for i, t in enumerate(self._tasks):
            if t.task_id == task_id:
                return self._tasks.pop(i)
        raise KeyError(f"task {task_id} not in queue")
