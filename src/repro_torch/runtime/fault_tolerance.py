"""Fault tolerance & elasticity for the SimDC platform at cluster scale.

Three layers, matching the failure domains of a 1000+-node deployment:

1. **Client/device failures** are *first-class inputs* in SimDC (dropout
   strategies, DeviceFlow §V) — aggregation triggers never block on absent
   clients, and over-selection + deadlines bound round time.

2. **Server/trainer failures** — checkpoint/restart (``checkpoint``), retry
   wrappers with bounded backoff, and a restart protocol that resumes
   mid-federated-round from the persisted DeviceFlow shelves.

3. **Resource-pool changes** — elastic rescale: when phones or bundles join
   or leave, the allocation ILP is re-solved for the surviving pool and the
   task continues with the new split (the makespan argument of §IV.B holds
   per-round, so re-solving between rounds is optimal-per-round).

4. **Simulation-worker failures** (``runtime.workers``) — a cohort worker
   process dying mid-round must not hang the coordinator's round barrier:
   :func:`redispatch_chunks` re-assigns the dead shard's still-pending
   cohort chunks round-robin over the survivors, and the pool records a
   :class:`WorkerFailure` per event.  The re-dispatched chunks rerun with
   their original rng subkeys, so the round's *result* is unchanged — only
   its wall-clock and (for int8) the dead shard's error-feedback residual
   (restarted at zero, like a fresh device) pay for the failure.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.core import allocation as alloc
from repro_torch.core.scheduler import ResourceManager
from repro_torch.core.task import GradeSpec


@dataclasses.dataclass
class RetryPolicy:
    max_attempts: int = 3
    backoff_s: float = 0.1
    backoff_mult: float = 2.0
    retryable: tuple[type[BaseException], ...] = (RuntimeError, OSError)


def with_retries(fn: Callable, policy: RetryPolicy = RetryPolicy(),
                 *, on_retry: Callable[[int, BaseException], None] | None = None):
    """Wrap a step/IO function with bounded-backoff retries."""

    def wrapped(*args, **kwargs):
        delay = policy.backoff_s
        for attempt in range(1, policy.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except policy.retryable as e:
                if attempt == policy.max_attempts:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(delay)
                delay *= policy.backoff_mult
        raise AssertionError("unreachable")

    return wrapped


@dataclasses.dataclass(frozen=True)
class WorkerFailure:
    """One worker-process death observed by a ``FleetWorkerPool`` round
    barrier: which worker died, which chunk indices were re-dispatched, and
    who survived to absorb them."""

    worker_id: int
    chunks: tuple[int, ...]
    survivors: tuple[int, ...]


def redispatch_chunks(chunk_ids, survivors) -> dict[int, list]:
    """Re-assign a dead worker's pending cohort chunks to the survivors.

    Round-robin over ``survivors`` (stable order) so a burst of failures
    spreads evenly instead of piling onto one shard.  Raises when nobody is
    left — the coordinator turns that into a round failure rather than a
    hang.  Returns ``{survivor_worker_id: [chunk_id, ...]}``.
    """
    survivors = list(survivors)
    if not survivors:
        raise RuntimeError(
            "no surviving workers to absorb re-dispatched chunks")
    assignment: dict[int, list] = {}
    for i, c in enumerate(sorted(chunk_ids)):
        assignment.setdefault(survivors[i % len(survivors)], []).append(c)
    return assignment


@dataclasses.dataclass
class StragglerPolicy:
    """Over-selection + deadline: select (1+over_select)*K clients, close the
    round at ``deadline_s`` or when ``target`` results arrived (whichever
    first) — the standard federated straggler mitigation, realized through
    DeviceFlow triggers."""

    target: int
    over_select: float = 0.3
    deadline_s: float = 600.0

    @property
    def num_selected(self) -> int:
        return int(self.target * (1.0 + self.over_select))

    def round_complete(self, arrived: int, elapsed_s: float) -> bool:
        return arrived >= self.target or elapsed_s >= self.deadline_s


class ElasticController:
    """Re-solves the hybrid allocation when the resource pool changes."""

    def __init__(self, resources: ResourceManager):
        self.resources = resources
        self.events: list[dict] = []

    def node_failure(self, grade: str, *, bundles: int = 0, phones: int = 0,
                     task_specs: list[GradeSpec] | None = None,
                     runtimes: list[alloc.GradeRuntime] | None = None):
        """Remove failed capacity and return a fresh allocation if specs given."""
        self.resources.scale(grade, bundles_delta=-bundles, phones_delta=-phones)
        self.events.append({
            "type": "failure", "grade": grade, "bundles": bundles,
            "phones": phones, "t": time.time(),
        })
        return self._resolve(task_specs, runtimes)

    def scale_up(self, grade: str, *, bundles: int = 0, phones: int = 0,
                 task_specs: list[GradeSpec] | None = None,
                 runtimes: list[alloc.GradeRuntime] | None = None):
        self.resources.scale(grade, bundles_delta=bundles, phones_delta=phones)
        self.events.append({
            "type": "scale_up", "grade": grade, "bundles": bundles,
            "phones": phones, "t": time.time(),
        })
        return self._resolve(task_specs, runtimes)

    def _resolve(self, task_specs, runtimes):
        if task_specs is None or runtimes is None:
            return None
        free = self.resources.free()
        # Clamp each grade's requested resources to the surviving pool.
        clamped = [
            dataclasses.replace(
                s,
                logical_bundles=min(
                    s.logical_bundles, free.logical_bundles.get(s.grade, 0)),
                physical_devices=min(
                    s.physical_devices, free.physical_devices.get(s.grade, 0)),
            )
            for s in task_specs
        ]
        return alloc.solve_allocation(clamped, runtimes)


@dataclasses.dataclass
class TrainingSupervisor:
    """Checkpoint/restart loop for the cloud-side trainer.

    ``run`` executes ``num_steps`` of ``step_fn`` with periodic async
    checkpoints; on a retryable failure it restores the last committed
    checkpoint and continues — the standard production restart loop.
    """

    checkpointer: Any  # checkpoint.Checkpointer
    checkpoint_every: int = 100
    policy: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)

    def run(self, state, step_fn: Callable, num_steps: int, *,
            state_like=None, extra_fn: Callable[[], dict] | None = None,
            on_restore: Callable[[dict], None] | None = None):
        start = 0
        latest = self.checkpointer.latest_step()
        if latest is not None:
            state, extra = self.checkpointer.restore(
                state_like if state_like is not None else state)
            start = latest
            if on_restore is not None:
                on_restore(extra)
        step = start
        attempts = 0
        while step < num_steps:
            try:
                state = step_fn(state, step)
                step += 1
                attempts = 0
                if step % self.checkpoint_every == 0 or step == num_steps:
                    self.checkpointer.save_async(
                        step, state,
                        extra=(extra_fn() if extra_fn else {}))
            except self.policy.retryable:
                attempts += 1
                if attempts >= self.policy.max_attempts:
                    raise
                # Let an async save in flight commit first, so the restart
                # step is the last one saved, not whichever save had landed.
                self.checkpointer.wait()
                latest = self.checkpointer.latest_step()
                if latest is not None:
                    state, extra = self.checkpointer.restore(
                        state_like if state_like is not None else state)
                    step = latest
                    if on_restore is not None:
                        on_restore(extra)
                time.sleep(self.policy.backoff_s * attempts)
        self.checkpointer.wait()
        return state, step
