"""Grade-partitioned logical & device simulation tiers (paper §III.B, §IV).

*Logical Simulation* in the paper launches Ray actors on k8s nodes, each actor
sequentially simulating several devices.  Here it is a **vectorized client
engine**: client-local training is a function of (client params, client
batch, rng) run for a whole *cohort* of clients at once with
``torch.func.vmap`` on the card.

*Device Simulation* is backed by the calibrated device models of
``core.devicemodel`` and executes the *same operator flow through a
numerically different backend* (bf16 compute vs f32), mirroring the paper's
PyMNN-vs-C++-MNN operator discrepancy.

**Grade-partitioned round engine.**  A ``RoundPlan`` consumes an
``AllocationResult`` directly — one ``GradePlanEntry`` per grade carrying the
allocator's (x_i logical, y_i physical, q_i benchmarking) split — and
``HybridSimulation`` holds one ``DeviceTier`` (with its own ``DeviceFleet``)
*per grade*::

    sim = HybridSimulation(logical, tiers={"High": ..., "Low": ...},
                           deviceflow=flow)
    plan = RoundPlan.from_allocation(solve_allocation(specs, runtimes), specs)
    outcome = sim.run_plan_round(task_id, rnd, params, plan,
                                 grade_batches, grade_num_samples, rng)

``run_plan_round`` executes each grade's logical and device cohorts (one
vmapped launch sequence per chunk), samples each grade's fleet once, merges
the per-grade sampled durations into DeviceFlow arrival times, materializes
``RoundReport``s for exactly the q_i benchmarking devices, and reports a
per-grade makespan breakdown in ``FederatedRoundOutcome.per_grade``.

**Zero-copy round pipeline.**  Model updates stay on the card end to end:
each chunk's stacked output becomes one ``core.updates.UpdateBuffer``,
messages carry ``UpdateHandle`` payloads (or whole chunks travel as one
columnar ``ArrivalBatch``), and aggregation runs one ``fed_reduce`` kernel
launch per buffer leaf.  Host materialization happens only for the q_i
benchmarking devices.  ``HybridSimulation(..., zero_copy=False)`` keeps the
host-materializing reference path.

**Randomness.**  ``rng`` arguments are ``torch.Generator``s (CPU).  The
chunk plan forks one sub-generator per chunk from the round generator (which
advances in place), and each chunk draws one int64 seed per device; the
local-train function receives its device's seed as ``rng``.

**Multi-process rounds.**  ``HybridSimulation(workers=N,
worker_spec=WorkerSpec(factory, ...))`` runs the cohort chunks in N spawned
worker processes (``runtime.workers``); each chunk ships the seed its fork
drew, so pooled rounds are bit-identical to inline ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.analysis import sanitizers
from repro_torch.analysis.sanitizers import hot_path
from repro_torch.core.allocation import AllocationResult
from repro_torch.core.deviceflow import ArrivalBatch, DeviceFlow, Message
from repro_torch.core.devicemodel import (
    DeviceFleet,
    DeviceGrade,
    FleetRoundSample,
    RoundReport,
)
from repro_torch.core.task import GradeSpec
from repro_torch.core.updates import (
    UpdateBuffer,
    UpdateHandle,
    flatten_rows,
    np_dtype,
    quantize_rows,
    stacked_spec,
)
from repro_torch.device import resolve_device

Params = dict  # dict[str, Tensor]
Batch = dict  # dict[str, Tensor | ndarray], leaves (devices, ...)

# A client-local training function: (params, batch, rng) -> (params, metrics).
LocalTrainFn = Callable[[Params, Batch, torch.Tensor], tuple[Params, dict]]

_SEED_HIGH = 1 << 62


def fork_seed(rng: torch.Generator) -> int:
    """The seed of one fork of ``rng`` (which advances in place): the
    port's counterpart of one ``jax.random.split``; the chunk's generator
    is ``torch.Generator().manual_seed(seed)``."""
    return int(torch.randint(0, _SEED_HIGH, (1,), generator=rng,
                             dtype=torch.int64))


def device_seeds(rng: torch.Generator, n: int) -> torch.Tensor:
    """One int64 seed per device of a cohort chunk (a CPU ``(n,)`` tensor)."""
    return torch.randint(0, _SEED_HIGH, (n,), generator=rng,
                         dtype=torch.int64)


def _num_rows(batches: Batch) -> int:
    return int(next(iter(batches.values())).shape[0])


@dataclasses.dataclass(frozen=True)
class CohortResult:
    """Results of one cohort of simultaneously simulated clients."""

    params: Params  # stacked: leaf shape (cohort, ...)
    metrics: dict  # stacked metrics, e.g. loss per client
    num_samples: torch.Tensor  # (cohort,)


class _ZeroCopyCohortMixin:
    """Shared zero-copy machinery for the simulation tiers.

    ``run_cohort_zero_copy`` runs the tier's cohort function and keeps each
    update leaf on the card as a ``(rows, size)`` matrix of one
    ``UpdateBuffer`` — the layout ``fed_reduce`` reduces directly.
    """

    _cohort_fn = None  # set by subclasses: (params, batches, rngs) -> (dict, metrics)
    # Whether ``_cohort_fn`` also takes ``out=``, leaves to write the update
    # into (see ``run_cohort_zero_copy``).
    takes_out = False
    device: torch.device

    def run_cohort_zero_copy(
        self,
        global_params: Params,
        batches: Batch,  # leaves shaped (cohort, ...)
        rngs: torch.Tensor,  # (cohort,) int64 seeds
        recycle: "UpdateBuffer | None" = None,
    ) -> tuple[UpdateBuffer, dict]:
        """The chunk's device-resident ``UpdateBuffer`` (rows in device
        order) and stacked metrics.

        ``recycle`` is a retired f32 buffer of the same rows (see
        ``HybridSimulation`` ``recycle_buffers``).  A tier whose cohort
        function ends in a cast back to the params' dtype (``DeviceTier``)
        writes that cast into the retired leaves of the same size and dtype
        (``out=`` targets) instead of fresh storage, so their old rows are
        gone.  A leaf of another layout, and every leaf of a tier without
        such a cast, gets fresh storage."""
        if (recycle is not None and self.takes_out and recycle.wire == "f32"
                and recycle.num_rows == int(rngs.shape[0])):
            out = dict(zip(recycle.keys, recycle.leaves2d))
            if sanitizers.enabled():
                # The retired buffer's leaves are about to hold this
                # chunk's rows; poison the object so a late handle read
                # raises UseAfterRecycleError instead of reading them.
                sanitizers.poison_recycled(recycle)
            params, metrics = self._cohort_fn(global_params, batches, rngs,
                                              out=out)
        else:
            params, metrics = self._cohort_fn(global_params, batches, rngs)
        return UpdateBuffer(flatten_rows(params), *stacked_spec(params)), metrics

    def update_spec(self, global_params: Params
                    ) -> tuple[tuple[str, ...], list[tuple], list[np.dtype]]:
        """(keys, per-leaf shapes, numpy dtypes) of the ``UpdateBuffer`` this
        tier's cohort function makes from ``global_params``, known without
        running it: the layout both ends of a worker pool agree on."""
        keys = tuple(sorted(global_params))
        return (keys, [tuple(global_params[k].shape) for k in keys],
                [np_dtype(self._update_dtype(global_params[k]))
                 for k in keys])

    def _update_dtype(self, leaf: torch.Tensor) -> torch.dtype:
        return leaf.dtype  # a cast back to the params' dtype

    def run_cohort_quantized(
        self,
        global_params: Params,
        batches: Batch,  # leaves shaped (cohort, ...)
        rngs: torch.Tensor,  # (cohort,) int64 seeds
        *,
        residual: "tuple | None" = None,
        error_feedback: bool = True,
    ) -> "tuple[UpdateBuffer, dict, tuple | None]":
        """The chunk's *quantized* ``UpdateBuffer`` (``wire="int8"``: int8
        leaves + per-row scale columns) and, with ``error_feedback``, the
        device-resident residual tuple to carry into this chunk's next round
        (pass it back as ``residual``).  Round 0 (or a layout change) starts
        from zero residuals: the previous round's quantization error joins
        this round's update before quantizing."""
        params, metrics = self._cohort_fn(global_params, batches, rngs)
        keys, shapes, dtypes = stacked_spec(params)
        leaves = flatten_rows(params)
        n = int(rngs.shape[0])
        if error_feedback:
            sizes = [math.prod(s) for s in shapes]
            if residual is None or not (
                    len(residual) == len(sizes)
                    and all(tuple(r.shape) == (n, sz)
                            for r, sz in zip(residual, sizes))):
                residual = tuple(
                    torch.zeros((n, sz), dtype=torch.float32,
                                device=leaf.device)
                    for sz, leaf in zip(sizes, leaves))
            leaves = [l.to(torch.float32) + r
                      for l, r in zip(leaves, residual)]
        q, s, res = quantize_rows(leaves, compute_residual=error_feedback)
        buf = UpdateBuffer(q, keys, shapes, dtypes, wire="int8", scales=s)
        return buf, metrics, (tuple(res) if error_feedback else None)


def _rows_block(x: torch.Tensor, mesh, data_axis: str) -> torch.Tensor:
    """This rank's block of the rows (dim 0) over the mesh's data axis."""
    dim = mesh.mesh_dim_names.index(data_axis)
    shards, r = mesh.size(dim), int(mesh.get_coordinate()[dim])
    n = x.shape[0]
    if n % shards:
        raise ValueError(f"{n} cohort rows do not split over {shards} "
                         f"{data_axis!r} shards")
    return x[r * (n // shards):(r + 1) * (n // shards)]


def _gather_rows(tree, mesh, data_axis: str):
    """Every rank's row block of each leaf, all-gathered in row order."""
    from repro_torch.distribution.collectives import all_gather

    group = mesh.get_group(data_axis)
    if isinstance(tree, dict):
        return {k: all_gather(v, group, 0) for k, v in tree.items()}
    return all_gather(tree, group, 0)


def _shard_over_data(fn, mesh, data_axis: str):
    """``fn(params, batches, rngs)`` on this rank's block of the cohort's
    rows, its outputs all-gathered in row order: the reference's
    ``shard_map`` over the mesh's data axis."""

    def sharded(global_params, batches, rngs):
        batches = {k: _rows_block(v, mesh, data_axis)
                   for k, v in batches.items()}
        params, metrics = fn(global_params, batches,
                             _rows_block(rngs, mesh, data_axis))
        return (_gather_rows(params, mesh, data_axis),
                _gather_rows(metrics, mesh, data_axis))

    return sharded


def _cast_back(new_p: Params, global_params: Params,
               out: "dict | None" = None) -> Params:
    """Each float leaf of ``new_p`` cast back to its global dtype; a cast
    writes into ``out[k]`` when that leaf has the same rows, size, dtype
    and device (the ``out=`` target of a recycled buffer), else into fresh
    storage.  A leaf already in its dtype is returned as is."""
    res = {}
    for k, v in new_p.items():
        dt = global_params[k].dtype
        o = None if out is None else out.get(k)
        if not global_params[k].is_floating_point() or v.dtype == dt:
            res[k] = v
        elif (o is not None and o.dtype == dt and o.device == v.device
              and o.shape[0] == v.shape[0] and o.numel() == v.numel()
              and o.is_contiguous()):
            res[k] = o.view(v.shape).copy_(v)
        else:
            res[k] = v.to(dt)
    return res


class LogicalTier(_ZeroCopyCohortMixin):
    """Vectorized logical-simulation tier (f32 by default)."""

    def __init__(
        self,
        local_train: LocalTrainFn,
        *,
        mesh=None,
        data_axis: str = "data",
        cohort_size: int = 64,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.local_train = local_train
        # ``mesh`` (a DeviceMesh with a ``data_axis`` dim, e.g.
        # ``make_fleet_mesh``'s "dp"): each rank runs its block of a
        # cohort's rows and the outputs are all-gathered in row order.
        self.mesh = mesh
        self.data_axis = data_axis
        self.cohort_size = cohort_size
        self.dtype = dtype
        self.device = resolve_device(device)
        vmapped = vmap(self.local_train, in_dims=(None, 0, 0))

        def cohort(global_params, batches, rngs):
            # The global params enter unbatched (in_dims=None): every
            # device starts from the same tensors and vmap never copies them
            # per device.
            p = {k: (v.to(self.dtype) if v.is_floating_point() else v)
                 for k, v in global_params.items()}
            return vmapped(p, batches, rngs)

        self._cohort_fn = (cohort if mesh is None
                           else _shard_over_data(cohort, mesh, data_axis))

    def _update_dtype(self, leaf: torch.Tensor) -> torch.dtype:
        # The cohort runs in the tier's dtype and keeps its output there.
        return self.dtype if leaf.is_floating_point() else leaf.dtype

    def run_cohort(
        self,
        global_params: Params,
        batches: Batch,  # leaves shaped (cohort, ...)
        rng: torch.Generator,
        num_samples: np.ndarray,
    ) -> CohortResult:
        n = _num_rows(batches)
        params, metrics = self._cohort_fn(global_params, batches,
                                          device_seeds(rng, n))
        return CohortResult(params=params, metrics=metrics,
                            num_samples=torch.as_tensor(np.asarray(num_samples)))


class DeviceTier(_ZeroCopyCohortMixin):
    """Calibrated device-simulation tier for ONE device grade.

    Runs the same local computation through a numerically distinct backend
    dtype (bf16: params *and* batch cast in, compute, params cast back — the
    paper's operator discrepancy) and charges virtual time/energy via a
    persistent ``DeviceFleet`` — one vectorized Table-I sample per round,
    per-device RNG streams that *survive* across rounds.

    ``run_cohort`` is the batched execution path (one vmapped chunk);
    ``run_device`` is the single-device view (same numerics, same fleet).
    """

    takes_out = True  # the cast back writes into a recycled buffer

    def __init__(
        self,
        local_train: LocalTrainFn,
        grade: DeviceGrade,
        *,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        train_cost_scale: float = 1.0,
        cohort_size: int = 256,
        jitter: float = 0.08,
        mesh=None,
        data_axis: str = "data",
        device="cuda",
    ):
        self.grade = grade
        # ``mesh``: the cohort's rows split over the mesh's ``data_axis``,
        # as ``LogicalTier``'s (a sharded chunk casts into fresh storage).
        self.mesh = mesh
        self.data_axis = data_axis
        if mesh is not None:
            self.takes_out = False
        self.dtype = dtype
        self.seed = seed
        self.train_cost_scale = train_cost_scale
        self.cohort_size = cohort_size
        self.local_train = local_train
        self.device = resolve_device(device)
        self.fleet = DeviceFleet(grade, 0, seed=seed, jitter=jitter)
        self.reports: list[RoundReport] = []
        self._backend_fn = vmap(self._backend_step, in_dims=(None, 0, 0))

    # -- numerically-distinct backend: cast in, compute, cast back ---------
    def _backend_step(self, global_params: Params, batch: Batch, rng):
        """Cast in and compute: the params come back in the backend dtype."""
        cast_in = lambda x: x.to(self.dtype) if x.is_floating_point() else x
        p = {k: cast_in(v) for k, v in global_params.items()}
        b = {k: cast_in(v) for k, v in batch.items()}
        return self.local_train(p, b, rng)

    def _device_step(self, global_params: Params, batch: Batch, rng):
        new_p, metrics = self._backend_step(global_params, batch, rng)
        return _cast_back(new_p, global_params), metrics

    def _cohort_fn(self, global_params: Params, batches: Batch,
                   rngs: torch.Tensor, out: "dict | None" = None):
        """One vmapped chunk, its params cast back after the vmap: into
        ``out[k]`` where given and of the same size and dtype."""
        if self.mesh is not None:
            return _shard_over_data(
                lambda g, b, r: self._cohort_fn_local(g, b, r, None),
                self.mesh, self.data_axis)(global_params, batches, rngs)
        return self._cohort_fn_local(global_params, batches, rngs, out)

    def _cohort_fn_local(self, global_params, batches, rngs, out):
        new_p, metrics = self._backend_fn(global_params, batches, rngs)
        return _cast_back(new_p, global_params, out), metrics

    def run_cohort(
        self,
        global_params: Params,
        batches: Batch,  # leaves shaped (cohort, ...)
        rngs: torch.Tensor,  # (cohort,) int64 seeds
    ) -> tuple[Params, dict]:
        """One vmapped chunk simulating a whole device cohort (bf16)."""
        return self._cohort_fn(global_params, batches, rngs)

    def sample_round(self, device_ids: np.ndarray, round_idx: int
                     ) -> "FleetRoundSample":
        """Vectorized Table-I behavior sample for ``device_ids`` this round."""
        rows = self.fleet.rows_for(np.asarray(device_ids))
        return self.fleet.run_round(
            round_idx, train_cost_scale=self.train_cost_scale, rows=rows)

    def run_device(
        self,
        device_id: int,
        global_params: Params,
        batch: Batch,
        rng: torch.Generator,
        round_idx: int,
        *,
        benchmark: bool = False,
    ) -> tuple[Params, dict, RoundReport | None]:
        seed = device_seeds(rng, 1)[0]
        new_p, metrics = self._device_step(global_params, batch, seed)
        report = None
        if benchmark:
            sample = self.sample_round(np.array([device_id]), round_idx)
            report = sample.report(0)
            self.reports.append(report)
        return new_p, metrics, report


# --------------------------------------------------------------------------- #
# Round plans — the allocator's split as an executable object
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GradePlanEntry:
    """One grade's share of a round: the allocator's (x_i, y_i, q_i)."""

    grade: str
    num_logical: int  # x_i — devices emulated on the logical tier
    num_physical: int  # N_i - q_i - x_i — devices on the device tier
    num_benchmarking: int = 0  # q_i — measured devices (device tier, reports)

    def __post_init__(self):
        if min(self.num_logical, self.num_physical, self.num_benchmarking) < 0:
            raise ValueError("plan entry counts must be non-negative")

    @property
    def num_devices(self) -> int:
        """Total devices of this grade simulated in the round (x + y + q)."""
        return self.num_logical + self.num_physical + self.num_benchmarking


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """Executable per-grade split of one federated round.

    Built directly from the §IV.B allocator's output — ``from_allocation``
    carries each grade's benchmarking count q_i over from its ``GradeSpec``,
    so the devices producing ``RoundReport``s are exactly the ones the
    allocator excluded from the split.
    """

    entries: tuple[GradePlanEntry, ...]

    def __post_init__(self):
        seen = set()
        for e in self.entries:
            if e.grade in seen:
                raise ValueError(f"duplicate grade {e.grade!r} in plan")
            seen.add(e.grade)

    @classmethod
    def from_allocation(cls, result: AllocationResult,
                        specs: Sequence[GradeSpec]) -> "RoundPlan":
        by_grade = {s.grade: s for s in specs}
        entries = []
        for ga in result.per_grade:
            spec = by_grade.get(ga.grade)
            entries.append(GradePlanEntry(
                grade=ga.grade,
                num_logical=ga.logical_devices,
                num_physical=ga.physical_devices,
                num_benchmarking=(spec.benchmarking_devices
                                  if spec is not None else 0),
            ))
        return cls(tuple(entries))

    def entry(self, grade: str) -> GradePlanEntry:
        for e in self.entries:
            if e.grade == grade:
                return e
        raise KeyError(f"grade {grade!r} not in plan")

    @property
    def grades(self) -> tuple[str, ...]:
        return tuple(e.grade for e in self.entries)

    @property
    def total_devices(self) -> int:
        return sum(e.num_devices for e in self.entries)


@dataclasses.dataclass(frozen=True)
class GradeRoundBreakdown:
    """Per-grade outcome of one round (makespan accounting, paper Fig. 7)."""

    grade: str
    num_logical: int
    num_physical: int
    num_benchmarking: int
    makespan_s: float  # slowest sampled device-round completion of the grade
    mean_duration_s: float  # mean sampled round duration across the grade


class ArrivalMessageView:
    """Scalar-``Message`` compat adapter over mixed round emissions.

    Columnar rounds emit ``ArrivalBatch``es (plus scalar q_i benchmarking
    messages); consumers of ``FederatedRoundOutcome.messages`` still see one
    ``Message`` per device.  Materialization is lazy and cached: the hot
    path never touches it.
    """

    __slots__ = ("_emissions", "_mat")

    def __init__(self, emissions: "list[Message | ArrivalBatch]"):
        self._emissions = emissions
        self._mat: list[Message] | None = None

    def _materialize(self) -> list[Message]:
        if self._mat is None:
            out: list[Message] = []
            for e in self._emissions:
                if isinstance(e, ArrivalBatch):
                    out.extend(e.messages())
                else:
                    out.append(e)
            self._mat = out
        return self._mat

    def __len__(self) -> int:
        return sum(e.n if isinstance(e, ArrivalBatch) else 1
                   for e in self._emissions)

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def __repr__(self) -> str:
        return f"ArrivalMessageView(n={len(self)})"


@dataclasses.dataclass
class FederatedRoundOutcome:
    num_logical: int
    num_physical: int
    messages: "list[Message] | ArrivalMessageView"
    reports: list[RoundReport]
    arrival_times: np.ndarray | None = None  # per-message virtual times
    per_grade: dict[str, GradeRoundBreakdown] = dataclasses.field(
        default_factory=dict)
    client_metrics: list = dataclasses.field(default_factory=list)
    # Columnar rounds: the raw ArrivalBatch emissions (empty on the scalar
    # plane).  ``messages`` adapts them back to per-row Message views.
    batches: list[ArrivalBatch] = dataclasses.field(default_factory=list)

    @property
    def makespan_s(self) -> float:
        """Round makespan: the slowest grade's slowest sampled device."""
        return max((b.makespan_s for b in self.per_grade.values()), default=0.0)


class HybridSimulation:
    """Drives one federated round across both tiers and feeds DeviceFlow.

    ``tiers`` maps grade name to that grade's ``DeviceTier`` (each with its
    own fleet).  A single ``DeviceTier`` may still be passed positionally for
    the one-grade case; it is wrapped as ``{tier.grade.name: tier}`` and
    remains reachable as ``sim.device``.

    **Zero-copy rounds** (default): cohort outputs stay stacked on the card —
    each chunk's result becomes one ``UpdateBuffer`` and every message
    carries an ``UpdateHandle`` (or the whole chunk travels as one columnar
    ``ArrivalBatch``), so the cohort loop never waits for the card.  Host
    dicts are materialized only for the q_i benchmarking devices, after
    every chunk of the grade has been launched.  ``zero_copy=False`` keeps
    the host-materializing path as the correctness reference.

    ``stream_chunks=True`` submits each cohort chunk's arrivals through
    DeviceFlow *as the chunk is launched* instead of once at round end — the
    feed for streaming aggregation (``AggregationService(streaming=True)``).
    Streamed messages are stamped at the clock's current time; round
    makespans and ``round_complete`` timing still come from the fleet
    sample.  Benchmarking (q_i) rows are held back until their handles
    materialize and submitted last.

    ``wire="int8"`` quantizes every cohort chunk's update right after local
    training (``run_cohort_quantized``) and emits an int8 ``UpdateBuffer``
    with per-row, per-leaf scale columns; aggregation dequantizes inside
    the reduction.  ``error_feedback=True`` (default) keeps each chunk's
    quantization error on the card and adds it into the same chunk's
    next-round update before quantizing (keyed per task/tier/row range).

    ``payload_transform`` (a callable ``emission -> emission`` over
    ``Message``/``ArrivalBatch``) rewrites every emission *before* it is
    submitted to DeviceFlow.  Transforms must preserve ``device_ids`` / row
    counts (arrival times are indexed through them).

    ``recycle_buffers=True`` writes round k+1's device-tier chunk updates
    into round k's retired update buffers of the same (tier, rows) key:
    torch has no buffer donation, so the tier's cast back from its backend
    dtype takes the retired leaves as ``out=`` targets, and a chunk keeps
    one storage across rounds with no buffer-sized allocation.  The logical
    tier's update is its training function's own output, with no final op
    to redirect; its chunks get fresh storage (which the caching allocator
    takes from freed blocks).  Only enable it when every handle of round k
    is consumed before round k+1 runs (realtime dispatch with an in-round
    trigger, as in the quickstart); a handle that outlives its round would
    read the next round's rows (under ``SIMDC_SANITIZE=1`` the retired
    buffer is poisoned and such a read raises ``UseAfterRecycleError``).
    It applies to the f32 wire only (int8 leaves have another layout), as
    in the reference.

    ``workers=N`` (with ``worker_spec=WorkerSpec(factory, ...)``) shards
    cohort-chunk execution across N spawned worker processes
    (``runtime.workers.FleetWorkerPool``) on this simulation's device; chunk
    results return through shared memory as ``UpdateBuffer``s (copied onto
    the card when the simulation runs there) and re-enter the emission
    pipeline unchanged, so pooled rounds are bit-identical to in-process
    ones (both wires, error feedback included) while this coordinator keeps
    DeviceFlow, fleet sampling and aggregation on the authoritative clock.
    Call ``close()`` (or use the context-manager form) to stop the pool and
    release its segments.  Requires ``zero_copy`` rounds; ``worker_pool=``
    injects a pre-built (e.g. delay-instrumented) pool instead.
    """

    def __init__(
        self,
        logical: LogicalTier,
        device: "DeviceTier | Mapping[str, DeviceTier] | None" = None,
        deviceflow: DeviceFlow | None = None,
        *,
        tiers: Mapping[str, DeviceTier] | None = None,
        zero_copy: bool = True,
        recycle_buffers: bool = False,
        stream_chunks: bool = False,
        columnar: bool = True,
        wire: str = "f32",
        error_feedback: bool = True,
        payload_transform: "Callable | None" = None,
        workers: int = 0,
        worker_spec=None,
        worker_pool=None,
    ):
        if wire not in ("f32", "int8"):
            raise ValueError(f"unknown wire format {wire!r}")
        if wire == "int8" and not zero_copy:
            raise ValueError(
                "wire='int8' requires zero_copy rounds (quantization runs "
                "on the device-resident cohort output)")
        # Multi-process fleet execution (runtime.workers): cohort chunks run
        # in N worker processes; this coordinator keeps DeviceFlow, fleet
        # sampling and aggregation on the authoritative clock.
        self._pool = worker_pool
        if workers and worker_pool is None:
            if worker_spec is None:
                raise ValueError(
                    "workers=N requires worker_spec=WorkerSpec(factory, ...)"
                    " — a picklable module-level factory rebuilding "
                    "(logical, tiers) inside each worker process")
            if not zero_copy:
                raise ValueError(
                    "workers=N requires zero_copy rounds (the transport "
                    "ships UpdateBuffer leaves)")
            from repro_torch.runtime.workers import FleetWorkerPool

            self._pool = FleetWorkerPool(worker_spec, workers,
                                         device=logical.device)
        self.zero_copy = zero_copy
        self.recycle_buffers = recycle_buffers
        self.stream_chunks = stream_chunks
        self.wire = wire
        self.error_feedback = error_feedback
        self.payload_transform = payload_transform
        # Error-feedback memory: (task, tier, global row range) -> residual
        # leaf tuple, device-resident across rounds.
        self._ef_residuals: dict = {}
        # Columnar message plane: zero-copy chunks emit ONE ArrivalBatch per
        # cohort chunk instead of one Message object per device.
        self.columnar = columnar
        # Recycled update buffers: (tier id, rows) -> [UpdateBuffer], the
        # previous round's (retired) and this round's (staged).
        self._retired: dict = {}
        self._staged: dict = {}
        self.logical = logical
        if tiers is not None and device is not None:
            raise ValueError("pass either device or tiers, not both")
        if tiers is None:
            if device is None:
                raise ValueError(
                    "pass a DeviceTier or tiers={grade: DeviceTier}")
            tiers = (device if not isinstance(device, DeviceTier)
                     else {device.grade.name: device})
        self.tiers: dict[str, DeviceTier] = dict(tiers)
        if not self.tiers:
            raise ValueError("at least one device tier is required")
        self.deviceflow = deviceflow

    @property
    def device(self) -> DeviceTier:
        """Legacy single-grade view of ``tiers``."""
        if len(self.tiers) != 1:
            raise ValueError(
                f"{len(self.tiers)} device tiers configured; "
                "use sim.tiers[grade]")
        return next(iter(self.tiers.values()))

    @property
    def pool(self):
        """The ``FleetWorkerPool`` driving multi-process rounds (or None)."""
        return self._pool

    @property
    def fleets(self) -> "dict[str, DeviceFleet]":
        """Per-grade fleets, keyed by grade name — the shape
        ``TaskEngine.state_dict(fleets=...)`` folds into the one-manifest
        runtime checkpoint."""
        return {name: tier.fleet for name, tier in self.tiers.items()}

    def close(self) -> None:
        """Shut down the worker pool (no-op for single-process rounds)."""
        if self._pool is not None:
            self._pool.close()

    def __enter__(self) -> "HybridSimulation":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- shared per-grade execution ----------------------------------------
    @hot_path
    def _run_split(
        self,
        tier: DeviceTier,
        task_id: int,
        round_idx: int,
        global_params: Params,
        client_batches: Batch,
        num_samples: np.ndarray,
        num_logical: int,
        rng: torch.Generator,
        *,
        id_offset: int = 0,
        metrics_out: list | None = None,
        materialize_rows: Sequence[int] = (),
    ) -> "tuple[list[Message | ArrivalBatch], torch.Generator]":
        """Run one grade's split: [0, num_logical) through the logical tier,
        the rest through ``tier``'s device backend.  Returns the emitted
        arrivals (``device_id`` offset by ``id_offset``) and ``rng``
        (advanced in place).

        Zero-copy mode emits ONE columnar ``ArrivalBatch`` per cohort chunk;
        ``materialize_rows`` names the grade-local rows (the q_i
        benchmarking devices) that are instead emitted as scalar
        ``Message``s whose payloads are materialized to host dicts *after*
        every chunk has been launched, so benchmarking never stalls the
        cohort pipeline on the card.
        """
        n_total = _num_rows(client_batches)
        if not 0 <= num_logical <= n_total:
            raise ValueError("num_logical out of range")

        emissions: "list[Message | ArrivalBatch]" = []
        # User extension point: transforms may legitimately move data
        # between host and card, so they run outside the hot-path sync
        # check (no-op wrapper when sanitizers are off).
        transform = sanitizers.exempt(self.payload_transform)
        mat_set = set(materialize_rows)
        columnar = self.columnar and self.zero_copy
        bench_pos: dict[int, int] = {}  # grade-local row -> emission index

        def emit_batch(buf: UpdateBuffer, lo, hi):
            # Columnar plane: the whole chunk is ONE struct-of-arrays record
            # sharing the chunk's UpdateBuffer — no per-device objects.  The
            # q_i benchmarking rows split out as scalar Messages (their
            # payloads materialize to host dicts post-round).
            num_samples_arr = np.asarray(num_samples[lo:hi], np.int64)
            bench = sorted(r for r in mat_set if lo <= r < hi)
            prev = lo
            for r in bench + [hi]:
                if r > prev:
                    emissions.append(ArrivalBatch(
                        task_id, round_idx,
                        rows=np.arange(prev - lo, r - lo, dtype=np.int32),
                        num_samples=num_samples_arr[prev - lo:r - lo],
                        device_ids=np.arange(id_offset + prev,
                                             id_offset + r, dtype=np.int64),
                        buffer=buf))
                if r < hi:
                    bench_pos[r] = len(emissions)
                    emissions.append(Message(
                        task_id=task_id,
                        device_id=id_offset + r,
                        round_idx=round_idx,
                        payload=buf.handle(r - lo),
                        num_samples=int(num_samples[r]),
                    ))
                prev = r + 1

        def emit_handles(buf: UpdateBuffer, lo, hi):
            # Zero-copy scalar plane: the chunk's update buffer stays on the
            # card; messages carry (buffer, row) handles.
            if columnar:
                emit_batch(buf, lo, hi)
                return
            for j in range(hi - lo):
                emissions.append(
                    Message(
                        task_id=task_id,
                        device_id=id_offset + lo + j,
                        round_idx=round_idx,
                        payload=buf.handle(j),
                        num_samples=int(num_samples[lo + j]),
                    )
                )

        def emit_host(stacked_params, lo, hi):
            # Host reference path: copy the chunk to the host once,
            # per-device payloads as row views.
            host = {k: v.detach().cpu() for k, v in stacked_params.items()}
            for j in range(hi - lo):
                emissions.append(
                    Message(
                        task_id=task_id,
                        device_id=id_offset + lo + j,
                        round_idx=round_idx,
                        payload={k: v[j] for k, v in host.items()},
                        num_samples=int(num_samples[lo + j]),
                    )
                )

        stream = self.stream_chunks and self.deviceflow is not None

        def stream_chunk(n_before: int) -> None:
            # Streaming feed: this chunk's arrivals enter DeviceFlow now, so
            # a streaming aggregation service launches the chunk's
            # fed_reduce partial while the next chunk's cohort computes.
            # The q_i benchmarking rows are held back until materialization.
            held = set(bench_pos.values()) if columnar else mat_set
            if transform is not None:
                for i in range(n_before, len(emissions)):
                    if i not in held:
                        emissions[i] = transform(emissions[i])
            fresh = [e for i, e in enumerate(emissions[n_before:],
                                             start=n_before)
                     if i not in held]
            if not fresh:
                return
            if any(isinstance(e, ArrivalBatch) for e in fresh):
                self.deviceflow.submit_arrivals(fresh)
            else:
                self.deviceflow.submit_many(fresh)

        def run_chunk(sim_tier, lo, hi, seed):
            # Same per-device seed derivation in every mode, so zero_copy is
            # numerics-preserving.  Host (numpy) leaves move to the tier's
            # device here; leaves already there are sliced as views.
            chunk = {k: torch.as_tensor(v[lo:hi], device=sim_tier.device)
                     for k, v in client_batches.items()}
            rngs = device_seeds(torch.Generator().manual_seed(seed), hi - lo)
            if self.zero_copy and self.wire == "int8":
                # Quantized wire: the chunk's error-feedback residual stays
                # on the card, keyed by (task, tier, global row range) so the
                # same devices' residual carries into their next round.
                ef_key = (task_id, id(sim_tier), id_offset + lo,
                          id_offset + hi)
                buf, metrics, new_res = sim_tier.run_cohort_quantized(
                    global_params, chunk, rngs,
                    residual=self._ef_residuals.get(ef_key),
                    error_feedback=self.error_feedback)
                if self.error_feedback:
                    self._ef_residuals[ef_key] = new_res
                emit_handles(buf, lo, hi)
            elif self.zero_copy:
                # The chunk's stacked output never leaves the card; the
                # next chunk is launched while this one still computes.
                prev = None
                key = (id(sim_tier), hi - lo)
                recycle = self.recycle_buffers and sim_tier.takes_out
                if recycle and self._retired.get(key):
                    prev = self._retired[key].pop()
                buf, metrics = sim_tier.run_cohort_zero_copy(
                    global_params, chunk, rngs, recycle=prev)
                if recycle:
                    self._staged.setdefault(key, []).append(buf)
                emit_handles(buf, lo, hi)
            else:
                out_params, metrics = sim_tier._cohort_fn(
                    global_params, chunk, rngs)
                emit_host(out_params, lo, hi)
            if metrics_out is not None:
                metrics_out.append(metrics)

        # The chunk plan IS the rng contract: logical cohorts (chunked by
        # cohort_size) then device cohorts, one generator fork per chunk —
        # walked identically whether chunks run inline or across a worker
        # pool (which ships each fork's seed), so pooled rounds stay
        # bit-identical.
        chunk_plan: list[tuple] = []
        idx = 0
        while idx < num_logical:
            hi = min(idx + self.logical.cohort_size, num_logical)
            chunk_plan.append((self.logical, "logical", idx, hi,
                               fork_seed(rng)))
            idx = hi
        # Device tier: vectorized cohorts through the bf16 backend — one
        # vmapped chunk at a time instead of one call per device.
        idx = num_logical
        while idx < n_total:
            hi = min(idx + tier.cohort_size, n_total)
            chunk_plan.append((tier, tier.grade.name, idx, hi,
                               fork_seed(rng)))
            idx = hi

        if self._pool is not None and self.zero_copy:
            # Multi-process path: the chunk results come back through shared
            # memory (on a card, copied onto it) and re-enter the emission
            # pipeline in CHUNK order after the barrier, streaming or not,
            # so pooled rounds are bit-identical to inline ones.  Shipping
            # params and batches through the
            # input segment and results back onto the card are explicit
            # host<->card copies, so the pool call runs outside the
            # hot-path sync check; the inline path below keeps it.
            def finish(i, buf, metrics):
                _, _, lo, hi, _ = chunk_plan[i]
                n_before = len(emissions)
                emit_handles(buf, lo, hi)
                if metrics_out is not None:
                    metrics_out.append(metrics)
                if stream:
                    stream_chunk(n_before)

            sanitizers.exempt(self._run_pooled)(
                task_id, round_idx, global_params, client_batches,
                chunk_plan, id_offset, finish)
        else:
            for sim_tier, _, lo, hi, seed in chunk_plan:
                n_before = len(emissions)
                run_chunk(sim_tier, lo, hi, seed)
                if stream:
                    stream_chunk(n_before)

        # Deferred host materialization: only the q_i benchmarking devices'
        # updates become host dicts, after the whole grade was launched.
        # (Columnar mode: bench rows live at ``bench_pos[r]``; scalar mode:
        # emission index == grade-local row.)
        for r in materialize_rows:
            i = bench_pos.get(r, r)
            m = emissions[i]
            if isinstance(m.payload, UpdateHandle):
                emissions[i] = dataclasses.replace(
                    m, payload=m.payload.materialize())
        if transform is not None:
            if stream:
                # Streamed chunks transformed at submit time; only the
                # held-back benchmarking rows remain.
                for r in mat_set:
                    i = bench_pos.get(r, r)
                    emissions[i] = transform(emissions[i])
            else:
                emissions = [transform(e) for e in emissions]
        if stream and mat_set:
            self.deviceflow.submit_many(
                [emissions[bench_pos.get(r, r)] for r in sorted(mat_set)])
        return emissions, rng

    def _run_pooled(self, task_id: int, round_idx: int,
                    global_params: Params, client_batches: Batch,
                    chunk_plan: list, id_offset: int,
                    finish: Callable) -> None:
        """One grade's chunk plan through the worker pool; ``finish(i, buf,
        metrics)`` emits chunk ``i``, in chunk order after the barrier."""
        from repro_torch.runtime.workers import ChunkSpec

        specs_by_kind = {kind: sim_tier.update_spec(global_params)
                         for sim_tier, kind, *_ in chunk_plan}
        wchunks = [ChunkSpec(i, kind, lo, hi, seed, id_offset=id_offset)
                   for i, (_, kind, lo, hi, seed) in enumerate(chunk_plan)]
        pooled = self._pool.run_chunks(
            task_id=task_id, round_idx=round_idx, params=global_params,
            batches=client_batches, chunks=wchunks,
            specs_by_kind=specs_by_kind, wire=self.wire,
            error_feedback=self.error_feedback)
        for i, (buf, metrics) in enumerate(pooled):
            finish(i, buf, metrics)

    # -- grade-partitioned rounds (allocator-driven) -----------------------
    def run_plan_round(
        self,
        task_id: int,
        round_idx: int,
        global_params: Params,
        plan: RoundPlan,
        grade_batches: Mapping[str, Batch],  # per grade: leaves (N_i, ...)
        grade_num_samples: Mapping[str, np.ndarray],  # per grade: (N_i,)
        rng: torch.Generator,
        *,
        calibrator=None,
    ) -> FederatedRoundOutcome:
        """Execute one allocator-planned round across every grade.

        Per grade ``g``: rows ``[0, x_g)`` of ``grade_batches[g]`` run on the
        logical tier, rows ``[x_g, x_g + y_g + q_g)`` through grade ``g``'s
        ``DeviceTier``; the LAST ``q_g`` rows are the benchmarking devices and
        materialize ``RoundReport``s.  Each grade's fleet is sampled once;
        the sampled durations become DeviceFlow arrival times (merged across
        grades) and the per-grade makespan breakdown.  ``calibrator``
        (a ``calibration.RuntimeCalibrator``) observes every grade's sample.
        """
        # Validate the whole plan up front: a failure mid-plan would leave
        # earlier grades' tiers, rng, and the calibrator polluted with a
        # half-executed round.
        per_grade_inputs: list[tuple[GradePlanEntry, Any, np.ndarray, int]] = []
        for entry in plan.entries:
            if entry.grade not in self.tiers:
                raise KeyError(
                    f"plan contains grade {entry.grade!r} but HybridSimulation "
                    f"has tiers for {sorted(self.tiers)}")
            try:
                batches = grade_batches[entry.grade]
                n_samples = np.asarray(grade_num_samples[entry.grade])
            except KeyError:
                raise KeyError(
                    f"grade_batches/grade_num_samples missing grade "
                    f"{entry.grade!r}") from None
            n_total = _num_rows(batches)
            if n_total != entry.num_devices:
                raise ValueError(
                    f"grade {entry.grade!r}: batches carry {n_total} devices "
                    f"but the plan requires {entry.num_devices} "
                    f"(x={entry.num_logical} + y={entry.num_physical} + "
                    f"q={entry.num_benchmarking})")
            per_grade_inputs.append((entry, batches, n_samples, n_total))

        emissions: "list[Message | ArrivalBatch]" = []
        reports: list[RoundReport] = []
        arrivals: list[np.ndarray] = []
        breakdown: dict[str, GradeRoundBreakdown] = {}
        client_metrics: list = []
        base = 0.0 if self.deviceflow is None else self.deviceflow.clock.now
        offset = 0
        for entry, batches, n_samples, n_total in per_grade_inputs:
            tier = self.tiers[entry.grade]
            if n_total == 0:
                breakdown[entry.grade] = GradeRoundBreakdown(
                    entry.grade, 0, 0, 0, 0.0, 0.0)
                continue
            grade_emissions, rng = self._run_split(
                tier, task_id, round_idx, global_params, batches, n_samples,
                entry.num_logical, rng, id_offset=offset,
                metrics_out=client_metrics,
                materialize_rows=range(
                    n_total - entry.num_benchmarking, n_total),
            )
            emissions.extend(grade_emissions)

            # Behavioral side: one fleet sample covers the grade (sampled
            # under grade-LOCAL ids so per-device RNG streams stay stable
            # across rounds whatever the plan); the last q_i rows also
            # materialize full RoundReports re-stamped with the same global
            # device ids their messages carry.
            sample = tier.sample_round(np.arange(n_total), round_idx)
            for k in range(n_total - entry.num_benchmarking, n_total):
                rep = dataclasses.replace(
                    sample.report(k), device_id=offset + k)
                reports.append(rep)
                tier.reports.append(rep)
            if calibrator is not None:
                calibrator.observe_fleet(sample)
            offsets_s = sample.arrival_offsets_s()
            arrivals.append(base + offsets_s)
            breakdown[entry.grade] = GradeRoundBreakdown(
                grade=entry.grade,
                num_logical=entry.num_logical,
                num_physical=entry.num_physical,
                num_benchmarking=entry.num_benchmarking,
                makespan_s=float(offsets_s.max()),
                mean_duration_s=float(offsets_s.mean()),
            )
            offset += n_total

        arrival_times = (np.concatenate(arrivals) if arrivals else None)
        batches = [e for e in emissions if isinstance(e, ArrivalBatch)]
        if self.deviceflow is not None and emissions:
            if not self.stream_chunks:  # streamed rounds already submitted
                if batches:
                    # Columnar plane: per-row arrival times indexed straight
                    # from the batch's device_ids column — no per-row objects.
                    ts = np.concatenate([
                        arrival_times[e.device_ids]
                        if isinstance(e, ArrivalBatch)
                        else arrival_times[e.device_id:e.device_id + 1]
                        for e in emissions])
                    self.deviceflow.submit_arrivals(emissions, ts=ts)
                else:
                    self.deviceflow.submit_many(emissions, ts=arrival_times)
            # The round ends when the slowest device reports, not at clock.now.
            self.deviceflow.round_complete(
                task_id, t=float(np.max(arrival_times)))
        if self.recycle_buffers:
            self._retired, self._staged = self._staged, {}
        return FederatedRoundOutcome(
            num_logical=sum(e.num_logical for e in plan.entries),
            num_physical=sum(e.num_physical + e.num_benchmarking
                             for e in plan.entries),
            messages=(ArrivalMessageView(emissions) if batches
                      else emissions),
            batches=batches,
            reports=reports,
            arrival_times=arrival_times,
            per_grade=breakdown,
            client_metrics=client_metrics,
        )

    # -- legacy single-grade path ------------------------------------------
    def run_round(
        self,
        task_id: int,
        round_idx: int,
        global_params: Params,
        client_batches: Batch,  # leaves (num_clients, ...)
        num_samples: np.ndarray,  # (num_clients,)
        num_logical: int,
        rng: torch.Generator,
        *,
        benchmark_devices: int = 0,
        arrival_times: np.ndarray | None = None,
    ) -> FederatedRoundOutcome:
        """Single-grade round against ``sim.device`` (legacy shape).

        Unlike the plan path, ``benchmark_devices`` picks the FIRST n
        device-tier rows and does not reduce ``num_physical``.
        """
        tier = self.device
        n_total = _num_rows(client_batches)
        n_bench_rows = min(max(benchmark_devices, 0), n_total - num_logical)
        metrics: list = []
        emissions, _ = self._run_split(
            tier, task_id, round_idx, global_params, client_batches,
            np.asarray(num_samples), num_logical, rng, metrics_out=metrics,
            materialize_rows=range(num_logical, num_logical + n_bench_rows))
        reports: list[RoundReport] = []

        # Behavioral side: one vectorized fleet sample covers every simulated
        # device this round — Table-I durations become arrival times, and the
        # benchmarking subset materializes full RoundReports (paper §IV.C).
        sample: FleetRoundSample | None = None
        if n_total > 0:
            sample = tier.sample_round(np.arange(n_total), round_idx)
        n_bench = min(benchmark_devices, n_total - num_logical)
        for k in range(n_bench):
            rep = sample.report(num_logical + k)
            reports.append(rep)
            tier.reports.append(rep)

        breakdown: dict[str, GradeRoundBreakdown] = {}
        if arrival_times is None and sample is not None:
            base = 0.0 if self.deviceflow is None else self.deviceflow.clock.now
            arrival_times = base + sample.arrival_offsets_s()
        if sample is not None:
            offsets_s = sample.arrival_offsets_s()
            breakdown[tier.grade.name] = GradeRoundBreakdown(
                grade=tier.grade.name,
                num_logical=num_logical,
                num_physical=n_total - num_logical,
                num_benchmarking=n_bench,
                makespan_s=float(offsets_s.max()),
                mean_duration_s=float(offsets_s.mean()),
            )

        batches = [e for e in emissions if isinstance(e, ArrivalBatch)]
        if self.deviceflow is not None:
            if not self.stream_chunks:  # streamed rounds already submitted
                if batches:
                    ts = (None if arrival_times is None else np.concatenate([
                        arrival_times[e.device_ids]
                        if isinstance(e, ArrivalBatch)
                        else arrival_times[e.device_id:e.device_id + 1]
                        for e in emissions]))
                    self.deviceflow.submit_arrivals(emissions, ts=ts)
                else:
                    self.deviceflow.submit_many(emissions, ts=arrival_times)
            # The round ends when the slowest device reports, not at clock.now.
            t_end = (float(np.max(arrival_times))
                     if arrival_times is not None and len(arrival_times)
                     else None)
            self.deviceflow.round_complete(task_id, t=t_end)
        if self.recycle_buffers:
            self._retired, self._staged = self._staged, {}
        return FederatedRoundOutcome(
            num_logical=num_logical,
            num_physical=n_total - num_logical,
            messages=(ArrivalMessageView(emissions) if batches
                      else emissions),
            batches=batches,
            reports=reports,
            arrival_times=arrival_times,
            per_grade=breakdown,
            client_metrics=metrics,
        )
