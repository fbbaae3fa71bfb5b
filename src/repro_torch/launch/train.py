"""Federated LM training driver — SimDC end-to-end on the LM substrate.

The cloud model is one of the assigned architectures; simulated device
cohorts produce update messages that flow through **DeviceFlow** under a
configurable traffic strategy; the **aggregation trigger** (sample-threshold
or scheduled) gates the global update; the cloud-side trainer runs
``train_step``s with checkpoint/restart.

Two modes, as in the reference (``src/repro/launch/train.py``):
  --mode cloud      pure datacenter pretraining loop (no federation) — the
                    substrate driver used by examples/lm_pretrain.py.
  --mode federated  the full SimDC loop (default); ``--tasks N`` runs N
                    contending tasks on one pool through ``TaskEngine``.

Run on the card (the default) or, with ``--device cpu``, on the CPU::

    python -m repro_torch.launch.train --mode cloud --smoke --device cpu
    python -m repro_torch.launch.train --smoke --traffic curve --device cpu

On one card there is no mesh: ``--fleet-shards`` and ``--multi-pod`` raise
(they come with the distribution slice), and the cloud step is
``distribution.steps.build_train_step(cfg, None, shape)``.  Without
``--smoke`` the cloud step runs the published config at ``--shape``.

Federated clients are ``torch.func.vmap`` over ``grad`` of the model's
``loss_fn`` on flat param dicts (the port's simulation moves flat
``{name: tensor}`` dicts; :func:`flat_params` and :func:`nest_params`
convert), with ``remat=False``: ``torch.utils.checkpoint`` does not run
under ``torch.func`` and remat changes no number.

Two departures from the reference, both so that a run can resume to the
same numbers: the cloud loop restores the token pipeline's position from
the checkpoint it resumes from (the reference saves it and never reads it
back), and every entry point takes ``init_state=`` / ``init_params=`` so a
caller can start both packages from the same params.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.func import grad_and_value

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.allocation import solve_allocation
from repro_torch.core.calibration import RuntimeCalibrator
from repro_torch.core.deviceflow import ArrivalBatch, DeviceFlow, Message
from repro_torch.core.devicemodel import GRADES
from repro_torch.core.federation import (
    AggregationService,
    ClientCountTrigger,
    SampleThresholdTrigger,
    ScheduledTrigger,
)
from repro_torch.core.scheduler import ResourceManager, ResourcePool, TaskEngine
from repro_torch.core.simulation import (
    DeviceTier,
    HybridSimulation,
    LogicalTier,
    RoundPlan,
)
from repro_torch.core.strategies import AccumulatedStrategy, TimeIntervalStrategy
from repro_torch.core.task import GradeSpec, OperatorFlow, Task
from repro_torch.core.traffic_curves import right_tailed_normal
from repro_torch.core.updates import UpdateBuffer, UpdateHandle
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distribution.steps import build_train_step, init_train_state
from repro_torch.models.registry import get_model
from repro_torch.optim.compression import (
    topk_compress,
    topk_compress_rows,
    topk_init,
)
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.runtime.fault_tolerance import TrainingSupervisor

_ONE_CARD = ("{flag} needs a device mesh; the port runs on one card and "
             "sharded runs come with the distribution slice (ROADMAP Step 5)")


def make_small_shape(cfg, *, seq_len=128, global_batch=8, microbatches=2):
    return ShapeConfig("local", seq_len, global_batch, "train",
                       microbatches=microbatches)


# --------------------------------------------------------------------------- #
# Flat param dicts: the simulation's and the aggregation's currency
# --------------------------------------------------------------------------- #
def flat_params(tree, prefix: str = "") -> dict:
    """A nested dict/list param tree as a flat ``{"a/0/b": tensor}`` dict."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def nest_params(flat: dict):
    """The inverse of :func:`flat_params` (numeric path parts are list
    indices)."""
    root: dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _make_local_train(api, cfg, client_lr):
    """One SGD epoch on the client model — shared between the coordinator's
    tiers and spawned workers so pooled chunks stay bit-identical."""

    def local_train(params, batch, _rng):
        def loss(p):
            return api.loss_fn(nest_params(p), batch, cfg, remat=False)[0]

        grads, value = grad_and_value(loss)(params)
        new = {k: (p.to(torch.float32) - client_lr * grads[k].to(torch.float32)
                   ).to(p.dtype) for k, p in params.items()}
        return new, value

    return local_train


def _federated_worker_tiers(*, arch, grades, seed, client_lr, cohort,
                            device="cuda"):
    """Module-level ``WorkerSpec`` factory (spawn pickles it by reference):
    rebuilds the coordinator's tiers from plain kwargs inside each worker."""
    cfg = get_config(arch, smoke=True)
    api = get_model(cfg)
    local_train = _make_local_train(api, cfg, client_lr)
    return (LogicalTier(local_train, cohort_size=cohort, device=device),
            {g: DeviceTier(local_train, GRADES[g], seed=seed, device=device)
             for g in grades})


def _init_params(api, cfg, seed, device, init_params):
    """Flat global params: ``init_params(cfg, seed, device)`` when given
    (a nested tree, e.g. the reference's params through numpy), else the
    model's seeded ``init``."""
    tree = (init_params(cfg, seed, device) if init_params is not None
            else api.init(seed, cfg, device=device))
    return flat_params(tree)


# --------------------------------------------------------------------------- #
# Cloud training
# --------------------------------------------------------------------------- #
def make_cloud_step(cfg, shape: ShapeConfig, pipe: TokenPipeline, *,
                    opt_cfg: AdamWConfig = AdamWConfig(), device="cuda"):
    """``step(state) -> (state, metrics)``: the next batch from ``pipe``,
    cut into ``shape.microbatches`` microbatches on ``device``, through
    ``build_train_step(cfg, None, shape, opt_cfg)`` — what
    :func:`cloud_training` runs each step, reachable without the
    supervisor."""
    dev = resolve_device(device)
    train_step, _, _ = build_train_step(cfg, None, shape, opt_cfg)
    n, mb = shape.microbatches, shape.global_batch // shape.microbatches

    def step(state):
        b = next(pipe)
        batch = {k: torch.from_numpy(np.ascontiguousarray(
            getattr(b, k).reshape(n, mb, -1))).to(dev)
            for k in ("tokens", "targets", "mask")}
        return train_step(state, batch)

    return step


def cloud_training(args, *, init_state=None) -> dict:
    """Datacenter pretraining loop with checkpoint/restart.
    ``init_state(cfg, seed, device)`` replaces the seeded initial state."""
    if args.multi_pod:
        raise NotImplementedError(_ONE_CARD.format(flag="--multi-pod"))
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = make_small_shape(cfg) if args.smoke else SHAPES[args.shape]
    state = (init_state(cfg, args.seed, dev) if init_state is not None
             else init_train_state(cfg, seed=args.seed, device=dev))
    pipe = TokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch,
                         seed=args.seed)
    step = make_cloud_step(cfg, shape, pipe, device=dev)
    ckpt = Checkpointer(args.checkpoint_dir)
    losses = []

    def one_step(state, i):
        state, metrics = step(state)
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return state

    sup = TrainingSupervisor(ckpt, checkpoint_every=args.checkpoint_every)
    sup.run(state, one_step, args.steps,
            extra_fn=lambda: {"pipeline": pipe.state_dict()},
            on_restore=lambda extra: pipe.load_state_dict(extra["pipeline"]))
    return {"final_loss": losses[-1] if losses else None, "losses": losses}


# --------------------------------------------------------------------------- #
# Federated training
# --------------------------------------------------------------------------- #
def _client_batch(toks: np.ndarray, seq: int, device) -> dict:
    n = toks.shape[0]
    return {"tokens": torch.from_numpy(toks[:, None, :-1].copy()).to(device),
            "targets": torch.from_numpy(toks[:, None, 1:].copy()).to(device),
            "mask": torch.ones((n, 1, seq), dtype=torch.float32,
                               device=device)}


def _mean_client_loss(metrics: list) -> float:
    """Per-device losses, flattened across chunks — chunks have unequal
    sizes, so averaging chunk means would bias toward small chunks."""
    def first(m):
        return next(iter(m.values())) if isinstance(m, dict) else m
    return float(torch.cat([first(m).detach().float().reshape(-1).cpu()
                            for m in metrics]).mean())


class _TopKEmission:
    """``--compress``: each emission top-k compressed with error feedback
    kept per chunk (the reference's ``compress_emission``)."""

    def __init__(self, fraction: float):
        self.fraction = fraction
        self.residuals: dict = {}

    def __call__(self, e):
        if isinstance(e, ArrivalBatch) and e.buffer is not None:
            # Bench splits leave several batches sharing one buffer with
            # disjoint row ranges: this batch's rows first.
            rows = torch.as_tensor(np.asarray(e.rows),
                                   device=e.buffer.device)
            stacked = {k: leaf.index_select(0, rows).reshape((e.n,) + shape)
                       for k, leaf, shape in zip(e.buffer.keys,
                                                 e.buffer.leaves2d,
                                                 e.buffer.shapes)}
            # Error-feedback memory keyed by the chunk identity.
            key = (e.task_id, int(e.device_ids[0]), e.n)
            kept, res, nnz = topk_compress_rows(
                stacked, self.residuals.get(key), fraction=self.fraction)
            self.residuals[key] = res
            # Wire size per row = kept (value, int32 index) pairs; floor at
            # one entry so nbytes=0 never reads as "unset".
            return ArrivalBatch(
                e.task_id, e.round_idx, rows=np.arange(e.n, dtype=np.int64),
                created_t=e.created_t, nbytes=np.maximum(nnz, 1) * 8,
                num_samples=e.num_samples, device_ids=e.device_ids,
                buffer=UpdateBuffer.from_stacked(kept))
        if isinstance(e, Message):
            payload = (e.payload.materialize()
                       if isinstance(e.payload, UpdateHandle) else e.payload)
            kept, _, stats = topk_compress(payload, topk_init(payload),
                                           fraction=self.fraction)
            return dataclasses.replace(
                e, payload=kept, size_bytes=max(stats["nonzero"], 1) * 8)
        return e


def federated_training(args, *, init_params=None) -> dict:
    """SimDC federated loop: grade-partitioned rounds -> DeviceFlow ->
    FedAvg, with the allocation re-solved every round on fleet-calibrated
    runtimes (as the reference's ``federated_training``)."""
    if args.fleet_shards:
        raise NotImplementedError(_ONE_CARD.format(flag="--fleet-shards"))
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)  # clients train the reduced model
    api = get_model(cfg)
    rng = np.random.default_rng(args.seed)
    global_params = _init_params(api, cfg, args.seed, dev, init_params)

    trigger = (SampleThresholdTrigger(args.sample_threshold)
               if args.trigger == "samples"
               else ScheduledTrigger(args.trigger_period))
    svc = AggregationService(global_params, trigger=trigger)
    flow = DeviceFlow(svc, seed=args.seed)
    task_id = 0
    if args.traffic == "realtime":
        flow.register_task(task_id, AccumulatedStrategy(
            thresholds=(1,), failure_prob=args.dropout))
    else:
        flow.register_task(task_id, TimeIntervalStrategy(
            curve=right_tailed_normal(args.sigma), interval=args.round_seconds,
            failure_prob=args.dropout))

    local_train = _make_local_train(api, cfg, args.client_lr)
    grade_names = [g.strip() for g in args.grades.split(",") if g.strip()]
    cohort = args.clients_per_round
    per_grade = [cohort // len(grade_names)] * len(grade_names)
    per_grade[0] += cohort - sum(per_grade)
    specs = [
        GradeSpec(g, n, logical_bundles=max(1, n // 2), bundles_per_device=1,
                  physical_devices=max(1, n // 4))
        for g, n in zip(grade_names, per_grade)
    ]

    worker_kw = {}
    if args.workers:
        from repro_torch.runtime.workers import WorkerSpec
        worker_kw = dict(
            workers=args.workers,
            worker_spec=WorkerSpec(
                _federated_worker_tiers,
                kwargs=dict(arch=args.arch, grades=tuple(grade_names),
                            seed=args.seed, client_lr=args.client_lr,
                            cohort=cohort, device=str(dev))))
    sim = HybridSimulation(
        LogicalTier(local_train, cohort_size=cohort, device=dev),
        tiers={g: DeviceTier(local_train, GRADES[g], seed=args.seed,
                             device=dev)
               for g in grade_names},
        deviceflow=flow,
        wire=args.wire_format,
        error_feedback=(args.error_feedback == "on"),
        payload_transform=(_TopKEmission(args.compress_fraction)
                           if args.compress else None),
        **worker_kw)
    cal = RuntimeCalibrator()  # Table-I prior until fleets report in

    losses = []
    seq = 64
    for rnd in range(args.rounds):
        plan = RoundPlan.from_allocation(
            solve_allocation(specs, cal.runtimes_for(specs)), specs)
        grade_batches, grade_counts = {}, {}
        for spec in specs:
            toks = rng.integers(
                1, cfg.vocab_size,
                size=(spec.num_devices, seq + 1)).astype(np.int32)
            grade_batches[spec.grade] = _client_batch(toks, seq, dev)
            grade_counts[spec.grade] = np.full(spec.num_devices, seq)
        outcome = sim.run_plan_round(
            task_id, rnd, svc.global_params, plan, grade_batches,
            grade_counts, torch.Generator().manual_seed(rnd), calibrator=cal)
        losses.append(_mean_client_loss(outcome.client_metrics))
        round_end = float(np.max(outcome.arrival_times))
        # Rule-based dispatch points extend up to round_seconds past the
        # round end; the run window must cover them.
        flow.run(round_end + args.round_seconds)
        svc.tick(flow.clock.now)
        lat = svc.history[-1].mean_latency_s if svc.history else 0.0
        print(f"round {rnd:3d} client-loss {losses[-1]:.4f} "
              f"aggregations {len(svc.history)} "
              f"mean-latency {lat:.1f}s "
              f"shelf {len(flow.shelf(task_id))}", flush=True)
    # Drain capacity-spill dispatches scheduled past the last window.
    flow.run()
    svc.tick(flow.clock.now)
    shelf = flow.shelf(task_id)
    out = {"losses": losses, "aggregations": len(svc.history),
           "wire_bytes_received": int(shelf.total_bytes_received),
           "wire_bytes_dispatched": int(shelf.total_bytes_dispatched)}
    if sim.pool is not None:
        st = sim.pool.stats
        print(f"workers: {args.workers} chunks {st['chunks']} "
              f"segments {st['segments_created']} "
              f"(reused {st['segment_reuses']}) "
              f"shipped {st['bytes_shipped'] / 1e6:.1f}MB "
              f"redispatched {st['redispatched_chunks']}", flush=True)
        out["worker_chunks"] = st["chunks"]
        out["worker_segment_reuses"] = st["segment_reuses"]
    sim.close()
    return out


class _TaskRouter:
    """DeviceFlow deliver callback fanning out to per-task services."""

    def __init__(self):
        self.services: dict[int, AggregationService] = {}

    def __call__(self, d):
        self.services[d.task_id](d)


def multi_task_federated(args, *, init_params=None) -> dict:
    """``--tasks N``: event-driven multi-task rounds on one shared pool
    (the reference's ``multi_task_federated``): N federated LM tasks
    contend for a pool sized to fit about half of them, the ``TaskEngine``
    interleaves their rounds on DeviceFlow's clock, every round streams its
    chunks into the task's streaming ``AggregationService``."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    api = get_model(cfg)
    rng = np.random.default_rng(args.seed)
    seq = 64
    n_clients = args.clients_per_round
    local_train = _make_local_train(api, cfg, args.client_lr)

    spec = GradeSpec("High", n_clients, logical_bundles=max(1, n_clients // 2),
                     bundles_per_device=1,
                     physical_devices=max(1, n_clients // 4))
    if args.priorities:
        prios = [int(p) for p in args.priorities.split(",") if p.strip()]
        priorities = [prios[i % len(prios)] for i in range(args.tasks)]
    else:
        priorities = [args.tasks - i for i in range(args.tasks)]
    tasks = [Task(OperatorFlow(("train",)), (spec,), rounds=args.rounds,
                  priority=priorities[i]) for i in range(args.tasks)]
    fit = max(1, -(-args.tasks // 2))
    rm = ResourceManager(ResourcePool(
        {"High": spec.logical_bundles * fit + 1},
        {"High": spec.physical_devices * fit}))

    router = _TaskRouter()
    flow = DeviceFlow(router, seed=args.seed)
    for task in tasks:
        router.services[task.task_id] = AggregationService(
            _init_params(api, cfg, args.seed + task.task_id, dev,
                         init_params),
            trigger=ClientCountTrigger(n_clients), streaming=True)
        flow.register_task(task.task_id, AccumulatedStrategy(
            thresholds=(1,), failure_prob=args.dropout))

    sim = HybridSimulation(
        LogicalTier(local_train, cohort_size=max(2, n_clients // 2),
                    device=dev),
        tiers={"High": DeviceTier(local_train, GRADES["High"],
                                  seed=args.seed, device=dev)},
        deviceflow=flow, stream_chunks=True)
    cal = RuntimeCalibrator()
    measured_total = [0.0]  # sum of measured round durations = serial

    def round_runner(task, round_idx, allocation, t):
        svc = router.services[task.task_id]
        plan = RoundPlan.from_allocation(allocation, task.grades)
        toks = rng.integers(1, cfg.vocab_size,
                            size=(n_clients, seq + 1)).astype(np.int32)
        outcome = sim.run_plan_round(
            task.task_id, round_idx, svc.global_params, plan,
            {"High": _client_batch(toks, seq, dev)},
            {"High": np.full(n_clients, seq)},
            torch.Generator().manual_seed(1000 * task.task_id + round_idx),
            calibrator=cal)
        measured_total[0] += outcome.makespan_s
        return outcome.makespan_s

    engine = TaskEngine(rm, cal, round_runner=round_runner,
                        clock=flow.clock, elastic=True,
                        preemptive=args.preemptive)
    t0 = time.perf_counter()
    for i, task in enumerate(tasks):
        engine.submit(task, at=i * args.arrival_gap or None)
    result = engine.drain()
    wall_s = time.perf_counter() - t0
    serial_est = measured_total[0]
    for ex in result:
        print(f"task {ex.task.task_id}: prio={ex.task.priority} "
              f"rounds={ex.rounds_done} "
              f"start={ex.started_t:.0f}s finish={ex.finished_t:.0f}s "
              f"queue-delay={ex.queueing_delay_s:.0f}s "
              f"grant-util={ex.grant_utilization:.2f} "
              f"reallocations={ex.reallocations} "
              f"preemptions={ex.preemptions} "
              f"aggregations={len(router.services[ex.task.task_id].history)}",
              flush=True)
    print(f"interleaved makespan {engine.makespan:.0f}s vs serial estimate "
          f"{serial_est:.0f}s ({serial_est / max(engine.makespan, 1e-9):.2f}x)"
          f"; stranded={len(result.stranded)}; wall {wall_s:.1f}s", flush=True)
    top_prio = max(priorities)
    hi_delays = [ex.queueing_delay_s for ex in result
                 if ex.task.priority == top_prio]
    return {"makespan_s": engine.makespan, "serial_estimate_s": serial_est,
            "completed": len(result), "stranded": len(result.stranded),
            "top_priority_queueing_delay_s": max(hi_delays, default=0.0)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_3b")
    ap.add_argument("--mode", choices=("cloud", "federated"),
                    default="federated")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--tasks", type=int, default=1,
                    help="number of contending federated tasks; >1 runs the "
                         "event-driven multi-task engine on one shared pool")
    ap.add_argument("--priorities", default="",
                    help="comma-separated per-task scheduling priorities "
                         "(cycled to --tasks), e.g. '5,1,1'")
    ap.add_argument("--preemptive", action="store_true",
                    help="let higher-priority tasks refreeze lower-priority "
                         "grants down at round boundaries")
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    help="virtual seconds between successive task arrivals "
                         "(task i submits at i*gap)")
    ap.add_argument("--clients-per-round", type=int, default=8)
    ap.add_argument("--grades", default="High",
                    help="comma-separated device grades, e.g. High,Low")
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--trigger", choices=("samples", "scheduled"),
                    default="samples")
    ap.add_argument("--sample-threshold", type=int, default=256)
    ap.add_argument("--trigger-period", type=float, default=30.0)
    ap.add_argument("--traffic", choices=("realtime", "curve"),
                    default="realtime")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--round-seconds", type=float, default=60.0)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--workers", type=int, default=0,
                    help="shard cohort execution across N worker processes "
                         "(shared-memory columnar transport; 0 = in-process); "
                         "federated single-task mode only")
    ap.add_argument("--fleet-shards", type=int, default=0,
                    help="a fleet mesh of this many data shards; needs the "
                         "distribution slice (raises on one card)")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--compress-fraction", type=float, default=0.01)
    ap.add_argument("--wire-format", choices=("f32", "int8"), default="f32",
                    help="update wire format: int8 quantizes each row "
                         "(~4x fewer bytes per round) with "
                         "dequantize-and-reduce aggregation")
    ap.add_argument("--error-feedback", choices=("on", "off"), default="on",
                    help="carry int8 quantization residuals across rounds "
                         "(EF-SGD); only affects --wire-format int8")
    ap.add_argument("--checkpoint-dir", default="artifacts/ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' (the default) raises "
                         "without a card")
    return ap


def run(argv=None, **init) -> dict:
    """Parses ``argv`` and runs the chosen mode; returns its result dict
    (``init`` passes ``init_state=`` or ``init_params=`` through)."""
    args = parser().parse_args(argv)
    if args.mode == "cloud":
        out = cloud_training(args, **init)
    elif args.tasks > 1:
        out = multi_task_federated(args, **init)
    else:
        out = federated_training(args, **init)
    print("DONE", {k: v for k, v in out.items() if k != "losses"})
    return out


def main(argv=None):
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
