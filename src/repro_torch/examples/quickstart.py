"""Quickstart: the SimDC platform end to end, on the port.

Simulates a small two-grade federated CTR task: fleet-calibrated runtimes
drive the hybrid allocator, a ``RoundPlan`` maps each grade's split onto its
own logical/device cohorts, the per-grade fleet-sampled Table-I round
durations become per-message arrival times through DeviceFlow, and the
cloud aggregates with FedAvg (the ``fed_reduce`` kernel on a card).

Sections, numbered as in the JAX package's ``examples/quickstart.py``:

1. calibrate per-grade runtimes from measured fleet rounds;
2. hybrid allocation (paper Eq. 1);
3. data and the client-local training operator;
4. the cloud service behind DeviceFlow;
5. grade-partitioned hybrid rounds (zero-copy: updates stay on the card as
   ``UpdateBuffer``s, messages carry handles);
6. event-driven multi-task scheduling: two contending tasks time-share one
   pool through ``TaskEngine`` with elastic re-allocation;
7. preemptive priority scheduling, and ``monte_carlo_schedules`` over
   sampled timelines;
8. the columnar message plane (one ``ArrivalBatch`` per cohort chunk);
9. the int8 wire with error feedback;
10. continuous-batching serving under diurnal traffic;
11. multi-process fleet execution: the shared-memory segment layout of one
    chunk (``HybridSimulation(workers=N, worker_spec=...)`` runs pooled
    rounds bit-identical to in-process ones);
12. invariants and sanitizers: the port's simcheck lint over ``src/`` and
    a recycled buffer fenced by the use-after-recycle sanitizer.

Run on the card (the default) or on the CPU::

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from repro_torch.analysis import lint, sanitizers
from repro_torch.configs.registry import get_config
from repro_torch.core import (
    AccumulatedStrategy,
    AggregationService,
    ArrivalBatch,
    ClientCountTrigger,
    ContinuousBatchingEngine,
    ContinuousServer,
    DeviceFlow,
    GradeSpec,
    OperatorFlow,
    ResourceManager,
    ResourcePool,
    RoundPlan,
    RuntimeCalibrator,
    SampleThresholdTrigger,
    ServeCostModel,
    Task,
    TaskEngine,
    UpdateBuffer,
    VirtualClock,
    diurnal,
    monte_carlo_schedules,
    solve_allocation,
)
from repro_torch.core.devicemodel import GRADES, DeviceFleet
from repro_torch.core.simulation import (
    DeviceTier,
    HybridSimulation,
    LogicalTier,
)
from repro_torch.data.synthetic_ctr import make_federated_ctr
from repro_torch.device import resolve_device
from repro_torch.launch.serve import BatchedServer, run_trace
from repro_torch.models import ctr
from repro_torch.runtime.workers import segment_layout

N_HIGH, N_LOW, RECORDS, DIM, ROUNDS = 16, 8, 16, 64, 4


def _specs() -> list[GradeSpec]:
    return [
        GradeSpec("High", N_HIGH, benchmarking_devices=1, logical_bundles=8,
                  bundles_per_device=4, physical_devices=8),
        GradeSpec("Low", N_LOW, benchmarking_devices=1, logical_bundles=16,
                  bundles_per_device=2, physical_devices=2),
    ]


def _rounds(plan, cal, grade_batches, grade_counts, local_train, dev, *,
            wire: str):
    """Quickstart rounds on ``wire``: yields (service, flow, sim, outcome)
    after each round."""
    svc = AggregationService(
        ctr.lr_init(DIM, device=dev),
        trigger=SampleThresholdTrigger((N_HIGH + N_LOW) * RECORDS // 2))
    flow = DeviceFlow(svc)
    flow.register_task(0, AccumulatedStrategy(thresholds=(1,)))
    sim = HybridSimulation(
        LogicalTier(local_train, cohort_size=16, device=dev),
        tiers={g: DeviceTier(local_train, GRADES[g], device=dev)
               for g in ("High", "Low")},
        deviceflow=flow, wire=wire, error_feedback=True)
    for rnd in range(ROUNDS):
        outcome = sim.run_plan_round(
            task_id=0, round_idx=rnd, global_params=svc.global_params,
            plan=plan, grade_batches=grade_batches,
            grade_num_samples=grade_counts,
            rng=torch.Generator().manual_seed(rnd), calibrator=cal)
        if wire == "int8":
            flow.run(1e12)
            svc.tick(flow.clock.now)
        yield svc, flow, sim, outcome


def run(device="cuda") -> dict:
    """Runs the ported sections, prints the reference's lines and returns
    their values (``"lines"``: the printed lines in order)."""
    dev = resolve_device(device)
    lines: list[str] = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    specs = _specs()
    # 1. Calibrate per-grade runtimes from measured fleet rounds (paper
    #    §IV.C): the allocator runs on data, not hand-coded constants.
    cal = RuntimeCalibrator()
    for g in ("High", "Low"):
        probe = DeviceFleet(GRADES[g], 64, seed=7)  # pre-measurement fleet
        for r in range(3):
            cal.observe_fleet(probe.run_round(r))

    # 2. Hybrid allocation (paper Eq. 1): per-grade logical/physical split.
    alloc = solve_allocation(specs, cal.runtimes_for(specs))
    plan = RoundPlan.from_allocation(alloc, specs)
    for e in plan.entries:
        say(f"allocation[{e.grade}]: {e.num_logical} logical / "
            f"{e.num_physical} physical / {e.num_benchmarking} benchmarking")
    say(f"estimated makespan {alloc.makespan:.1f}s")

    # 3. Data + client-local training operator (shared across grades).
    local_train = ctr.make_local_train_fn(lr=1e-3, epochs=10)
    grade_batches, grade_counts = {}, {}
    for i, spec in enumerate(specs):
        data = make_federated_ctr(num_devices=spec.num_devices,
                                  records_per_device=RECORDS, dim=DIM,
                                  seed=i)
        X, Y, counts = data.stacked_shards(np.arange(spec.num_devices),
                                           RECORDS)
        mask = (np.arange(RECORDS)[None] < counts[:, None]).astype(
            np.float32)
        grade_batches[spec.grade] = {
            k: torch.as_tensor(v, device=dev)
            for k, v in (("x", X), ("y", Y), ("mask", mask))}
        grade_counts[spec.grade] = counts
    test = make_federated_ctr(num_devices=64, dim=DIM, seed=9)
    test_x = torch.as_tensor(test.features, device=dev)
    test_y = torch.as_tensor(test.labels, device=dev)

    # 4-5. The cloud service behind DeviceFlow (real-time dispatch) and the
    #    grade-partitioned hybrid rounds: one DeviceTier+fleet per grade;
    #    every round's fleet samples feed the calibrator.
    accs = []
    for rnd, (svc, flow, sim, outcome) in enumerate(_rounds(
            plan, cal, grade_batches, grade_counts, local_train, dev,
            wire="f32")):
        acc = float(ctr.accuracy(svc.global_params, test_x, test_y))
        accs.append(acc)
        per_grade = " ".join(f"{g}={b.makespan_s:.0f}s"
                             for g, b in outcome.per_grade.items())
        say(f"round {rnd}: aggregations={len(svc.history)} "
            f"test_acc={acc:.4f} makespan[{per_grade}] "
            f"round_end_t={outcome.makespan_s:.1f}s")
    shelf = flow.shelf(0)
    say(f"deviceflow traffic: {shelf.total_bytes_dispatched / 1024:.1f} KiB "
        f"dispatched across {shelf.total_dispatched} update messages")
    rts = cal.runtimes_for(specs)
    say("re-measured runtimes: " + "; ".join(
        f"{s.grade}: alpha={r.alpha:.1f} beta={r.beta:.1f} lam={r.lam:.1f}"
        for s, r in zip(specs, rts)))
    for rep in sim.tiers["High"].reports[:1]:
        say(f"benchmark-device report ({rep.grade}): "
            f"{rep.total_power_mah:.2f} mAh, {rep.total_duration_min:.2f} min")

    # 6. Event-driven multi-task scheduling: two contending tasks time-share
    #    ONE pool.  Task A freezes its full demand; task B is admitted
    #    elastically on what is left, and when A finishes the engine
    #    re-solves B's allocation with the freed resources.  Rounds
    #    interleave as events on the shared VirtualClock, far below the
    #    serial back-to-back drain.
    rm = ResourceManager(ResourcePool({"High": 12}, {"High": 4}))
    make_task = lambda prio: Task(
        OperatorFlow(("train",)),
        (GradeSpec("High", 24, logical_bundles=8, bundles_per_device=1,
                   physical_devices=3),),
        rounds=3, priority=prio)
    task_a, task_b = make_task(1), make_task(0)
    engine = TaskEngine(rm, cal, elastic=True)  # calibrated runtimes
    engine.submit(task_a)
    engine.submit(task_b)
    engine.run_until()
    serial_s = sum(ex.task.rounds * ex.allocation.makespan
                   for ex in engine.completed)
    for ex in engine.completed:
        say(f"task {ex.task.task_id}: start={ex.started_t:.0f}s "
            f"finish={ex.finished_t:.0f}s rounds={ex.rounds_done} "
            f"elastic-reallocations={ex.reallocations}")
    say(f"interleaved makespan {engine.makespan:.0f}s "
        f"(serial drain would take ~{serial_s:.0f}s)")

    # 7. Preemptive priority scheduling: two low-priority tasks freeze the
    #    WHOLE pool; a high-priority task arrives mid-round-0.  Without
    #    preemption it waits for a full task completion; with
    #    ``preemptive=True`` a victim's grant is refrozen down (here: to
    #    zero, PAUSED with its progress kept) at its next round boundary.
    def contended(preemptive):
        rm7 = ResourceManager(ResourcePool({"High": 16}, {"High": 6}))
        eng = TaskEngine(rm7, cal, elastic=True, preemptive=preemptive)
        low = [make_task(0), make_task(0)]  # together they fill the pool
        urgent = make_task(9)
        for t in low:
            eng.submit(t)
        eng.submit(urgent, at=60.0)  # arrives while both run round 0
        eng.run_until()
        return eng, urgent

    for preemptive in (False, True):
        eng7, urgent = contended(preemptive)
        ex = eng7.executions[urgent.task_id]
        mode = "preemptive" if preemptive else "non-preemptive"
        victims = [e for e in eng7.completed
                   if e.task.task_id != urgent.task_id]
        say(f"{mode}: urgent task queued {ex.queueing_delay_s:.0f}s, "
            f"victim preemptions={sum(e.preemptions for e in victims)}, "
            f"victim grant-utilization="
            f"{min(e.grant_utilization for e in victims):.2f}")

    # Monte-Carlo makespan estimation: the same contention replayed over N
    # sampled timelines (round durations drawn from the calibrator's
    # observations, not their mean).
    low_mc = [make_task(0), make_task(0)]
    urgent_mc = make_task(9)
    mc = monte_carlo_schedules(
        low_mc + [urgent_mc], ResourcePool({"High": 16}, {"High": 6}), cal,
        arrivals={urgent_mc.task_id: 60.0}, n_samples=24, seed=0)
    for preemptive, est in mc.items():
        mode = "preemptive" if preemptive else "non-preemptive"
        say(f"monte-carlo {mode}: mean makespan {est.mean_makespan_s:.0f}s "
            f"(p95 {est.p95_makespan_s:.0f}s), urgent mean queue-delay "
            f"{est.mean_queueing_delay_s(urgent_mc.task_id):.0f}s")

    # 8. Columnar message plane: a whole cohort chunk is ONE struct-of-arrays
    #    ``ArrivalBatch`` (row indices into a shared device-resident
    #    ``UpdateBuffer`` plus created_t/nbytes columns), so DeviceFlow does
    #    O(chunks) Python work instead of O(devices).
    CHUNK, N_DEV = 256, 1024
    svc8 = AggregationService({"w": torch.zeros(DIM, device=dev)},
                              trigger=ClientCountTrigger(N_DEV))
    flow8 = DeviceFlow(svc8)
    flow8.register_task(0, AccumulatedStrategy(thresholds=(N_DEV,)))
    for lo in range(0, N_DEV, CHUNK):
        stacked = {"w": 1e-3 * torch.arange(
            CHUNK * DIM, dtype=torch.float32, device=dev).reshape(CHUNK, DIM)}
        chunk_buf = UpdateBuffer.from_stacked(stacked)
        flow8.submit_batch(
            ArrivalBatch.from_buffer(0, 0, chunk_buf,
                                     device_ids=np.arange(lo, lo + CHUNK)),
            ts=np.linspace(lo / N_DEV, (lo + CHUNK) / N_DEV, CHUNK))
    shelf8 = flow8.shelf(0)
    view_id = ArrivalBatch.from_buffer(0, 0, chunk_buf).message(0).device_id
    say(f"columnar plane: {N_DEV} device-messages in {N_DEV // CHUNK} "
        f"batches -> aggregations={len(svc8.history)} "
        f"bytes={shelf8.total_bytes_dispatched // 1024} KiB "
        f"conservation_ok={flow8.conservation_ok(0)}; "
        f"scalar adapter view: "
        f"ArrivalBatch.from_buffer(0, 0, chunk_buf).message(0).device_id="
        f"{view_id}")

    # 9. Quantized wire: the SAME rounds as section 5 with int8 chunks
    #    (per-row scales, error feedback), reduced without a dense copy.
    *_, (svc9, flow9, _, _) = _rounds(plan, cal, grade_batches,
                                      grade_counts, local_train, dev,
                                      wire="int8")
    acc9 = float(ctr.accuracy(svc9.global_params, test_x, test_y))
    shelf9 = flow9.shelf(0)
    say(f"quantized wire: test_acc={acc9:.4f} (f32 run above: {acc:.4f}) "
        f"bytes={shelf9.total_bytes_dispatched / 1024:.1f} KiB vs "
        f"{shelf.total_bytes_dispatched / 1024:.1f} KiB f32 "
        f"({shelf.total_bytes_dispatched / shelf9.total_bytes_dispatched:.1f}"
        f"x cut, {len(svc9.history)} aggregations)")

    # 10. Continuous-batching serving under diurnal traffic: the same
    #     DeviceFlow clock drives LM inference; both modes charge virtual
    #     time from one ServeCostModel and decode the same tokens.
    cfg10 = get_config("llama3_2_3b", smoke=True)
    serve_kw = dict(prompt_len=8, decode_tokens=4, max_len=13, seed=0,
                    cost_model=ServeCostModel(), device=dev)
    trace10 = dict(requests=24, prompt_len=8, vocab_size=cfg10.vocab_size,
                   curve=diurnal(), interval=60.0, seed=0)
    fixed10 = BatchedServer(cfg10, batch_size=4, **serve_kw)
    run_trace(fixed10, **trace10)
    rep_fixed = fixed10.report()
    eng10 = ContinuousBatchingEngine(cfg10, slots=4, params=fixed10.params,
                                     **serve_kw)
    clock10 = VirtualClock()
    run_trace(ContinuousServer(eng10, clock10), clock=clock10, **trace10)
    rep_cont = eng10.report()
    occ10 = max(it.n_active for it in eng10.iterations)
    same_tokens = ({r.request_id: r.tokens for r in rep_fixed.records}
                   == {r.request_id: r.tokens for r in rep_cont.records})
    say(f"serving: fixed p50={rep_fixed.p50_latency_s * 1e3:.1f}ms "
        f"p99={rep_fixed.p99_latency_s * 1e3:.1f}ms | continuous "
        f"p50={rep_cont.p50_latency_s * 1e3:.1f}ms "
        f"p99={rep_cont.p99_latency_s * 1e3:.1f}ms "
        f"(p99 cut {rep_fixed.p99_latency_s / rep_cont.p99_latency_s:.0f}x, "
        f"peak occupancy {occ10}/{eng10.slots}, "
        f"token_identical={same_tokens})")

    # 11. Multi-process fleet execution: ``HybridSimulation(workers=N,
    #     worker_spec=WorkerSpec(factory, ...))`` runs cohort chunks in N
    #     spawned workers (on the simulation's card, each with its own CUDA
    #     context) while this process keeps DeviceFlow, the fleets and
    #     aggregation on the virtual clock.  Results come back through
    #     recycled shared-memory segments with only a slim (rows, shm_name)
    #     header on the pipe, so pooled rounds are bit-identical to
    #     in-process ones.  Both sides compute the segment layout from the
    #     update spec: one 8-row int8-wire chunk of a {w: (16,), b: ()}
    #     model is two int8 wire matrices, then one f32 scale column per
    #     leaf, each 64-byte aligned.
    layout11, nbytes11 = segment_layout([(16,), ()], ["float32", "float32"],
                                        rows=8, wire="int8")
    say(f"worker transport segment: {nbytes11} bytes: "
        f"{[(off, shape, str(dt)) for off, shape, dt in layout11]}")

    # 12. Invariants & sanitizers: the platform's performance story rests
    #     on a handful of easy-to-break invariants.  ``repro_torch.analysis``
    #     enforces them twice — statically (an AST linter, rules R002-R005)
    #     and dynamically (opt-in runtime sanitizers):
    #
    #         PYTHONPATH=src python -m repro_torch.analysis.lint src tests
    #         SIMDC_SANITIZE=1 python -m pytest -q tests/test_torch_*.py
    #
    #     The catalog of footguns, each with its rule ID:
    #       * R002 — wall-clock reads (``time.time`` etc.) in
    #         simulation-domain (``core/``) modules: simulated components
    #         must stamp time from the ``VirtualClock`` or replays stop
    #         being deterministic.
    #       * R003 — host syncs (``int()``/``.item()``/``.cpu()``/
    #         ``.tolist()``/``torch.cuda.synchronize()``) inside ``@hot_path``
    #         functions: one stray sync in the decode loop serializes the
    #         whole launch stream.
    #       * R004 — ``state_dict``/``load_state_dict`` key asymmetry: a
    #         written key the reader ignores is state that silently fails
    #         to restore.
    #       * R005 — shared-memory segments without a close/unlink/finalize
    #         path (or ``resource_tracker.unregister`` calls): segments
    #         outlive their creators and leak in /dev/shm.
    #     (The reference's R001 and R006 are about ``jax.jit`` donation and
    #     cohort jits, which the port does not have.)
    #
    #     With ``SIMDC_SANITIZE=1`` the runtime half arms itself: the
    #     ``@hot_path`` functions run with CUDA sync debugging set to
    #     "error", a recycled ``UpdateBuffer`` (``recycle_buffers=True``) is
    #     poisoned as its leaves are handed to the next round so a stale
    #     handle raises ``UseAfterRecycleError`` instead of reading the next
    #     round's rows, ``FleetWorkerPool.close()`` audits for pinned
    #     segments, and ``VirtualClock.schedule`` rejects events in the
    #     virtual past.  All of it is one truthiness check per call when
    #     disabled.
    findings12 = lint.lint_paths([pathlib.Path(__file__).resolve().parents[2]])
    say(f"simcheck lint over src/: {len(findings12)} finding(s)")
    buf12 = UpdateBuffer.from_stacked(
        {"w": torch.ones((4, DIM), device=dev)})
    with sanitizers.override(True):
        sanitizers.poison_recycled(buf12)
        try:
            buf12.leaves2d
        except sanitizers.UseAfterRecycleError:
            say("use-after-recycle fenced: a recycled buffer's access raises "
                "UseAfterRecycleError instead of reading the next round's "
                "rows")
    return {"lines": lines, "test_acc": accs, "test_acc_int8": acc9,
            "token_identical": same_tokens}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (cuda, or cpu)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
