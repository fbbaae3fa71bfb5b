"""The port's scheduler, calibration estimator and fault tolerance against
the reference: every scenario of ``tests/test_scheduler_events.py``,
``test_resource_manager.py``, ``test_federation.py:118``,
``test_calibration.py:99``, ``test_serving.py:197-270``,
``test_checkpoint_runtime.py:55-252`` and ``test_workers.py:227`` runs
through BOTH packages on the same inputs.

Both schedulers are pure Python, so timelines, grants, preemption
decisions, drain results and ``state_dict()`` outputs must be equal
exactly.  Tasks get explicit ``task_id``s in submission order (each package
numbers tasks from its own global counter), so states compare as plain
data.  The scenarios with real rounds hold the port's params to the
reference's round-update tolerance (bf16 device rows: 2e-2 relative) and
each package's resumed run to its uninterrupted one (1e-6, as the
reference's test does).
"""
import itertools
import json
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.checkpoint.checkpointer as j_ck  # noqa: E402
import repro.core.allocation as j_alloc  # noqa: E402
import repro.core.calibration as j_cal  # noqa: E402
import repro.core.deviceflow as j_flow  # noqa: E402
import repro.core.devicemodel as j_dm  # noqa: E402
import repro.core.federation as j_fed  # noqa: E402
import repro.core.scheduler as j_sched  # noqa: E402
import repro.core.simulation as j_sim  # noqa: E402
import repro.core.strategies as j_strat  # noqa: E402
import repro.core.task as j_task  # noqa: E402
import repro.core.updates as j_upd  # noqa: E402
import repro.launch.serve as j_serve  # noqa: E402
import repro.models.ctr as j_ctr  # noqa: E402
import repro.runtime.fault_tolerance as j_ft  # noqa: E402
import repro_torch.checkpoint.checkpointer as t_ck  # noqa: E402
import repro_torch.core.allocation as t_alloc  # noqa: E402
import repro_torch.core.calibration as t_cal  # noqa: E402
import repro_torch.core.deviceflow as t_flow  # noqa: E402
import repro_torch.core.devicemodel as t_dm  # noqa: E402
import repro_torch.core.federation as t_fed  # noqa: E402
import repro_torch.core.scheduler as t_sched  # noqa: E402
import repro_torch.core.simulation as t_sim  # noqa: E402
import repro_torch.core.strategies as t_strat  # noqa: E402
import repro_torch.core.task as t_task  # noqa: E402
import repro_torch.core.updates as t_upd  # noqa: E402
import repro_torch.launch.serve as t_serve  # noqa: E402
import repro_torch.models.ctr as t_ctr  # noqa: E402
import repro_torch.runtime.fault_tolerance as t_ft  # noqa: E402


def _pkg(name, ck, alloc, cal, flow, dm, fed, sched, sim, strat, task, upd,
         serve, ctr, ft):
    return types.SimpleNamespace(
        name=name, ck=ck, alloc=alloc, cal=cal, flow=flow, dm=dm, fed=fed,
        sched=sched, sim=sim, strat=strat, task=task, upd=upd, serve=serve,
        ctr=ctr, ft=ft)


REF = _pkg("ref", j_ck, j_alloc, j_cal, j_flow, j_dm, j_fed, j_sched, j_sim,
           j_strat, j_task, j_upd, j_serve, j_ctr, j_ft)
PORT = _pkg("port", t_ck, t_alloc, t_cal, t_flow, t_dm, t_fed, t_sched,
            t_sim, t_strat, t_task, t_upd, t_serve, t_ctr, t_ft)


class Tasks:
    """Task factory with explicit ids in submission order."""

    def __init__(self, P, start=1000):
        self.P = P
        self.ids = itertools.count(start)

    def make(self, *, rounds=3, priority=0, bundles=8, phones=2, n=10):
        P = self.P
        return P.task.Task(
            P.task.OperatorFlow(("train",)),
            (P.task.GradeSpec("High", n, logical_bundles=bundles,
                              physical_devices=phones),),
            rounds=rounds, priority=priority, task_id=next(self.ids))


def rts(P):
    return lambda t: [P.alloc.GradeRuntime(alpha=5.0, beta=8.0, lam=2.0)
                      ] * len(t.grades)


def pool(P, bundles, phones):
    return P.sched.ResourceManager(
        P.sched.ResourcePool({"High": bundles}, {"High": phones}))


def plain(x):
    """Nested state as JSON-comparable data (arrays as lists)."""
    if isinstance(x, dict):
        return {str(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def timeline(eng) -> dict:
    """Every execution's observable timeline as plain data."""
    out = {}
    for tid, ex in sorted(eng.executions.items()):
        out[tid] = {
            "state": ex.state.value, "started_t": ex.started_t,
            "finished_t": ex.finished_t, "rounds_done": ex.rounds_done,
            "preemptions": ex.preemptions,
            "reallocations": ex.reallocations,
            "preemption_decisions": [dict(d)
                                     for d in ex.preemption_decisions],
            "queued_s": ex.queued_s, "running_s": ex.running_s,
            "grant_seconds": ex.grant_seconds, "grant": dict(ex.grant),
            "queueing_delay_s": ex.queueing_delay_s,
            "grant_utilization": ex.grant_utilization,
            "makespan": ex.allocation.makespan,
        }
    return {"executions": out, "makespan": eng.makespan,
            "now": eng.clock.now,
            "completed": [ex.task.task_id for ex in eng.completed]}


# --------------------------------------------------------------------------- #
# test_scheduler_events.py, virtual time
# --------------------------------------------------------------------------- #
def sc_interleave(P):
    order = []
    tk = Tasks(P)
    rm = pool(P, 24, 6)
    eng = P.sched.TaskEngine(
        rm, rts(P), on_round_complete=lambda t, r: order.append(
            (t.task_id, r)))
    tasks = [tk.make() for _ in range(3)]
    for t in tasks:
        eng.submit(t)
    res = eng.drain()
    assert len(res) == 3 and not res.stranded
    first_r1 = order.index(next(o for o in order if o[1] == 1))
    assert {o[0] for o in order[:first_r1]} == {t.task_id for t in tasks}
    rm2 = pool(P, 24, 6)
    clock = P.flow.VirtualClock()
    tm = P.sched.TaskManager(rm2, P.sched.TaskRunner(
        rm2, rts(P), tier_runners={"logical": lambda *a: [],
                                   "device": lambda *a: []}, clock=clock))
    for _ in range(3):
        tm.submit(tk.make())
    drained = tm.drain(strict=True)
    assert clock.now >= 1.5 * eng.makespan
    return {"engine": timeline(eng), "order": order,
            "serial_now": clock.now,
            "serial": [(r.task.task_id, r.state.value) for r in drained]}


def sc_admit_queued(P):
    tk = Tasks(P)
    eng = P.sched.TaskEngine(pool(P, 8, 2), rts(P), elastic=False)
    a, b = tk.make(rounds=2), tk.make(rounds=1)
    eng.submit(a)
    eng.submit(b)
    res = eng.drain()
    assert [ex.task.task_id for ex in res] == [a.task_id, b.task_id]
    assert res[1].started_t == pytest.approx(res[0].finished_t)
    return timeline(eng)


def sc_elastic_scale(P):
    def build(elastic):
        tk = Tasks(P)
        rm = pool(P, 12, 2)
        eng = P.sched.TaskEngine(rm, rts(P), elastic=elastic)
        a = tk.make(rounds=3, priority=1)
        b = tk.make(rounds=2, bundles=8, phones=0)
        eng.submit(a)
        eng.submit(b)
        return rm, eng, a, b

    rm, eng, a, b = build(True)
    eng.clock.schedule(1.0, lambda: rm.scale("High", bundles_delta=4))
    eng.run_until()
    ex_b = eng.executions[b.task_id]
    assert ex_b.started_t == pytest.approx(0.0) and ex_b.reallocations >= 1
    assert ex_b.grant == {"High": (8, 0)}
    _, eng2, a2, b2 = build(False)
    eng2.run_until()
    assert eng.makespan < eng2.makespan
    return {"elastic": timeline(eng), "static": timeline(eng2)}


def sc_pool_shrink(P):
    tk = Tasks(P)
    rm = pool(P, 16, 4)
    eng = P.sched.TaskEngine(rm, rts(P))
    a = tk.make(rounds=2)
    eng.submit(a)
    eng.clock.schedule(1.0, lambda: rm.scale("High", bundles_delta=-8,
                                             phones_delta=-2))
    eng.run_until()
    free = rm.free()
    assert free.logical_bundles["High"] == 8
    return {"tl": timeline(eng), "free": (dict(free.logical_bundles),
                                          dict(free.physical_devices))}


def sc_stranded(P):
    tk = Tasks(P)
    rm = pool(P, 4, 0)
    runner = P.sched.TaskRunner(rm, rts(P), tier_runners={
        "logical": lambda *a: [], "device": lambda *a: []})
    tm = P.sched.TaskManager(rm, runner)
    fits = tk.make(bundles=4, phones=0, rounds=1)
    too_big = tk.make(bundles=40, phones=7, rounds=1)
    tm.submit(fits)
    tm.submit(too_big)
    out = tm.drain()
    with pytest.raises(P.sched.StrandedTasksError, match="nothing-fits") as e:
        tm.drain(strict=True)
    rm2 = pool(P, 4, 0)
    tm2 = P.sched.TaskManager(rm2, P.sched.TaskRunner(
        rm2, rts(P), tier_runners={"logical": lambda *a: [],
                                   "device": lambda *a: []}))
    tm2.submit(tk.make(bundles=4, phones=0, rounds=1))
    out2 = tm2.drain(strict=True)
    assert [t.task_id for t in out.stranded] == [too_big.task_id]
    return {"done": [(r.task.task_id, r.state.value, r.allocation.makespan)
                     for r in out],
            "stranded": [t.task_id for t in out.stranded],
            "reason": out.stranded_reason, "error": str(e.value),
            "clean": ([r.task.task_id for r in out2],
                      [t.task_id for t in out2.stranded],
                      out2.stranded_reason)}


def sc_preempt_pause(P):
    def run(preemptive):
        tk = Tasks(P)
        eng = P.sched.TaskEngine(pool(P, 16, 4), rts(P),
                                 preemptive=preemptive)
        a, b = tk.make(rounds=3), tk.make(rounds=3)
        hi = tk.make(rounds=2, priority=5)
        eng.submit(a)
        eng.submit(b)
        eng.submit(hi, at=1.0)
        res = eng.drain()
        assert len(res) == 3 and not res.stranded
        return eng, b, hi

    eng, b, hi = run(True)
    victim = eng.executions[b.task_id]
    assert victim.preemptions == 1 and victim.rounds_done == 3
    assert eng.executions[hi.task_id].started_t == pytest.approx(10.0)
    eng2, b2, hi2 = run(False)
    assert eng2.executions[hi2.task_id].queueing_delay_s == pytest.approx(
        29.0)
    return {"preemptive": timeline(eng), "plain": timeline(eng2)}


def sc_partial_shrink(P):
    tk = Tasks(P)
    eng = P.sched.TaskEngine(pool(P, 16, 4), rts(P), preemptive=True)
    a, b = tk.make(rounds=3), tk.make(rounds=3)
    hi = tk.make(rounds=1, priority=5, bundles=4, phones=0)
    eng.submit(a)
    eng.submit(b)
    eng.submit(hi, at=1.0)
    eng.drain()
    victim = eng.executions[b.task_id]
    assert victim.preemptions == 1 and victim.grant_utilization < 1.0
    return timeline(eng)


def sc_equal_priority(P):
    tk = Tasks(P)
    eng = P.sched.TaskEngine(pool(P, 8, 2), rts(P), preemptive=True,
                             elastic=False)
    a = tk.make(rounds=2, priority=3)
    late = tk.make(rounds=1, priority=3)
    eng.submit(a)
    eng.submit(late, at=1.0)
    eng.drain()
    assert eng.executions[a.task_id].preemptions == 0
    return timeline(eng)


def sc_scale_reclaim(P):
    tk = Tasks(P)
    rm = pool(P, 16, 4)
    eng = P.sched.TaskEngine(rm, rts(P))
    keep, shed = tk.make(rounds=2, priority=1), tk.make(rounds=2)
    eng.submit(keep)
    eng.submit(shed)
    eng.clock.schedule(1.0, lambda: rm.scale(
        "High", bundles_delta=-8, phones_delta=-2, reclaim=True))
    eng.run_until()
    assert eng.executions[shed.task_id].preemptions >= 1
    assert rm.deficit("High") == (0, 0)
    rm2 = pool(P, 16, 4)
    eng2 = P.sched.TaskEngine(rm2, rts(P))
    eng2.submit(tk.make(rounds=1, bundles=16, phones=4))
    eng2.clock.schedule(1.0, lambda: rm2.scale("High", bundles_delta=-8))
    with pytest.raises(ValueError, match="only") as e:
        eng2.run_until()
    return {"tl": timeline(eng), "free": dict(rm.free().logical_bundles),
            "error": str(e.value)}


def sc_deficit_clamp(P):
    tk = Tasks(P)
    rm = pool(P, 3, 4)
    eng = P.sched.TaskEngine(rm, rts(P))
    a = tk.make(rounds=2, bundles=3, phones=2)
    eng.submit(a)
    eng.clock.schedule(1.0, lambda: rm.scale("High", bundles_delta=-2,
                                             reclaim=True))
    b = tk.make(rounds=1, bundles=4, phones=4)
    eng.submit(b, at=2.0)
    eng.clock.run_until(5.0)
    mid = timeline(eng)
    assert eng.executions[b.task_id].grant == {"High": (0, 2)}
    frac = eng._grant_frac(eng.executions[b.task_id])
    assert frac > 0
    eng.run_until()
    return {"mid": mid, "frac": frac, "end": timeline(eng),
            "deficit": rm.deficit("High")}


def sc_deferred_arrival_checkpoint(P):
    def build():
        return P.sched.TaskEngine(pool(P, 8, 2), rts(P), preemptive=True)

    tk = Tasks(P)
    a, hi = tk.make(rounds=3), tk.make(rounds=1, priority=5)
    eng = build()
    eng.submit(a)
    eng.submit(hi, at=15.0)
    eng.drain()
    tk1 = Tasks(P)
    a1, hi1 = tk1.make(rounds=3), tk1.make(rounds=1, priority=5)
    eng1 = build()
    eng1.submit(a1)
    eng1.submit(hi1, at=15.0)
    assert eng1.clock.run_one() and eng1.clock.now < 15.0
    state = eng1.state_dict()
    assert state["arrivals"]
    eng2 = build()
    eng2.load_state_dict(state, tasks=[a1, hi1])
    eng2.drain()
    assert timeline(eng2)["executions"] == timeline(eng)["executions"]
    return {"ref": timeline(eng), "state": state, "resumed": timeline(eng2)}


def sc_failed_round(P):
    tk = Tasks(P)
    rm = pool(P, 8, 2)

    def boom(task, round_idx, allocation, t):
        raise RuntimeError("injected round failure")

    eng = P.sched.TaskEngine(rm, rts(P), round_runner=boom)
    a = tk.make(rounds=2)
    eng.submit(a)
    with pytest.raises(RuntimeError, match="injected"):
        eng.run_until()
    assert rm.free().logical_bundles["High"] == 8
    return timeline(eng)


def _mid_preemption_calibrator(P):
    cal = P.cal.RuntimeCalibrator()
    probe = P.dm.DeviceFleet(P.dm.GRADES["High"], 32, seed=11)
    for r in range(4):
        cal.observe_fleet(probe.run_round(r))
    return cal


def sc_mid_preemption_checkpoint(P, tmp_path):
    cal = _mid_preemption_calibrator(P)

    def fresh_engine():
        rm = pool(P, 16, 4)
        return rm, P.sched.TaskEngine(
            rm, cal, preemptive=True, duration_rng=np.random.default_rng(77))

    def make_tasks():
        tk = Tasks(P)
        return (tk.make(rounds=3), tk.make(rounds=3),
                tk.make(rounds=2, priority=5, bundles=12, phones=2))

    tasks = make_tasks()
    _, eng = fresh_engine()
    for t, at in zip(tasks, (None, None, 1.0)):
        eng.submit(t, at=at)
    res = eng.drain()
    assert len(res) == 3 and any(ex.preemptions for ex in eng.completed)

    tasks1 = make_tasks()
    rm1, eng1 = fresh_engine()
    for t, at in zip(tasks1, (None, None, 1.0)):
        eng1.submit(t, at=at)
    hi1 = tasks1[2]

    def mid():
        ex_hi = eng1.executions.get(hi1.task_id)
        return (ex_hi is not None and ex_hi.state.value == "running"
                and any(e.state.value == "paused"
                        for e in eng1.executions.values()))

    while not mid():
        assert eng1.clock.run_one()
    state = eng1.state_dict()
    ck = P.ck.Checkpointer(tmp_path)
    ck.save(1, {"sentinel": np.zeros(1)},
            extra={"engine": state, "calibrator": cal.state_dict()})
    cal2 = P.cal.RuntimeCalibrator()
    rm2 = pool(P, 16, 4)
    eng2 = P.sched.TaskEngine(rm2, cal2, preemptive=True,
                              duration_rng=np.random.default_rng(0))
    _, extra = ck.restore({"sentinel": np.zeros(1)})
    cal2.load_state_dict(extra["calibrator"])
    eng2.load_state_dict(extra["engine"], tasks=tasks1)
    assert rm2.frozen(hi1.task_id) == rm1.frozen(hi1.task_id)
    eng2.run_until()
    assert timeline(eng2)["executions"] == timeline(eng)["executions"]
    return {"ref": timeline(eng), "state": state, "resumed": timeline(eng2)}


# --------------------------------------------------------------------------- #
# test_serving.py:197-270, test_federation.py:118, test_calibration.py:99
# --------------------------------------------------------------------------- #
def sc_cost_model_admits(P):
    tk = Tasks(P)
    eng = P.sched.TaskEngine(pool(P, 8, 2), rts(P), preemptive=True,
                             preemption_cost_model=True)
    victim, hi = tk.make(rounds=5), tk.make(rounds=1, priority=5)
    eng.submit(victim)
    eng.submit(hi, at=1.0)
    eng.drain()
    d = eng.executions[victim.task_id].preemption_decisions[0]
    assert d["preempted"] is True and d["benefit_s"] > d["cost_s"] > 0
    return timeline(eng)


def sc_cost_model_vetoes(P):
    def run(gated):
        tk = Tasks(P)
        eng = P.sched.TaskEngine(pool(P, 8, 2), rts(P), preemptive=True,
                                 preemption_cost_model=gated)
        victim, hog = tk.make(rounds=2), tk.make(rounds=50, priority=1)
        eng.submit(victim)
        eng.submit(hog, at=1.0)
        eng.drain()
        return eng, victim

    eng, victim = run(True)
    assert eng.executions[victim.task_id].preemptions == 0
    eng2, victim2 = run(False)
    assert eng2.executions[victim2.task_id].preemptions == 1
    return {"gated": timeline(eng), "ungated": timeline(eng2)}


def sc_decisions_state_roundtrip(P):
    tk = Tasks(P)
    eng = P.sched.TaskEngine(pool(P, 8, 2), rts(P), preemptive=True,
                             preemption_cost_model=True)
    victim, hi = tk.make(rounds=5), tk.make(rounds=1, priority=5)
    eng.submit(victim)
    eng.submit(hi, at=1.0)
    eng.drain()
    state = eng.state_dict()
    eng2 = P.sched.TaskEngine(pool(P, 8, 2), rts(P), preemptive=True,
                              preemption_cost_model=True)
    eng2.load_state_dict(state, [victim, hi])
    decisions = eng2.executions[victim.task_id].preemption_decisions
    assert decisions == eng.executions[victim.task_id].preemption_decisions
    return {"state": state, "restored": timeline(eng2)}


def sc_co_serving(P):
    eng = P.serve.co_serving_schedule(peak_t=30.0)
    train = next(ex for ex in eng.completed if ex.task.priority == 0)
    assert train.preemptions >= 1 and train.preemption_decisions
    # The schedule makes its own tasks: pair them by submission order.
    execs = sorted(eng.executions.values(), key=lambda ex: ex.task.task_id)
    tl = timeline(eng)
    base = execs[0].task.task_id
    return {"executions": [tl["executions"][ex.task.task_id]
                           for ex in execs],
            "preemptors": [[d["preemptor"] - base
                            for d in ex.preemption_decisions]
                           for ex in execs],
            "makespan": tl["makespan"]}


def sc_priority_admission(P):
    rm = P.sched.ResourceManager(
        P.sched.ResourcePool({"High": 100}, {"High": 10}))
    runner = P.sched.TaskRunner(
        rm, runtimes=lambda t: [P.alloc.GradeRuntime(1.0, 1.0, 0.1)
                                ] * len(t.grades),
        tier_runners={"logical": lambda *a: [], "device": lambda *a: []})
    tm = P.sched.TaskManager(rm, runner)
    flow = P.task.OperatorFlow(("train",))
    big = P.task.Task(flow, (P.task.GradeSpec(
        "High", 10, logical_bundles=80, physical_devices=8),), priority=1,
        task_id=1)
    small = P.task.Task(flow, (P.task.GradeSpec(
        "High", 5, logical_bundles=30, physical_devices=3),), priority=5,
        task_id=2)
    tm.submit(big)
    tm.submit(small)
    done = tm.drain()
    assert [d.task.priority for d in done] == [5, 1]
    return {"done": [(d.task.task_id, d.state.value,
                      d.allocation.makespan) for d in done],
            "free": dict(rm.free().logical_bundles)}


def sc_runner_calibrator(P):
    cal = P.cal.RuntimeCalibrator()
    cal.observe_fleet(P.dm.DeviceFleet(P.dm.GRADES["High"], 64,
                                       seed=2).run_round(0))
    rm = P.sched.ResourceManager(
        P.sched.ResourcePool({"High": 100}, {"High": 10}))
    seen = []
    runner = P.sched.TaskRunner(
        rm, runtimes=cal,
        tier_runners={"logical": lambda *a: seen.append(("l", a[2])) or [],
                      "device": lambda *a: seen.append(("d", a[2])) or []})
    task = P.task.Task(P.task.OperatorFlow(("train",)),
                       (P.task.GradeSpec("High", 8, logical_bundles=40,
                                         physical_devices=4),), task_id=7)
    rm.freeze(task.task_id, task.demand())
    rec = runner.run(task)
    assert sum(n for _, n in seen) == 8
    return {"state": rec.state.value, "seen": seen,
            "makespan": rec.allocation.makespan}


VIRTUAL = {
    "interleave": sc_interleave,
    "admit_queued": sc_admit_queued,
    "elastic_scale": sc_elastic_scale,
    "pool_shrink": sc_pool_shrink,
    "stranded": sc_stranded,
    "preempt_pause": sc_preempt_pause,
    "partial_shrink": sc_partial_shrink,
    "equal_priority": sc_equal_priority,
    "scale_reclaim": sc_scale_reclaim,
    "deficit_clamp": sc_deficit_clamp,
    "deferred_arrival_checkpoint": sc_deferred_arrival_checkpoint,
    "failed_round": sc_failed_round,
    "cost_model_admits": sc_cost_model_admits,
    "cost_model_vetoes": sc_cost_model_vetoes,
    "decisions_state_roundtrip": sc_decisions_state_roundtrip,
    "co_serving": sc_co_serving,
    "priority_admission": sc_priority_admission,
    "runner_calibrator": sc_runner_calibrator,
}


@pytest.mark.parametrize("name", sorted(VIRTUAL))
def test_scenario_matches_reference_exactly(name):
    """Each scenario's reference assertions hold in both packages, and the
    timelines, grants, decisions, drain results and states are equal."""
    assert VIRTUAL[name](PORT) == VIRTUAL[name](REF)


def test_mid_preemption_checkpoint_matches_reference(tmp_path):
    got = sc_mid_preemption_checkpoint(PORT, tmp_path / "port")
    want = sc_mid_preemption_checkpoint(REF, tmp_path / "ref")
    assert got == want


# --------------------------------------------------------------------------- #
# Engine states cross between the packages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("src,dst", [(REF, PORT), (PORT, REF)])
def test_engine_state_crosses_packages(src, dst):
    """A mid-preemption state written by one package's engine (through
    JSON, as a checkpoint's ``extra`` holds it) loads into the other's and
    resumes to the uninterrupted timeline."""
    cal_src = _mid_preemption_calibrator(src)
    tk = Tasks(src)
    tasks_src = (tk.make(rounds=3), tk.make(rounds=3),
                 tk.make(rounds=2, priority=5, bundles=12, phones=2))
    eng1 = src.sched.TaskEngine(pool(src, 16, 4), cal_src, preemptive=True,
                                duration_rng=np.random.default_rng(77))
    for t, at in zip(tasks_src, (None, None, 1.0)):
        eng1.submit(t, at=at)
    while not any(e.state.value == "paused"
                  for e in eng1.executions.values()):
        assert eng1.clock.run_one()
    state = json.loads(json.dumps(eng1.state_dict()))
    cal_state = json.loads(json.dumps(cal_src.state_dict()))
    eng1.run_until()
    want = timeline(eng1)

    cal_dst = dst.cal.RuntimeCalibrator()
    cal_dst.load_state_dict(cal_state)
    tk = Tasks(dst)
    tasks_dst = (tk.make(rounds=3), tk.make(rounds=3),
                 tk.make(rounds=2, priority=5, bundles=12, phones=2))
    eng2 = dst.sched.TaskEngine(pool(dst, 16, 4), cal_dst, preemptive=True,
                                duration_rng=np.random.default_rng(0))
    eng2.load_state_dict(state, tasks=tasks_dst)
    assert json.loads(json.dumps(eng2.state_dict())) == state
    eng2.run_until()
    assert timeline(eng2) == want


# --------------------------------------------------------------------------- #
# test_resource_manager.py: the same op sequences through both managers
# --------------------------------------------------------------------------- #
GRADE_NAMES = ("High", "Mid", "Low")
_OP = st.tuples(
    st.sampled_from(("freeze", "release", "refreeze", "scale", "reclaim")),
    st.integers(0, 4), st.sampled_from(GRADE_NAMES), st.integers(0, 6),
    st.integers(0, 3), st.integers(0, 1))


def _apply_ops(P, ops):
    rm = P.sched.ResourceManager(P.sched.ResourcePool(
        {g: 8 for g in GRADE_NAMES}, {g: 4 for g in GRADE_NAMES}))
    fired = []
    rm.subscribe(lambda: fired.append(len(fired)))
    trace = []
    for kind, tid, grade, b, p, sign in ops:
        err = None
        try:
            if kind == "freeze":
                rm.freeze(tid, {grade: (b, p)})
            elif kind == "release":
                rm.release(tid)
            elif kind == "refreeze":
                rm.refreeze(tid, {grade: (b, p)})
            elif kind == "scale":
                rm.scale(grade, bundles_delta=-b if sign else b,
                         phones_delta=-p if sign else p)
            else:
                rm.scale(grade, bundles_delta=-b, phones_delta=-p,
                         reclaim=True)
        except (ValueError, KeyError) as e:
            err = (type(e).__name__, str(e))
        free, total = rm.free(), rm.total()
        trace.append((err, dict(free.logical_bundles),
                      dict(free.physical_devices),
                      dict(total.logical_bundles),
                      dict(total.physical_devices),
                      {g: rm.deficit(g) for g in GRADE_NAMES},
                      {t: rm.frozen(t) for t in range(5)}, len(fired)))
    return trace


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_OP, min_size=1, max_size=40))
def test_resource_manager_op_sequences_match_reference(ops):
    assert _apply_ops(PORT, ops) == _apply_ops(REF, ops)


@pytest.mark.parametrize("ops", [
    # test_rejected_shrink_leaves_both_pools_consistent
    [("freeze", 0, "High", 0, 4, 0), ("scale", 0, "High", 2, 1, 1)],
    # test_refreeze_failure_does_not_release_the_old_grant
    [("freeze", 0, "High", 8, 2, 0), ("refreeze", 0, "High", 8, 5, 0)],
    # test_reclaim_shrink_tracks_deficit_until_paid_down
    [("freeze", 0, "High", 8, 4, 0), ("reclaim", 0, "High", 4, 0, 0),
     ("refreeze", 0, "High", 4, 4, 0), ("reclaim", 0, "High", 0, 5, 0)],
    # test_zero_delta_scale_fires_no_listeners
    [("scale", 0, "High", 0, 0, 0), ("scale", 0, "High", 1, 0, 0)],
])
def test_resource_manager_regressions_match_reference(ops):
    assert _apply_ops(PORT, ops) == _apply_ops(REF, ops)


# --------------------------------------------------------------------------- #
# calibration.monte_carlo_schedules
# --------------------------------------------------------------------------- #
def _mc(P, preemptive_modes=(False, True)):
    cal = P.cal.RuntimeCalibrator()
    for g in ("High", "Low"):
        probe = P.dm.DeviceFleet(P.dm.GRADES[g], 64, seed=7)
        for r in range(3):
            cal.observe_fleet(probe.run_round(r))
    tk = Tasks(P)
    mk = lambda prio: tk.make(rounds=3, priority=prio, bundles=8, phones=3,
                              n=24)
    low = [mk(0), mk(0)]
    urgent = mk(9)
    mc = P.cal.monte_carlo_schedules(
        low + [urgent], P.sched.ResourcePool({"High": 16}, {"High": 6}), cal,
        arrivals={urgent.task_id: 60.0}, n_samples=12, seed=3,
        modes=preemptive_modes)
    return {mode: (est.makespan_s.tolist(),
                   {k: v.tolist() for k, v in est.queueing_delay_s.items()},
                   {k: v.tolist() for k, v in est.grant_utilization.items()},
                   est.mean_makespan_s, est.p95_makespan_s)
            for mode, est in mc.items()}


def test_monte_carlo_schedules_match_reference():
    got, want = _mc(PORT), _mc(REF)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                          sort_keys=True)
    assert isinstance(PORT.cal.monte_carlo_schedules(
        [], PORT.sched.ResourcePool({"High": 1}, {"High": 1}),
        PORT.cal.RuntimeCalibrator(), n_samples=1)[True],
        t_cal.ScheduleEstimate)
    with pytest.raises(ValueError, match="n_samples"):
        PORT.cal.monte_carlo_schedules(
            [], PORT.sched.ResourcePool({"High": 1}, {"High": 1}),
            PORT.cal.RuntimeCalibrator(), n_samples=0)


# --------------------------------------------------------------------------- #
# test_checkpoint_runtime.py:55-252 — fault tolerance and the runtime
# snapshot
# --------------------------------------------------------------------------- #
def _state_tree(P, x=0.0):
    if P is REF:
        return {"params": {"w": jnp.full((4, 4), x), "b": jnp.zeros(3)},
                "step": jnp.asarray(int(x), jnp.int32)}
    return {"params": {"w": torch.full((4, 4), x), "b": torch.zeros(3)},
            "step": torch.tensor(int(x), dtype=torch.int32)}


@pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
def test_supervisor_restarts_from_checkpoint(P, tmp_path):
    ck = P.ck.Checkpointer(tmp_path)
    crashed = {"done": False}
    steps = []

    def step_fn(state, step):
        steps.append(step)
        if step == 5 and not crashed["done"]:
            crashed["done"] = True
            if P is REF:
                # The reference restores without waiting for the save in
                # flight (it reads latest_step(), then restores the newest
                # step); fail only once the step-4 save has landed, so both
                # read step 4.
                ck.wait()
            raise RuntimeError("injected node failure")
        return {"params": state["params"], "step": state["step"] + 1}

    sup = P.ft.TrainingSupervisor(ck, checkpoint_every=2,
                                  policy=P.ft.RetryPolicy(backoff_s=0.01))
    state, step = sup.run(_state_tree(P, 0.0), step_fn, 8,
                          state_like=_state_tree(P))
    assert step == 8 and int(state["step"]) == 8 and crashed["done"]
    # The failed step ran again from the last checkpoint, step 4.
    assert steps == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert ck.latest_step() == 8


def test_fault_tolerance_helpers_match_reference():
    for P in (REF, PORT):
        calls = {"n": 0}

        def bad():
            calls["n"] += 1
            raise RuntimeError("nope")

        f = P.ft.with_retries(bad, P.ft.RetryPolicy(max_attempts=3,
                                                    backoff_s=0.0))
        with pytest.raises(RuntimeError):
            f()
        assert calls["n"] == 3
    for target, over, deadline in ((100, 0.3, 60.0), (7, 0.5, 1.0)):
        a = PORT.ft.StragglerPolicy(target=target, over_select=over,
                                    deadline_s=deadline)
        b = REF.ft.StragglerPolicy(target=target, over_select=over,
                                   deadline_s=deadline)
        assert a.num_selected == b.num_selected
        for arrived, elapsed in ((99, 10), (100, 10), (10, 61), (0, 0.5)):
            assert (a.round_complete(arrived, elapsed)
                    == b.round_complete(arrived, elapsed))
    assert dataclass_fields(PORT.ft.WorkerFailure) == dataclass_fields(
        REF.ft.WorkerFailure)


def dataclass_fields(cls):
    import dataclasses

    return [f.name for f in dataclasses.fields(cls)]


def _elastic(P):
    rm = P.sched.ResourceManager(
        P.sched.ResourcePool({"High": 200}, {"High": 17}))
    ec = P.ft.ElasticController(rm)
    specs = [P.task.GradeSpec("High", 100, logical_bundles=200,
                              bundles_per_device=8, physical_devices=17)]
    rt = [P.alloc.GradeRuntime(alpha=16.0, beta=21.6, lam=15.0)]
    before = ec.scale_up("High", bundles=0, task_specs=specs, runtimes=rt)
    after = ec.node_failure("High", phones=12, task_specs=specs, runtimes=rt)
    assert after.per_grade[0].physical_devices <= \
        before.per_grade[0].physical_devices
    return ([(g.logical_devices, g.physical_devices)
             for r in (before, after) for g in r.per_grade],
            before.makespan, after.makespan,
            [{k: v for k, v in e.items() if k != "t"} for e in ec.events])


def test_elastic_rescale_matches_reference():
    assert _elastic(PORT) == _elastic(REF)


def _dispatcher_state(P):
    strategy = P.strat.AccumulatedStrategy(thresholds=(2, 5))

    def mk(sink):
        flow = P.flow.DeviceFlow(sink, seed=0)
        flow.register_task(0, strategy)
        return flow

    got = []
    flow = mk(got.append)
    for i in range(2):
        flow.submit(P.flow.Message(0, i, 0, payload=i), t=1.0)
    state = flow.state_dict()
    restored_got = []
    restored = mk(restored_got.append)
    restored.load_state_dict(state)
    for i in range(4):
        restored.submit(P.flow.Message(0, 10 + i, 0, payload=i), t=2.0)
    assert restored_got == []
    restored.submit(P.flow.Message(0, 99, 0, payload="x"), t=3.0)
    legacy_got = []
    legacy = mk(legacy_got.append)
    legacy.load_state_dict({0: {"task_id": 0, "buf": [
        P.flow.Message(0, 0, 0, payload=0)], "received": 1,
        "dispatched": 0, "dropped": 0}})
    return ([(d.t, d.message.device_id) for d in restored_got],
            restored.conservation_ok(0), len(legacy.shelf(0)),
            legacy.conservation_ok(0))


def test_deviceflow_dispatcher_state_survives_checkpoint():
    got, want = _dispatcher_state(PORT), _dispatcher_state(REF)
    assert got == want and len(got[0]) == 5


def _mini_buffer(P, n, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    leaf = (rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    if P is REF:
        return P.upd.UpdateBuffer([jnp.asarray(leaf)],
                                  jax.tree.structure({"w": 0}), [(dim,)],
                                  [np.dtype(np.float32)])
    return P.upd.UpdateBuffer([torch.from_numpy(leaf)], ("w",), [(dim,)],
                              [np.dtype(np.float32)])


def _unified_snapshot(P, tmp_path):
    def build(sink, tk):
        flow = P.flow.DeviceFlow(sink)
        flow.register_task(0, P.strat.AccumulatedStrategy(thresholds=(5,)))
        eng = P.sched.TaskEngine(pool(P, 8, 2), rts(P), preemptive=True,
                                 clock=flow.clock)
        return eng, flow, (tk.make(rounds=3), tk.make(rounds=1, priority=5))

    def flat(got):
        out = []
        for d in got:
            if d.batch is not None:
                out += [(d.t, int(i)) for i in d.batch.device_ids]
            else:
                out.append((d.t, int(d.message.device_id)))
        return out

    buf = _mini_buffer(P, 3, seed=2)

    def first_half(eng, flow, tasks):
        a, hi = tasks
        eng.submit(a)
        eng.submit(hi, at=15.0)
        flow.submit_batch(P.flow.ArrivalBatch.from_buffer(0, 0, buf),
                          ts=[1.0, 2.0, 3.0])

    def second_half(eng, flow):
        flow.submit_batch(P.flow.ArrivalBatch.from_buffer(
            0, 0, _mini_buffer(P, 2, seed=3), device_ids=np.arange(3, 5)),
            ts=[20.0, 21.0])
        eng.drain()

    got_r = []
    eng_r, flow_r, tasks_r = build(got_r.append, Tasks(P))
    first_half(eng_r, flow_r, tasks_r)
    second_half(eng_r, flow_r)

    got_1 = []
    eng_1, flow_1, tasks_1 = build(got_1.append, Tasks(P))
    first_half(eng_1, flow_1, tasks_1)
    assert eng_1.clock.run_one()
    snapshot = eng_1.state_dict(deviceflow=flow_1)
    engine_only = {k: v for k, v in snapshot.items() if k != "deviceflow"}
    ck = P.ck.Checkpointer(tmp_path)
    ck.save(3, _state_tree(P, 1.0), runtime_state=snapshot)
    restored = ck.restore_runtime_state()
    got_2 = []
    eng_2, flow_2, _ = build(got_2.append, Tasks(P, start=5000))
    eng_2.load_state_dict(restored, tasks=list(tasks_1), deviceflow=flow_2)
    assert len(flow_2.shelf(0)) == 3
    second_half(eng_2, flow_2)
    assert timeline(eng_2)["executions"] == timeline(eng_r)["executions"]
    assert flat(got_2) == flat(got_r) and flow_2.conservation_ok(0)
    d2 = next(d for d in got_2 if d.batch is not None)
    np.testing.assert_array_equal(
        np.asarray(d2.batch.buffer.materialize()["w"]),
        np.asarray(buf.materialize()["w"]))
    assert P.ck.Checkpointer(tmp_path / "none").latest_step() is None
    ck2 = P.ck.Checkpointer(tmp_path / "plain")
    ck2.save(1, _state_tree(P, 1.0))
    assert ck2.restore_runtime_state() is None
    with pytest.raises(FileNotFoundError):
        P.ck.Checkpointer(tmp_path / "empty").restore_runtime_state()
    return {"engine": engine_only, "timeline": timeline(eng_2),
            "deliveries": flat(got_2)}


def test_unified_runtime_snapshot_matches_reference(tmp_path):
    """An engine snapshot with in-flight columnar batches, saved through
    ``Checkpointer.save(runtime_state=...)``, restores to the identical
    delivery timeline in both packages."""
    assert (_unified_snapshot(PORT, tmp_path / "port")
            == _unified_snapshot(REF, tmp_path / "ref"))


def _one_manifest(P, tmp_path):
    fleet = P.dm.DeviceFleet(P.dm.GRADES["High"], 6, seed=11)
    fleet.run_round(0)
    params = ({"w": jnp.zeros(16)} if P is REF else {"w": torch.zeros(16)})
    svc = P.fed.AggregationService(
        params, trigger=P.fed.SampleThresholdTrigger(10**9), streaming=True)
    flow = P.flow.DeviceFlow(svc)
    flow.register_task(0, P.strat.AccumulatedStrategy(thresholds=(1,)))
    eng = P.sched.TaskEngine(pool(P, 8, 2), lambda t: [])
    state = eng.state_dict(deviceflow=flow, fleets={"High": fleet},
                           services={0: svc})
    assert set(state["fleets"]) == {"High"}
    assert set(state["aggregation"]) == {0}
    ck = P.ck.Checkpointer(tmp_path)
    ck.save(3, params, runtime_state=state)
    ref_next = fleet.run_round(1)
    restored = ck.restore_runtime_state()
    assert sorted(restored) == sorted(state)
    manifest = json.loads(
        (tmp_path / "step_0000000003" / "manifest.json").read_text())
    fleet2 = P.dm.DeviceFleet(P.dm.GRADES["High"], 6, seed=11)
    svc2 = P.fed.AggregationService(
        params, trigger=P.fed.SampleThresholdTrigger(10**9), streaming=True)
    flow2 = P.flow.DeviceFlow(svc2)
    flow2.register_task(0, P.strat.AccumulatedStrategy(thresholds=(1,)))
    eng2 = P.sched.TaskEngine(pool(P, 8, 2), lambda t: [])
    eng2.load_state_dict(restored, tasks=[], deviceflow=flow2,
                         fleets={"High": fleet2}, services={0: svc2})
    replay = fleet2.run_round(1)
    np.testing.assert_array_equal(replay.stage_duration_min,
                                  ref_next.stage_duration_min)
    legacy = {k: v for k, v in restored.items()
              if k not in ("fleets", "aggregation")}
    eng2.load_state_dict(legacy, tasks=[], deviceflow=flow2,
                         fleets={"High": fleet2}, services={0: svc2})
    return {"sections": manifest["runtime_sections"],
            "fleets": state["fleets"],
            "engine": {k: v for k, v in state.items()
                       if k not in ("deviceflow", "aggregation")},
            "replay": replay.stage_duration_min.tolist()}


def test_one_manifest_runtime_checkpoint_matches_reference(tmp_path):
    """Fleet RNG counters and streaming-aggregation state ride the same
    ``runtime_state`` manifest as the engine and DeviceFlow snapshot."""
    got = _one_manifest(PORT, tmp_path / "port")
    want = _one_manifest(REF, tmp_path / "ref")
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(
        want, sort_keys=True, default=str)


# --------------------------------------------------------------------------- #
# test_scheduler_events.py:383 — real rounds under the engine, snapshotted
# mid-task and resumed (CPU)
# --------------------------------------------------------------------------- #
N_RT, DIM_RT, RPD_RT = 8, 16, 4


def _rt_world(P, tk):
    n, dim, rpd = N_RT, DIM_RT, RPD_RT
    if P is REF:
        local = P.ctr.make_local_train_fn(lr=1e-2, epochs=2)
        params = jax.tree.map(jnp.array, P.ctr.lr_init(
            jax.random.PRNGKey(0), dim))
        kw = {}
    else:
        local = P.ctr.make_local_train_fn(lr=1e-2, epochs=2)
        params = P.ctr.lr_init(dim, device="cpu")
        kw = {"device": "cpu"}
    svc = P.fed.AggregationService(
        params, trigger=P.fed.ClientCountTrigger(2 * n), streaming=True)
    flow = P.flow.DeviceFlow(svc)
    flow.register_task(0, P.strat.AccumulatedStrategy(thresholds=(1,)))
    sim = P.sim.HybridSimulation(
        P.sim.LogicalTier(local, cohort_size=max(2, n // 2), **kw),
        tiers={"High": P.sim.DeviceTier(local, P.dm.GRADES["High"],
                                        cohort_size=max(2, n // 2), **kw)},
        deviceflow=flow, stream_chunks=True)
    cal = P.cal.RuntimeCalibrator()

    def round_runner(t, round_idx, allocation, now):
        rng = np.random.default_rng(5_000 + round_idx)
        x = rng.standard_normal((n, rpd, dim)).astype(np.float32)
        y = (rng.random((n, rpd)) < 0.3).astype(np.float32)
        m = np.ones((n, rpd), np.float32)
        if P is REF:
            batches = {"x": jnp.asarray(x), "y": jnp.asarray(y),
                       "mask": jnp.asarray(m)}
            key = jax.random.PRNGKey(round_idx)
        else:
            batches = {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                       "mask": torch.from_numpy(m)}
            key = torch.Generator().manual_seed(round_idx)
        plan = P.sim.RoundPlan.from_allocation(allocation, t.grades)
        out = sim.run_plan_round(0, round_idx, svc.global_params, plan,
                                 {"High": batches}, {"High": np.full(n, rpd)},
                                 key, calibrator=cal)
        return out.makespan_s

    rm = pool(P, 4, 2)
    eng = P.sched.TaskEngine(rm, cal, round_runner=round_runner,
                             clock=flow.clock)
    task = tk.make(rounds=2, bundles=4, phones=2, n=n)
    blocked = tk.make(rounds=1, bundles=4, phones=2, n=n)
    return sim, svc, rm, eng, cal, task, blocked


def _params_np(P, params):
    if P is REF:
        return {k: np.asarray(v) for k, v in jax.device_get(params).items()}
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _mid_task(P, tmp_path):
    sim, svc, rm, eng, cal, task, blocked = _rt_world(P, Tasks(P))
    eng.submit(task)
    eng.submit(blocked)
    eng.run_until()
    ref_params = _params_np(P, svc.global_params)
    ref_tl = timeline(eng)
    assert len(eng.completed) == 2

    sim1, svc1, rm1, eng1, cal1, task1, blocked1 = _rt_world(P, Tasks(P))
    eng1.submit(task1)
    eng1.submit(blocked1)
    while eng1.executions.get(task1.task_id) is None or \
            eng1.executions[task1.task_id].rounds_done < 1:
        assert eng1.clock.run_one()
    assert svc1._partials or svc1._chunks
    assert len(eng1.queue) == 1
    state = eng1.state_dict(deviceflow=sim1.deviceflow, fleets=sim1.fleets,
                            services={0: svc1})
    ck = P.ck.Checkpointer(tmp_path)
    ck.save(1, {"params": svc1.global_params}, runtime_state=state,
            extra={"calibrator": cal1.state_dict()})

    sim2, svc2, rm2, eng2, cal2, _, _ = _rt_world(P, Tasks(P, start=5000))
    like = {"params": svc2.global_params}
    tree, extra = ck.restore(like)
    if P is REF:
        svc2.global_params = jax.tree.map(jnp.asarray, tree["params"])
    else:
        svc2.global_params = tree["params"]
    cal2.load_state_dict(extra["calibrator"])
    eng2.load_state_dict(ck.restore_runtime_state(),
                         tasks=[task1, blocked1],
                         deviceflow=sim2.deviceflow, fleets=sim2.fleets,
                         services={0: svc2})
    assert rm2.frozen(task1.task_id) == {"High": (4, 2)}
    eng2.run_until()
    got = _params_np(P, svc2.global_params)
    for k in ref_params:
        np.testing.assert_allclose(got[k], ref_params[k], atol=1e-6)
    assert timeline(eng2) == ref_tl
    engine_state = {k: v for k, v in state.items()
                    if k not in ("deviceflow", "aggregation")}
    return ref_tl, engine_state, ref_params


def test_engine_checkpoint_roundtrip_mid_task_matches_reference(tmp_path):
    """Real federated rounds (streaming aggregation) under the engine,
    snapshotted after round 0 through the one-manifest runtime checkpoint:
    each package resumes to its own uninterrupted run (params 1e-6, the
    timeline exactly), and the two packages' timelines and engine states
    are equal.  The port's final params hold the reference's within the
    round-update tolerance of bf16 device rows (2e-2 relative)."""
    tl_p, st_p, params_p = _mid_task(PORT, tmp_path / "port")
    tl_r, st_r, params_r = _mid_task(REF, tmp_path / "ref")
    assert tl_p == tl_r
    assert plain(st_p) == plain(st_r)
    flat = lambda p: np.concatenate([np.ravel(p[k]) for k in sorted(p)])
    a, b = flat(params_p), flat(params_r)
    assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b)
    assert math.isfinite(float(np.linalg.norm(a)))
