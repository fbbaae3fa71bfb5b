"""The slice as a whole: quickstart sections 1-5 (and the int8 wire of
section 9) through both packages on the same numpy inputs.  Params after
every round, aggregation counts, arrival times, dispatch membership and
shelf bytes are compared."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro.core.simulation as j_sim  # noqa: E402
from repro.core.devicemodel import GRADES as J_GRADES  # noqa: E402
from repro.core.devicemodel import DeviceFleet as JFleet  # noqa: E402
from repro.models import ctr as jctr  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.simulation as t_sim  # noqa: E402
from repro_torch.core.devicemodel import GRADES as T_GRADES  # noqa: E402
from repro_torch.core.devicemodel import DeviceFleet as TFleet  # noqa: E402
from repro_torch.data.synthetic_ctr import make_federated_ctr  # noqa: E402
from repro_torch.models import ctr as tctr  # noqa: E402

N_HIGH, N_LOW, RECORDS, DIM, ROUNDS = 16, 8, 16, 64, 3


def _specs(M, bench, physical=True):
    return [
        M.GradeSpec("High", N_HIGH, benchmarking_devices=bench,
                    logical_bundles=8, bundles_per_device=4,
                    physical_devices=8 if physical else 0),
        M.GradeSpec("Low", N_LOW, benchmarking_devices=bench,
                    logical_bundles=16, bundles_per_device=2,
                    physical_devices=2 if physical else 0),
    ]


def _slice(pkg, *, wire="f32", bench=1, physical=True, streaming=False,
           columnar=True, zero_copy=True, server_lr=1.0):
    M, G, Fleet, sim_mod = ((J, J_GRADES, JFleet, j_sim) if pkg == "jax"
                            else (T, T_GRADES, TFleet, t_sim))
    specs = _specs(M, bench, physical)
    cal = M.RuntimeCalibrator()
    for g in ("High", "Low"):
        probe = Fleet(G[g], 64, seed=7)
        for r in range(3):
            cal.observe_fleet(probe.run_round(r))
    plan = M.RoundPlan.from_allocation(
        M.solve_allocation(specs, cal.runtimes_for(specs)), specs)
    batches, counts = {}, {}
    for i, spec in enumerate(specs):
        data = make_federated_ctr(num_devices=spec.num_devices,
                                  records_per_device=RECORDS, dim=DIM, seed=i)
        X, Y, c = data.stacked_shards(np.arange(spec.num_devices), RECORDS)
        mask = (np.arange(RECORDS)[None] < c[:, None]).astype(np.float32)
        batches[spec.grade] = {"x": X, "y": Y, "mask": mask}
        counts[spec.grade] = c
    if pkg == "jax":
        local = jctr.make_local_train_fn(lr=1e-3, epochs=10)
        params = jctr.lr_init(jax.random.PRNGKey(0), DIM)
        batches = {g: {k: jnp.asarray(v) for k, v in b.items()}
                   for g, b in batches.items()}
        dev = {}
    else:
        local = tctr.make_local_train_fn(lr=1e-3, epochs=10)
        params = tctr.lr_init(DIM, device="cpu")
        dev = {"device": "cpu"}
    svc = M.AggregationService(
        params, trigger=M.SampleThresholdTrigger(
            (N_HIGH + N_LOW) * RECORDS // 2), streaming=streaming,
        server_lr=server_lr)
    deliveries = []

    def sink(d):
        ids = (d.batch.device_ids.tolist() if d.batch is not None
               else [d.message.device_id])
        deliveries.append((d.t, ids))
        svc(d)

    flow = M.DeviceFlow(sink)
    flow.register_task(0, M.AccumulatedStrategy(thresholds=(1,)))
    sim = sim_mod.HybridSimulation(
        sim_mod.LogicalTier(local, cohort_size=16, **dev),
        tiers={g: sim_mod.DeviceTier(local, G[g], **dev)
               for g in ("High", "Low")},
        deviceflow=flow, wire=wire, error_feedback=True,
        stream_chunks=streaming, columnar=columnar, zero_copy=zero_copy)
    out = []
    for rnd in range(ROUNDS):
        rng = (jax.random.PRNGKey(rnd) if pkg == "jax"
               else torch.Generator().manual_seed(rnd))
        oc = sim.run_plan_round(
            task_id=0, round_idx=rnd, global_params=svc.global_params,
            plan=plan, grade_batches=batches, grade_num_samples=counts,
            rng=rng, calibrator=cal)
        if wire == "int8":
            flow.run(1e12)
            svc.tick(flow.clock.now)
        shelf = flow.shelf(0)
        out.append({
            "params": {k: np.asarray(v, np.float32)
                       for k, v in svc.global_params.items()},
            "aggregations": len(svc.history),
            "arrivals": np.asarray(oc.arrival_times),
            "bytes": (shelf.total_bytes_received,
                      shelf.total_bytes_dispatched, shelf.total_dispatched),
            "reports": [(r.device_id, r.total_duration_min)
                        for r in oc.reports],
            "makespans": {g: b.makespan_s for g, b in oc.per_grade.items()},
            "messages": len(oc.messages),
        })
    return plan, out, deliveries, [(e.num_clients, e.num_samples)
                                   for e in svc.history]


def _flat(params):
    return np.concatenate([params[k].reshape(-1) for k in sorted(params)])


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _compare(a, b, tol):
    """Host-side state exact; the model held per round on its update:
    ``||d_port - d_ref|| / ||d_ref|| <= tol`` with ``d`` each package's own
    change of the global params over the round, and the params themselves
    to the same relative tolerance.  The params are about 1e-4 in size, so
    an absolute tolerance would not see a missing or mis-weighted update."""
    (pa, ra, da, ha), (pb, rb, db, hb) = a, b
    assert [(e.grade, e.num_logical, e.num_physical, e.num_benchmarking)
            for e in pa.entries] == [
        (e.grade, e.num_logical, e.num_physical, e.num_benchmarking)
        for e in pb.entries]
    assert ha == hb
    assert da == db  # dispatch membership and delivery times
    prev_a = prev_b = np.zeros_like(_flat(ra[0]["params"]))
    for x, y in zip(ra, rb):
        assert x["aggregations"] == y["aggregations"]
        np.testing.assert_array_equal(x["arrivals"], y["arrivals"])
        assert x["bytes"] == y["bytes"]
        assert x["reports"] == y["reports"]
        assert x["makespans"] == y["makespans"]
        assert x["messages"] == y["messages"]
        pa_, pb_ = _flat(x["params"]), _flat(y["params"])
        assert np.all(np.isfinite(pb_))
        err = max(_rel(pb_ - prev_b, pa_ - prev_a), _rel(pb_, pa_))
        assert err <= tol, f"update off by {err:.3e} (tol {tol:.0e})"
        prev_a, prev_b = pa_, pb_


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_quickstart_slice_matches_reference(wire):
    """Device-tier rows (bf16) enter the aggregation: 2e-2."""
    a = _slice("jax", wire=wire)
    b = _slice("torch", wire=wire)
    assert any(e.num_physical for e in a[0].entries)
    _compare(a, b, 2e-2)


@pytest.mark.parametrize("fault", ["no_update", "half_update",
                                   "host_weights_halved"])
def test_compare_catches_a_planted_fault(fault, monkeypatch):
    """The comparison fails a port that skips the update, applies half of
    it, or halves the benchmarking devices' host term."""
    import repro_torch.core.federation as t_fed

    if fault == "host_weights_halved":
        host_sum = t_fed._host_sum
        monkeypatch.setattr(t_fed, "_host_sum", lambda g, u, w: host_sum(
            g, u, [x * 0.5 for x in w]))
    lr = {"no_update": 0.0, "half_update": 0.5}.get(fault, 1.0)
    a = _slice("jax")
    b = _slice("torch", server_lr=lr)
    with pytest.raises(AssertionError, match="update off by"):
        _compare(a, b, 2e-2)


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_logical_only_slice_matches_reference_tightly(wire):
    """Only f32 logical rows enter: 1e-5."""
    a = _slice("jax", wire=wire, bench=0, physical=False)
    b = _slice("torch", wire=wire, bench=0, physical=False)
    assert not any(e.num_physical for e in a[0].entries)
    _compare(a, b, 1e-5)


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_streaming_slice_matches_reference(wire):
    a = _slice("jax", wire=wire, streaming=True)
    b = _slice("torch", wire=wire, streaming=True)
    _compare(a, b, 2e-2)


@pytest.mark.parametrize("mode", ["scalar_plane", "host_path"])
def test_reference_planes_match(mode):
    kw = ({"columnar": False} if mode == "scalar_plane"
          else {"zero_copy": False})
    _compare(_slice("jax", **kw), _slice("torch", **kw), 2e-2)


def test_legacy_single_grade_run_round():
    data = make_federated_ctr(num_devices=12, records_per_device=RECORDS,
                              dim=DIM, seed=3)
    X, Y, c = data.stacked_shards(np.arange(12), RECORDS)
    mask = (np.arange(RECORDS)[None] < c[:, None]).astype(np.float32)
    res = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            M, sim_mod, G = J, j_sim, J_GRADES
            local = jctr.make_local_train_fn(lr=1e-2, epochs=5)
            params, batch, dev = jctr.lr_init(None, DIM), {
                "x": jnp.asarray(X), "y": jnp.asarray(Y),
                "mask": jnp.asarray(mask)}, {}
            rng = jax.random.PRNGKey(1)
        else:
            M, sim_mod, G = T, t_sim, T_GRADES
            local = tctr.make_local_train_fn(lr=1e-2, epochs=5)
            params, batch, dev = tctr.lr_init(DIM, device="cpu"), {
                "x": X, "y": Y, "mask": mask}, {"device": "cpu"}
            rng = torch.Generator().manual_seed(1)
        svc = M.AggregationService(params,
                                   trigger=M.SampleThresholdTrigger(
                                       int(c.sum())))
        flow = M.DeviceFlow(svc)
        flow.register_task(0, M.AccumulatedStrategy(thresholds=(1,)))
        sim = sim_mod.HybridSimulation(
            sim_mod.LogicalTier(local, cohort_size=8, **dev),
            sim_mod.DeviceTier(local, G["High"], cohort_size=4, **dev),
            deviceflow=flow)
        out = sim.run_round(task_id=0, round_idx=0, global_params=params,
                            client_batches=batch, num_samples=c,
                            num_logical=6, rng=rng, benchmark_devices=2)
        res.append((out, svc, flow))
    (jo, js, jf), (to, ts, tf) = res
    np.testing.assert_array_equal(jo.arrival_times, to.arrival_times)
    assert len(js.history) == len(ts.history) == 1
    assert [r.device_id for r in jo.reports] == [r.device_id
                                                 for r in to.reports]
    assert tf.conservation_ok(0) and (
        jf.shelf(0).total_bytes_dispatched
        == tf.shelf(0).total_bytes_dispatched)
    # From zero params the global params are the round's update.
    got = _flat({k: v.numpy() for k, v in ts.global_params.items()})
    want = _flat({k: np.asarray(v) for k, v in js.global_params.items()})
    assert _rel(got, want) <= 2e-2
