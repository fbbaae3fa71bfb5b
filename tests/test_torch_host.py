"""Host-side modules of the port against the reference, exactly: fleet
samples, allocation, calibration, traffic curves, strategies, the synthetic
CTR data, and DeviceFlow dispatch on one submit sequence."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.allocation as j_alloc  # noqa: E402
import repro.core.calibration as j_cal  # noqa: E402
import repro.core.deviceflow as j_flow  # noqa: E402
import repro.core.devicemodel as j_dm  # noqa: E402
import repro.core.strategies as j_strat  # noqa: E402
import repro.core.task as j_task  # noqa: E402
import repro.core.traffic_curves as j_tc  # noqa: E402
import repro.core.updates as j_upd  # noqa: E402
import repro.data.synthetic_ctr as j_data  # noqa: E402
import repro_torch.core.allocation as t_alloc  # noqa: E402
import repro_torch.core.calibration as t_cal  # noqa: E402
import repro_torch.core.deviceflow as t_flow  # noqa: E402
import repro_torch.core.devicemodel as t_dm  # noqa: E402
import repro_torch.core.strategies as t_strat  # noqa: E402
import repro_torch.core.task as t_task  # noqa: E402
import repro_torch.core.traffic_curves as t_tc  # noqa: E402
import repro_torch.core.updates as t_upd  # noqa: E402
import repro_torch.data.synthetic_ctr as t_data  # noqa: E402


def _astuple(x):
    return dataclasses.astuple(x)


# --------------------------------------------------------------------------- #
# Device fleet
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grade", ["High", "Low"])
@pytest.mark.parametrize("seed", [0, 9])
def test_fleet_samples_bit_identical(grade, seed):
    jf = j_dm.DeviceFleet(j_dm.GRADES[grade], 300, seed=seed)
    tf = t_dm.DeviceFleet(t_dm.GRADES[grade], 300, seed=seed)
    for r in range(3):
        a, b = jf.run_round(r, train_cost_scale=1.3), tf.run_round(
            r, train_cost_scale=1.3)
        np.testing.assert_array_equal(a.stage_duration_min,
                                      b.stage_duration_min)
        np.testing.assert_array_equal(a.arrival_offsets_s(),
                                      b.arrival_offsets_s())
        np.testing.assert_array_equal(a.total_power_mah, b.total_power_mah)
        np.testing.assert_array_equal(a.comm_kb, b.comm_kb)
        assert _astuple(a.report(7))[:3] == _astuple(b.report(7))[:3]
    rows = np.array([5, 400, 2])
    np.testing.assert_array_equal(jf.rows_for(rows), tf.rows_for(rows))
    np.testing.assert_array_equal(
        jf.run_round(4, rows=jf.rows_for(rows)).stage_duration_min,
        tf.run_round(4, rows=tf.rows_for(rows)).stage_duration_min)


# --------------------------------------------------------------------------- #
# Allocation and calibration
# --------------------------------------------------------------------------- #
def _specs(pkg, rng):
    return [pkg.GradeSpec(g, int(rng.integers(1, 5000)),
                          benchmarking_devices=int(rng.integers(0, 3)),
                          logical_bundles=int(rng.integers(0, 400)),
                          bundles_per_device=int(rng.integers(1, 5)),
                          physical_devices=int(rng.integers(1, 300)))
            for g in ("High", "Low")]


@pytest.mark.parametrize("seed", range(6))
def test_solve_allocation_identical(seed):
    js = _specs(j_task, np.random.default_rng(seed))
    ts = _specs(t_task, np.random.default_rng(seed))
    rts_rng = np.random.default_rng(100 + seed)
    vals = [(float(rts_rng.uniform(5, 40)), float(rts_rng.uniform(30, 90)),
             float(rts_rng.uniform(0, 20))) for _ in js]
    jr = j_alloc.solve_allocation(js, [j_alloc.GradeRuntime(*v) for v in vals])
    tr = t_alloc.solve_allocation(ts, [t_alloc.GradeRuntime(*v) for v in vals])
    assert jr.makespan == tr.makespan
    assert [_astuple(g) for g in jr.per_grade] == [
        _astuple(g) for g in tr.per_grade]
    assert (j_alloc.solve_allocation_bruteforce(
        js, [j_alloc.GradeRuntime(*v) for v in vals]).makespan
        == t_alloc.solve_allocation_bruteforce(
            ts, [t_alloc.GradeRuntime(*v) for v in vals]).makespan)


def test_calibrator_runtimes_identical():
    jc, tc = j_cal.RuntimeCalibrator(), t_cal.RuntimeCalibrator()
    for g in ("High", "Low"):
        jp = j_dm.DeviceFleet(j_dm.GRADES[g], 64, seed=7)
        tp = t_dm.DeviceFleet(t_dm.GRADES[g], 64, seed=7)
        for r in range(3):
            jc.observe_fleet(jp.run_round(r))
            tc.observe_fleet(tp.run_round(r))
    jc.observe_logical("High", 12.5)
    tc.observe_logical("High", 12.5)
    names = ["High", "Low"]
    assert [_astuple(r) for r in jc.runtimes_for(names)] == [
        _astuple(r) for r in tc.runtimes_for(names)]
    a = jc.sample_runtimes(names, np.random.default_rng(3))
    b = tc.sample_runtimes(names, np.random.default_rng(3))
    assert [_astuple(r) for r in a] == [_astuple(r) for r in b]
    assert jc.state_dict() == tc.state_dict()
    assert (_astuple(j_cal.table1_runtime(j_dm.GRADES["Low"]))
            == _astuple(t_cal.table1_runtime(t_dm.GRADES["Low"])))


# --------------------------------------------------------------------------- #
# Traffic curves and strategies
# --------------------------------------------------------------------------- #
def test_traffic_curves_identical():
    for jc, tc in zip(j_tc.table2_curves(), t_tc.table2_curves()):
        assert jc.name == tc.name and (jc.lo, jc.hi) == (tc.lo, tc.hi)
        assert j_tc.arrival_quantiles(jc, 37) == t_tc.arrival_quantiles(tc, 37)
    jd, td = j_tc.diurnal(), t_tc.diurnal()
    assert [jd(t) for t in np.linspace(0, 86400, 97)] == [
        td(t) for t in np.linspace(0, 86400, 97)]
    assert (j_tc.arrival_quantiles(jd, 50, 600.0)
            == t_tc.arrival_quantiles(td, 50, 600.0))
    jr, tr = j_tc.right_tailed_normal(2.0), t_tc.right_tailed_normal(2.0)
    assert (jr.hi, jr(1.3)) == (tr.hi, tr(1.3))


@pytest.mark.parametrize("curve_idx", range(6))
def test_discretized_strategies_identical(curve_idx):
    jc, tc = j_tc.table2_curves()[curve_idx], t_tc.table2_curves()[curve_idx]
    assert (j_strat.discretize_curve(jc, 5000, 20.0, 700.0)
            == t_strat.discretize_curve(tc, 5000, 20.0, 700.0))
    js = j_strat.TimeIntervalStrategy(jc, 10.0, failure_prob=0.1,
                                      random_discard_per_tick=1)
    ts = t_strat.TimeIntervalStrategy(tc, 10.0, failure_prob=0.1,
                                      random_discard_per_tick=1)
    assert ([_astuple(p) for p in js.discretize(900).points]
            == [_astuple(p) for p in ts.discretize(900).points])


# --------------------------------------------------------------------------- #
# Synthetic CTR data (the port's copy is vectorized)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(num_devices=500, records_per_device=20, dim=64, seed=0),
    dict(num_devices=97, records_per_device=7, dim=32, seed=1,
         noniid_alpha=0.3),
    dict(num_devices=60, records_per_device=5, dim=16, seed=2,
         positive_rate_split=(0.7, 0.8, 0.2)),
], ids=["iid", "noniid", "positive_split"])
def test_make_federated_ctr_and_stacked_shards_bit_identical(kw):
    a, b = j_data.make_federated_ctr(**kw), t_data.make_federated_ctr(**kw)
    for f in ("features", "labels", "device_ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    ids = np.array([3, 0, 7, 7, kw["num_devices"] - 1, kw["num_devices"] + 5])
    R = kw["records_per_device"]
    for r in (R, 3, R + 4):
        for x, y in zip(a.stacked_shards(ids, r), b.stacked_shards(ids, r)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for d in (0, 5):
        for x, y in zip(a.device_shard(d), b.device_shard(d)):
            np.testing.assert_array_equal(x, y)


def test_stacked_shards_unsorted_device_ids_match_reference():
    rng = np.random.default_rng(4)
    n, dim = 60, 8
    kw = dict(features=rng.random((n, dim)).astype(np.float32),
              labels=(rng.random(n) < 0.5).astype(np.float32),
              device_ids=rng.integers(0, 9, n).astype(np.int32),
              num_devices=9, dim=dim)
    a, b = j_data.CTRDataset(**kw), t_data.CTRDataset(**kw)
    ids = np.arange(10)
    for x, y in zip(a.stacked_shards(ids, 5), b.stacked_shards(ids, 5)):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------------------------------- #
# DeviceFlow: one submit sequence through both packages
# --------------------------------------------------------------------------- #
def _submit_sequence(flow_mod, upd_mod, make_leaf, strategy):
    got = []

    def sink(d):
        if d.batch is not None:
            got.append((d.t, "batch", d.batch.device_ids.tolist(),
                        d.batch.created_t.tolist(), d.batch.nbytes.tolist()))
        else:
            m = d.message
            got.append((d.t, "msg", [m.device_id], [m.created_t],
                        [m.size_bytes]))

    flow = flow_mod.DeviceFlow(sink, seed=3)
    flow.register_task(0, strategy)
    rng = np.random.default_rng(0)
    for r in range(3):
        rows = 6 + r
        w = rng.standard_normal((rows, 5)).astype(np.float32)
        b = rng.standard_normal((rows,)).astype(np.float32)
        stacked = {"w": make_leaf(w), "b": make_leaf(b)}
        buf = (upd_mod.UpdateBuffer.quantized_from_stacked(stacked) if r == 1
               else upd_mod.UpdateBuffer.from_stacked(stacked))
        batch = flow_mod.ArrivalBatch.from_buffer(
            0, r, buf, device_ids=np.arange(10 * r, 10 * r + rows),
            num_samples=np.arange(1, rows + 1))
        straggler = flow_mod.Message(0, 99 + r, r, {"w": np.ones(5, np.float32)},
                                     num_samples=2)
        ts = np.concatenate([rng.uniform(r, r + 1, rows), [r + 0.5]])
        flow.submit_arrivals([batch, straggler], ts=ts)
        flow.submit(flow_mod.Message(0, 200 + r, r, None), t=r + 0.25)
        flow.round_complete(0, t=r + 1.0)
        flow.run(r + 1.0)
    flow.run(1e9)
    s = flow.shelf(0)
    return got, (s.total_received, s.total_dispatched, s.total_dropped,
                 s.total_bytes_received, s.total_bytes_dispatched,
                 len(s), flow.conservation_ok(0))


@pytest.mark.parametrize("strategy", [
    "realtime", "threshold", "timepoints", "curve"])
def test_deviceflow_dispatch_identical(strategy):
    def strat(mod, tc):
        return {
            "realtime": lambda: mod.AccumulatedStrategy(thresholds=(1,)),
            "threshold": lambda: mod.AccumulatedStrategy(thresholds=(4, 3),
                                                         failure_prob=0.2),
            "timepoints": lambda: mod.TimePointStrategy((
                mod.DispatchPoint(0.1, 3, random_discard=1),
                mod.DispatchPoint(0.4, 5, failure_prob=0.3))),
            "curve": lambda: mod.TimeIntervalStrategy(
                tc.table2_curves()[2], 2.0, capacity_per_second=30.0),
        }[strategy]()

    a = _submit_sequence(j_flow, j_upd, jnp.asarray, strat(j_strat, j_tc))
    b = _submit_sequence(t_flow, t_upd, torch.from_numpy,
                         strat(t_strat, t_tc))
    assert a[1] == b[1]
    assert len(a[0]) == len(b[0]) and len(a[0]) > 0
    for x, y in zip(a[0], b[0]):
        assert x == y


def test_payload_nbytes_counts_tensors():
    assert t_flow.payload_nbytes(torch.zeros(3, 4)) == 48
    assert t_flow.payload_nbytes({"w": torch.zeros(5, dtype=torch.bfloat16),
                                  "b": np.zeros(2, np.float32)}) == 18
    assert (t_flow.Message(0, 1, 0, {"w": torch.zeros(8)}).size_bytes
            == j_flow.Message(0, 1, 0, {"w": jnp.zeros(8)}).size_bytes)
