"""The rest of the federated main path on the port, against the JAX package
on the CPU: monitoring, data partitioners, update compression, the
checkpointer (each package reads the other's checkpoints), recycled update
buffers and the two examples a new user starts from.  Host-side modules
are held exact; the examples' allocation and virtual-time lines are equal
and their test accuracy within 1e-4."""
import json
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.core import monitoring as jmon  # noqa: E402
from repro.core.deviceflow import ArrivalBatch as JBatch  # noqa: E402
from repro.core.deviceflow import DeviceFlow as JFlow  # noqa: E402
from repro.core.deviceflow import Message as JMessage  # noqa: E402
from repro.core.devicemodel import GRADES as J_GRADES  # noqa: E402
from repro.core.federation import AggregationService as JService  # noqa: E402
from repro.core.federation import ClientCountTrigger as JCount  # noqa: E402
from repro.core.federation import SampleThresholdTrigger as JThreshold  # noqa: E402
from repro.core.simulation import DeviceTier as JDeviceTier  # noqa: E402
from repro.core.simulation import HybridSimulation as JSim  # noqa: E402
from repro.core.simulation import LogicalTier as JLogical  # noqa: E402
from repro.core.strategies import AccumulatedStrategy as JAccumulated  # noqa: E402
from repro.core.updates import UpdateBuffer as JBuffer  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.models import ctr as jctr  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.core import monitoring as tmon  # noqa: E402
from repro_torch.core.devicemodel import GRADES, DeviceFleet  # noqa: E402
from repro_torch.core.simulation import (  # noqa: E402
    DeviceTier,
    HybridSimulation,
    LogicalTier,
)
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data.synthetic_ctr import make_federated_ctr  # noqa: E402
from repro_torch.examples import federated_ctr, quickstart  # noqa: E402
from repro_torch.models import ctr as tctr  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x)


# --------------------------------------------------------------------------- #
# Monitoring
# --------------------------------------------------------------------------- #
def _monitored(mon, pkg):
    bus = mon.MetricsBus()
    events = []
    bus.subscribe(lambda e: events.append(
        (e.t, e.source, e.task_id, e.kind, e.values)))
    if pkg == "jax":
        svc = JService({"w": jnp.zeros(2)}, trigger=JCount(2))
        flow, msg = JFlow(svc), JMessage
        flow.register_task(7, JAccumulated(thresholds=(1,)))
        one = jnp.ones(2)
    else:
        svc = T.AggregationService({"w": torch.zeros(2)},
                                   trigger=T.ClientCountTrigger(2))
        flow, msg = T.DeviceFlow(svc), T.Message
        flow.register_task(7, T.AccumulatedStrategy(thresholds=(1,)))
        one = torch.ones(2)
    mon.wire_aggregation_service(bus, svc, task_id=7)
    monitor = mon.TaskMonitor(bus, task_id=7)
    for i in range(4):
        flow.submit(msg(7, i, 0, {"w": one * (i + 1)}, num_samples=5))
    bus.emit(mon.MetricEvent(1.0, "device", 7, "telemetry",
                             {"power_mah": 2.5}))
    bus.emit(mon.MetricEvent(2.0, "cloud", 8, "aggregation",
                             {"num_clients": 3}))
    return monitor.summary(), monitor.to_json(), events, svc


def test_monitor_aggregation_feed_matches_reference():
    """The reference's ``test_monitor_aggregation_feed`` on both packages:
    the same summary, JSON and event stream."""
    want = _monitored(jmon, "jax")
    got = _monitored(tmon, "torch")
    assert got[0] == want[0]
    assert got[0]["aggregations"] == 2 and got[0]["clients_aggregated"] == 4
    assert got[0]["mean_device_power_mah"] == 2.5
    assert got[1] == want[1]
    assert got[2] == want[2]
    np.testing.assert_array_equal(_np(got[3].global_params["w"]),
                                  np.asarray(want[3].global_params["w"]))


def test_monitor_filters_other_tasks_and_needs_a_clock():
    bus = tmon.MetricsBus()
    mon = tmon.TaskMonitor(bus, task_id=1)
    bus.emit(tmon.MetricEvent(0.0, "cloud", 2, "aggregation",
                              {"num_clients": 3}))
    bus.emit(tmon.MetricEvent(0.0, "cloud", 1, "aggregation",
                              {"num_clients": 5}))
    assert mon.summary()["clients_aggregated"] == 5
    with pytest.raises(RuntimeError, match="clock"):
        bus.emit_now("cloud", 1, "aggregation")
    clock = T.VirtualClock()
    vbus = tmon.MetricsBus.on_virtual_clock(clock)
    sink = tmon.InMemorySink()
    vbus.subscribe(sink)
    clock.schedule(12.5, lambda: vbus.emit_now("runner", 1, "round_start"))
    clock.run_until()
    assert sink.latest(1, "round_start").t == 12.5
    assert tmon.MetricsBus is T.MetricsBus  # exported from core


# --------------------------------------------------------------------------- #
# Partitioners (numpy: bit-identical)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_partitioners_are_bit_identical(seed):
    labels = np.random.default_rng(seed).integers(0, 3, 1000).astype(
        np.float32)
    pairs = [
        (jpart.iid_partition(1000, 10, seed=seed),
         tpart.iid_partition(1000, 10, seed=seed)),
        (jpart.label_skew_partition(labels, 10, seed=seed),
         tpart.label_skew_partition(labels, 10, seed=seed)),
        (jpart.dirichlet_partition(labels, 10, alpha=0.5, seed=seed),
         tpart.dirichlet_partition(labels, 10, alpha=0.5, seed=seed)),
    ]
    for want, got in pairs:
        assert len(got) == 10
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        allidx = np.concatenate(got)
        assert len(np.unique(allidx)) == len(allidx) >= 900


def test_label_skew_creates_noniid():
    labels = np.random.default_rng(0).integers(0, 2, 2000).astype(np.float32)
    parts = tpart.label_skew_partition(labels, 10, frac_positive_heavy=0.7,
                                       heavy_pos_share=0.8)
    rates = [labels[p].mean() for p in parts if len(p)]
    assert max(rates) - min(rates) > 0.3


# --------------------------------------------------------------------------- #
# Compression (exact against the reference in f32)
# --------------------------------------------------------------------------- #
def _update(seed, shapes=(("b", ()), ("w", (6, 9)), ("z", (31,)))):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes}


def _pair(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v.copy()) for k, v in tree.items()})


@pytest.mark.parametrize("fraction", [0.01, 0.2, 0.7])
def test_topk_compress_is_exact(fraction):
    """Kept values, residuals and stats equal the reference's bit for bit,
    over two rounds (the residual carries)."""
    ju, tu = _pair(_update(0))
    jstate, tstate = jcomp.topk_init(ju), tcomp.topk_init(tu)
    for seed in (0, 1):
        ju, tu = _pair(_update(seed))
        jk, jstate, jstats = jcomp.topk_compress(ju, jstate,
                                                 fraction=fraction)
        tk, tstate, tstats = tcomp.topk_compress(tu, tstate,
                                                 fraction=fraction)
        assert tstats == jstats
        for k in ju:
            np.testing.assert_array_equal(_np(tk[k]), np.asarray(jk[k]))
            np.testing.assert_array_equal(_np(tstate.residual[k]),
                                          np.asarray(jstate.residual[k]))


def test_topk_keeps_every_tie_at_the_threshold():
    u = {"w": np.array([3, -3, 1, 3, 0, -1, 2, 3], np.float32)}
    ju, tu = _pair(u)
    jk, _, jstats = jcomp.topk_compress(ju, jcomp.topk_init(ju),
                                        fraction=0.25)
    tk, _, tstats = tcomp.topk_compress(tu, tcomp.topk_init(tu),
                                        fraction=0.25)
    np.testing.assert_array_equal(_np(tk["w"]), np.asarray(jk["w"]))
    assert tstats["nonzero"] == jstats["nonzero"] == 4  # k = 2, four 3s


@pytest.mark.parametrize("n,d,fraction", [(1, 2, 0.5), (5, 17, 0.05),
                                          (8, 60, 0.3), (3, 40, 0.9)])
def test_topk_rows_is_exact(n, d, fraction):
    rng = np.random.default_rng(n * d)
    stacked = {"b": rng.standard_normal((n,)).astype(np.float32),
               "w": rng.standard_normal((n, d, 2)).astype(np.float32)}
    js, ts = _pair(stacked)
    jres = tres = None
    for _ in range(2):  # the second round carries the residual
        jk, jres, jnnz = jcomp.topk_compress_rows(js, jres, fraction=fraction)
        tk, tres, tnnz = tcomp.topk_compress_rows(ts, tres, fraction=fraction)
        np.testing.assert_array_equal(tnnz, jnnz)
        assert len(tres) == len(jres) == 2
        for k in stacked:
            assert tuple(tk[k].shape) == stacked[k].shape
            np.testing.assert_array_equal(_np(tk[k]), np.asarray(jk[k]))
        for a, b in zip(tres, jres):
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_topk_rows_restarts_on_layout_change():
    _, res, _ = tcomp.topk_compress_rows({"w": torch.ones(3, 8)}, None,
                                         fraction=0.5)
    kept, res2, _ = tcomp.topk_compress_rows({"w": torch.ones(4, 8)}, res,
                                             fraction=0.5)
    assert res2[0].shape == (4, 8)
    torch.testing.assert_close(kept["w"] + res2[0], torch.ones(4, 8),
                               rtol=0, atol=0)


def test_int8_round_trip_and_payload_bytes_are_exact():
    ju, tu = _pair(_update(3))
    jq, js = jcomp.int8_quantize(ju)
    tq, ts = tcomp.int8_quantize(tu)
    for k in ju:
        assert tq[k].dtype == torch.int8
        np.testing.assert_array_equal(_np(tq[k]), np.asarray(jq[k]))
        np.testing.assert_array_equal(_np(ts[k]), np.asarray(js[k]))
    jd = jcomp.int8_dequantize(jq, js, ju)
    td = tcomp.int8_dequantize(tq, ts, tu)
    for k in ju:
        np.testing.assert_array_equal(_np(td[k]), np.asarray(jd[k]))
    assert tcomp.payload_bytes((tq, ts)) == jcomp.payload_bytes((jq, js))
    q = {"w": np.zeros((4, 8), np.int8)}
    assert tcomp.payload_bytes(q) == 32
    assert tcomp.payload_bytes((q, {"w": np.zeros(4, np.float32)})) == 48
    assert tcomp.payload_bytes((q, {"w": 0.5})) == 40
    assert tcomp.payload_bytes({"w": torch.zeros(3, 2)}) == 24


def _topk_round(pkg, rounds=2):
    """A --compress round on the columnar plane (the reference's
    ``test_payload_transform_compresses_on_the_columnar_plane``): each
    cohort chunk is top-k compressed with error feedback kept per chunk."""
    n, rpd, dim = 12, 8, 16
    data = make_federated_ctr(num_devices=n, records_per_device=rpd,
                              dim=dim, seed=0)
    X, Y, counts = data.stacked_shards(np.arange(n), rpd)
    mask = (np.arange(rpd)[None] < counts[:, None]).astype(np.float32)
    if pkg == "jax":
        M = dict(svc=JService, thr=JThreshold, flow=JFlow, acc=JAccumulated,
                 sim=JSim, log=JLogical, dev=JDeviceTier, grades=J_GRADES,
                 batch=JBatch, buf=JBuffer, comp=jcomp)
        local = jctr.make_local_train_fn(lr=1e-2, epochs=2)
        params = jctr.lr_init(jax.random.PRNGKey(0), dim)
        batches = {"x": jnp.asarray(X), "y": jnp.asarray(Y),
                   "mask": jnp.asarray(mask)}
        dev = {}
        take = lambda leaf, rows: leaf[np.asarray(rows)]
    else:
        M = dict(svc=T.AggregationService, thr=T.SampleThresholdTrigger,
                 flow=T.DeviceFlow, acc=T.AccumulatedStrategy,
                 sim=HybridSimulation, log=LogicalTier, dev=DeviceTier,
                 grades=GRADES, batch=T.ArrivalBatch, buf=T.UpdateBuffer,
                 comp=tcomp)
        local = tctr.make_local_train_fn(lr=1e-2, epochs=2)
        params = tctr.lr_init(dim, device="cpu")
        batches = {"x": X, "y": Y, "mask": mask}
        dev = {"device": "cpu"}
        take = lambda leaf, rows: leaf[torch.as_tensor(np.asarray(rows))]
    svc = M["svc"](params, trigger=M["thr"](int(counts.sum())))
    flow = M["flow"](svc)
    flow.register_task(0, M["acc"](thresholds=(1,)))
    memory = {}

    def compress(e):
        if isinstance(e, M["batch"]) and e.buffer is not None:
            stacked = {k: take(v, e.rows)
                       for k, v in e.buffer.materialize().items()}
            key = int(e.device_ids[0])
            kept, memory[key], nnz = M["comp"].topk_compress_rows(
                stacked, memory.get(key), fraction=0.3)
            return M["batch"](
                e.task_id, e.round_idx, rows=np.arange(e.n),
                created_t=e.created_t, nbytes=np.maximum(nnz, 1) * 8,
                num_samples=e.num_samples, device_ids=e.device_ids,
                buffer=M["buf"].from_stacked(kept))
        return e

    sim = M["sim"](M["log"](local, cohort_size=5, **dev),
                   M["dev"](local, M["grades"]["High"], cohort_size=4, **dev),
                   deviceflow=flow, zero_copy=True,
                   payload_transform=compress)
    for rnd in range(rounds):
        rng = (jax.random.PRNGKey(rnd) if pkg == "jax"
               else torch.Generator().manual_seed(rnd))
        sim.run_round(0, rnd, svc.global_params, batches, counts, 12, rng)
        flow.run(1e9)
        svc.tick(flow.clock.now)
    shelf = flow.shelf(0)
    return ((shelf.total_bytes_received, shelf.total_bytes_dispatched,
             shelf.total_dispatched), len(svc.history),
            {k: _np(v) for k, v in svc.global_params.items()})


def test_topk_payload_transform_round_matches_reference():
    """Wire bytes and aggregation counts of a compressed round equal the
    reference's; the params agree to the f32 round tolerance."""
    jbytes, jaggs, jparams = _topk_round("jax")
    tbytes, taggs, tparams = _topk_round("torch")
    assert tbytes == jbytes and taggs == jaggs == 2
    dense_row = 17 * 4
    assert 0 < tbytes[1] < 2 * 12 * dense_row
    for k in jparams:
        err = np.linalg.norm(tparams[k] - jparams[k]) / max(
            np.linalg.norm(jparams[k]), 1e-30)
        assert err <= 2e-2, (k, err)


# --------------------------------------------------------------------------- #
# Checkpointer (same manifest format: each package reads the other's)
# --------------------------------------------------------------------------- #
def _state(x=0.0):
    return {"params": {"w": np.full((4, 4), x, np.float32),
                       "b": np.arange(3, dtype=np.float32)},
            "layers": [{"k": np.full((2,), x + i, np.float32)}
                       for i in range(2)],
            "step": np.asarray(int(x), np.int32)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(jax.tree.map(_np, a)), jax.tree.leaves(
        jax.tree.map(_np, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    Checkpointer(tmp_path / "t").save(7, _torch_tree(_state(3.5)),
                                      extra={"note": "hello"})
    JCheckpointer(tmp_path / "j").save(7, _jax_tree(_state(3.5)),
                                       extra={"note": "hello"})
    tman = json.loads((tmp_path / "t/step_0000000007/manifest.json")
                      .read_text())
    jman = json.loads((tmp_path / "j/step_0000000007/manifest.json")
                      .read_text())
    assert tman["keys"] == jman["keys"]
    assert "layers/1/k" in tman["keys"]
    for k in ("step", "num_hosts", "extra", "has_runtime_state",
              "runtime_sections"):
        assert tman[k] == jman[k]
    restored, extra = JCheckpointer(tmp_path / "t").restore(
        _jax_tree(_state()))
    _leaves_equal(restored, _state(3.5))
    assert extra == {"note": "hello"}


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    JCheckpointer(tmp_path).save(3, _jax_tree(_state(2.0)), extra={"a": 1})
    ck = Checkpointer(tmp_path)
    assert ck.latest_step() == 3
    like = _torch_tree(_state())
    restored, extra = ck.restore(like)
    assert isinstance(restored["params"]["w"], torch.Tensor)
    assert restored["step"].dtype == torch.int32
    _leaves_equal(restored, _state(2.0))
    assert extra == {"a": 1}


def test_checkpoint_bf16_and_update_buffers_round_trip(tmp_path):
    """bf16 is stored widened (exact) and restored as bf16; a live
    ``UpdateBuffer`` is saved materialized and restores bitwise."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((5, 3)).astype(
        np.float32)).to(torch.bfloat16)
    buf = T.UpdateBuffer.from_stacked(
        {"b": torch.from_numpy(rng.standard_normal((6,)).astype(np.float32)),
         "w": torch.from_numpy(rng.standard_normal((6, 4)).astype(
             np.float32))})
    ck = Checkpointer(tmp_path)
    ck.save(1, {"params": {"w": w}, "buffer": buf})
    like = {"params": {"w": torch.zeros(5, 3, dtype=torch.bfloat16)},
            "buffer": buf.materialize()}
    restored, _ = ck.restore(like)
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], w)
    for k, v in buf.materialize().items():
        assert torch.equal(restored["buffer"][k], v)
    data = np.load(tmp_path / "step_0000000001/shard-0.npz")
    assert data["params/w"].dtype == np.float32


def test_checkpoint_async_gc_and_uncommitted(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(s, _torch_tree(_state(float(s))))
    ck.wait()
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    (tmp_path / "step_0000000009").mkdir()  # a crash mid-save
    assert ck.latest_step() == 4
    assert not (tmp_path / "step_0000000009").exists()
    restored, _ = ck.restore(_torch_tree(_state()))
    _leaves_equal(restored, _state(4.0))
    with pytest.raises(TypeError, match="non-JSON"):
        ck.save(5, _torch_tree(_state()), extra={"bad": object()})
    assert ck.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(_torch_tree(_state()))


def test_checkpoint_runtime_state_holds_host_data_only(tmp_path):
    buf = T.UpdateBuffer.from_stacked({"w": torch.arange(6.0).reshape(3, 2)})
    msg = T.Message(0, 1, 0, buf.handle(1), num_samples=4)
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.zeros(2)})
    ck.save(2, {"w": torch.zeros(2)},
            runtime_state={"flow": [msg], "t": torch.tensor(1.5)})
    assert ck.restore_runtime_state(1) is None
    state = ck.restore_runtime_state()
    got = state["flow"][0]
    assert isinstance(got.payload, dict)
    assert torch.equal(got.payload["w"], torch.tensor([2.0, 3.0]))
    assert float(state["t"]) == 1.5
    man = json.loads((tmp_path / "step_0000000002/manifest.json").read_text())
    assert man["has_runtime_state"] and man["runtime_sections"] == ["flow",
                                                                     "t"]


# --------------------------------------------------------------------------- #
# Recycled update buffers
# --------------------------------------------------------------------------- #
def _quickstart_rounds(recycle, wire="f32", rounds=3):
    specs = quickstart._specs()
    cal = T.RuntimeCalibrator()
    for g in ("High", "Low"):
        fleet = DeviceFleet(GRADES[g], 64, seed=7)
        for r in range(3):
            cal.observe_fleet(fleet.run_round(r))
    plan = T.RoundPlan.from_allocation(
        T.solve_allocation(specs, cal.runtimes_for(specs)), specs)
    batches, counts = {}, {}
    for i, spec in enumerate(specs):
        data = make_federated_ctr(num_devices=spec.num_devices,
                                  records_per_device=16, dim=64, seed=i)
        X, Y, c = data.stacked_shards(np.arange(spec.num_devices), 16)
        mask = (np.arange(16)[None] < c[:, None]).astype(np.float32)
        batches[spec.grade] = {"x": X, "y": Y, "mask": mask}
        counts[spec.grade] = c
    local = tctr.make_local_train_fn(lr=1e-3, epochs=10)
    svc = T.AggregationService(tctr.lr_init(64, device="cpu"),
                               trigger=T.SampleThresholdTrigger(24 * 16 // 2))
    flow = T.DeviceFlow(svc)
    flow.register_task(0, T.AccumulatedStrategy(thresholds=(1,)))
    sim = HybridSimulation(
        LogicalTier(local, cohort_size=16, device="cpu"),
        tiers={g: DeviceTier(local, GRADES[g], device="cpu")
               for g in ("High", "Low")},
        deviceflow=flow, wire=wire, recycle_buffers=recycle)
    out, ptrs = [], []
    for rnd in range(rounds):
        oc = sim.run_plan_round(
            task_id=0, round_idx=rnd, global_params=svc.global_params,
            plan=plan, grade_batches=batches, grade_num_samples=counts,
            rng=torch.Generator().manual_seed(rnd), calibrator=cal)
        if wire == "int8":
            flow.run(1e12)
            svc.tick(flow.clock.now)
        shelf = flow.shelf(0)
        out.append(({k: v.clone() for k, v in svc.global_params.items()},
                    len(svc.history), shelf.total_bytes_dispatched,
                    np.asarray(oc.arrival_times)))
        # The device-tier buffers this round kept for the next one.
        assert all(isinstance(t, DeviceTier) for t in sim.tiers.values())
        assert {k[0] for k in sim._retired} <= {id(t) for t in
                                                sim.tiers.values()}
        ptrs.append(sorted(leaf.data_ptr() for bufs in sim._retired.values()
                           for b in bufs for leaf in b.leaves2d))
    return out, ptrs


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_recycled_rounds_equal_fresh_rounds_bitwise(wire):
    fresh, fresh_ptrs = _quickstart_rounds(False, wire)
    recycled, ptrs = _quickstart_rounds(True, wire)
    for (pa, na, ba, ta), (pb, nb, bb, tb) in zip(fresh, recycled):
        assert (na, ba) == (nb, bb)
        np.testing.assert_array_equal(ta, tb)
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert fresh_ptrs == [[], [], []]  # nothing kept without the option
    if wire == "f32":
        # Rounds 1 and 2 write the device tiers' chunks into round 0's
        # storage.
        assert ptrs[0] and ptrs[0] == ptrs[1] == ptrs[2]
    else:
        assert ptrs == [[], [], []]


def _tier_inputs(rows=4):
    params = tctr.lr_init(3, device="cpu")
    params["w"] = torch.linspace(-1.0, 1.0, 3)
    batch = {"x": torch.linspace(0.0, 1.0, rows * 6).reshape(rows, 2, 3),
             "y": torch.ones(rows, 2), "mask": torch.ones(rows, 2)}
    return params, batch, torch.arange(rows, dtype=torch.int64)


def test_recycle_falls_back_on_a_layout_change():
    local = tctr.make_local_train_fn(lr=1e-2, epochs=1)
    tier = DeviceTier(local, GRADES["High"], device="cpu")
    params, batch, seeds = _tier_inputs()
    first, _ = tier.run_cohort_zero_copy(params, batch, seeds)
    again, _ = tier.run_cohort_zero_copy(params, batch, seeds,
                                         recycle=first)
    assert all(a.data_ptr() == f.data_ptr()
               for a, f in zip(again.leaves2d, first.leaves2d))
    small = {k: v[:3] for k, v in batch.items()}
    other, _ = tier.run_cohort_zero_copy(params, small, seeds[:3],
                                         recycle=again)
    assert other.num_rows == 3
    assert other.leaves2d[0].data_ptr() != again.leaves2d[0].data_ptr()
    q = T.UpdateBuffer([torch.zeros(4, 1, dtype=torch.int8),
                        torch.zeros(4, 3, dtype=torch.int8)],
                       ("b", "w"), [(), (3,)], [np.float32, np.float32],
                       wire="int8", scales=[torch.ones(4), torch.ones(4)])
    fresh, _ = tier.run_cohort_zero_copy(params, batch, seeds, recycle=q)
    assert fresh.wire == "f32" and fresh.leaves2d[1].dtype == torch.float32


def test_recycled_cast_writes_the_fresh_bits_into_the_retired_leaves():
    """The device tier's cast back to f32 is the ``out=`` target: the
    retired leaves take exactly the bits a fresh chunk gets."""
    local = tctr.make_local_train_fn(lr=1e-2, epochs=3)
    tier = DeviceTier(local, GRADES["Low"], device="cpu")
    params, batch, seeds = _tier_inputs(rows=5)
    want, _ = tier.run_cohort_zero_copy(params, batch, seeds)
    retired = T.UpdateBuffer([torch.full_like(l, 7.0) for l in want.leaves2d],
                             want.keys, want.shapes, want.dtypes)
    got, _ = tier.run_cohort_zero_copy(params, batch, seeds, recycle=retired)
    for g, w, r in zip(got.leaves2d, want.leaves2d, retired.leaves2d):
        assert g.data_ptr() == r.data_ptr()
        assert torch.equal(g, w)


@pytest.mark.parametrize("tier_kind", ["logical", "device_f32"])
def test_recycle_leaves_a_tier_without_a_cast_on_fresh_storage(tier_kind):
    """The logical tier's update is its training function's own output,
    and a device tier computing in f32 casts nothing: neither has an op to
    redirect, so a retired buffer is left as it was."""
    local = tctr.make_local_train_fn(lr=1e-2, epochs=1)
    tier = (LogicalTier(local, cohort_size=4, device="cpu")
            if tier_kind == "logical" else
            DeviceTier(local, GRADES["High"], dtype=torch.float32,
                       device="cpu"))
    params, batch, seeds = _tier_inputs()
    want, _ = tier.run_cohort_zero_copy(params, batch, seeds)
    retired = T.UpdateBuffer([torch.full_like(l, 7.0) for l in want.leaves2d],
                             want.keys, want.shapes, want.dtypes)
    got, _ = tier.run_cohort_zero_copy(params, batch, seeds, recycle=retired)
    for g, w, r in zip(got.leaves2d, want.leaves2d, retired.leaves2d):
        assert g.data_ptr() != r.data_ptr()
        assert torch.equal(g, w)
        assert bool((r == 7.0).all())


# --------------------------------------------------------------------------- #
# The examples
# --------------------------------------------------------------------------- #
def _run_reference(path, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [path] + argv)
    env = runpy.run_path(path)
    return capsys.readouterr().out.splitlines(), env


def test_quickstart_matches_the_reference_example(capsys, monkeypatch):
    """The reference's ``examples/quickstart.py`` and the port's sections
    1-12: every line the port prints is the reference's (section 12's
    ``simcheck`` lint line too), with the test accuracy within 1e-4, but
    the port's own fenced line (the reference poisons a donated buffer, the
    port a recycled one).  Task ids come from each package's own counter,
    so the section 6 lines compare with their ids masked."""
    ref, env = _run_reference("examples/quickstart.py", [], capsys,
                              monkeypatch)
    got = quickstart.run("cpu")
    capsys.readouterr()
    want = [line for line in ref
            if line.split(":")[0].split("[")[0].split(" ")[0] in (
                "allocation", "estimated", "round", "deviceflow",
                "re-measured", "benchmark-device", "task", "interleaved",
                "non-preemptive", "preemptive", "monte-carlo", "columnar",
                "quantized", "serving", "worker", "simcheck")]
    fenced = [line for line in got["lines"]
              if line.startswith("use-after-recycle fenced:")]
    assert len(fenced) == 1 and got["lines"][-1] == fenced[0]
    assert "use-after-donate fenced:" in ref[-1]
    lines = got["lines"][:-1]
    assert len(lines) == len(want) == 22
    assert lines[-1] == want[-1] == "simcheck lint over src/: 0 finding(s)"

    def strip_acc(line):
        line = re.sub(r"^task [0-9]+:", "task #:", line)
        return re.sub(r"(test_acc=|run above: )[0-9.]+", r"\1#", line)
    for a, b in zip(lines, want):
        assert strip_acc(a) == strip_acc(b)
    assert abs(got["test_acc"][-1] - env["acc"]) <= 1e-4
    assert abs(got["test_acc_int8"] - env["acc9"]) <= 1e-4
    assert got["token_identical"]


def test_federated_ctr_matches_the_reference_example(capsys, monkeypatch):
    argv = ["--devices", "120", "--rounds", "2", "--dropout", "0.1"]
    ref, env = _run_reference("examples/federated_ctr.py", argv, capsys,
                              monkeypatch)
    rows = federated_ctr.run(devices=120, rounds=2, dropout=0.1,
                             device="cpu")
    capsys.readouterr()
    assert len(ref) == len(rows) == 2
    for line, row in zip(ref, rows):
        fields = dict(re.findall(r"(\w+)=\s*([0-9.]+)", line))
        assert float(fields["virtual_t"]) == row["virtual_t"]
        assert int(fields["aggregations"]) == row["aggregations"]
        assert int(fields["dropped"]) == row["dropped"]
        assert abs(float(fields["test_acc"]) - row["test_acc"]) <= 1e-4
    assert abs(rows[-1]["test_acc"] - env["acc"]) <= 1e-4


def test_serve_traffic_matches_the_reference_example(capsys, monkeypatch):
    """The reference's ``examples/serve_traffic.py`` and the port's print
    the same lines (the smoke config's serving report)."""
    from repro_torch.examples import serve_traffic
    from repro_torch.launch import serve as tserve

    ref, _ = _run_reference_exit("examples/serve_traffic.py", [], capsys,
                                 monkeypatch)
    assert serve_traffic.argv(["--device", "cpu"])[-2:] == ["--device", "cpu"]
    assert tserve.main(serve_traffic.argv(["--device", "cpu"])) in (0, None)
    got = capsys.readouterr().out.splitlines()
    assert got == ref and len(ref) >= 4


def _run_reference_exit(path, argv, capsys, monkeypatch):
    """:func:`_run_reference` for a script that ends in ``sys.exit``."""
    monkeypatch.setattr(sys, "argv", [path] + argv)
    with pytest.raises(SystemExit) as e:
        runpy.run_path(path)
    assert e.value.code in (0, None)
    return capsys.readouterr().out.splitlines(), None


def test_examples_default_to_the_card_and_take_cpu_when_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        federated_ctr.main(["--devices", "4", "--rounds", "1"])
    assert federated_ctr.main(["--devices", "8", "--rounds", "1",
                               "--device", "cpu"]) == 0
    assert "round 0:" in capsys.readouterr().out
