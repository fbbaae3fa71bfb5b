"""Multi-process fleet execution in the port: pooled rounds bit-identical to
inline rounds on both wires, the recycled segment ring, worker death and
redispatch, and the segment layout against the reference's.

The reference's ``tuned_blocks`` tests (``tests/test_workers.py``) hold the
JAX kernel's Pallas block table; the port's ``fed_reduce`` has no such table
(its launch plan is ``kernels/fed_reduce/ops.py::plan``), so they have no
counterpart here.

The tier factory is module level and this module imports no JAX at the top,
so spawned workers import it cheaply; the reference is imported inside the
test that compares with it.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.deviceflow import DeviceFlow  # noqa: E402
from repro_torch.core.devicemodel import GRADES  # noqa: E402
from repro_torch.core.federation import (  # noqa: E402
    AggregationService,
    SampleThresholdTrigger,
)
from repro_torch.core.simulation import (  # noqa: E402
    DeviceTier,
    HybridSimulation,
    LogicalTier,
)
from repro_torch.core.strategies import AccumulatedStrategy  # noqa: E402
from repro_torch.data.synthetic_ctr import make_federated_ctr  # noqa: E402
from repro_torch.models import ctr  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    WorkerFailure,
    redispatch_chunks,
)
from repro_torch.runtime.workers import (  # noqa: E402
    FleetWorkerPool,
    WorkerPoolError,
    WorkerSpec,
    segment_layout,
)

N, RPD, DIM = 24, 8, 16


def make_tiers(cohort=4, seed=7, device="cpu"):
    """Module-level so spawned workers can unpickle it by reference."""
    local = ctr.make_local_train_fn(lr=1e-2, epochs=2)
    return (LogicalTier(local, cohort_size=cohort, device=device),
            {"High": DeviceTier(local, GRADES["High"], seed=seed,
                                cohort_size=cohort, device=device)})


class RecordingSink:
    """Forwarding sink that records dispatch-group membership + stamps."""

    def __init__(self, svc):
        self.svc = svc
        self.groups = []

    def __call__(self, d):
        if d.batch is not None:
            self.groups.append((d.t, tuple(d.batch.device_ids.tolist()),
                                tuple(d.batch.created_t.tolist())))
        else:
            m = d.message
            self.groups.append((d.t, (m.device_id,), (m.created_t,)))
        self.svc(d)


def _run_world(wire, workers, *, rounds=2, delay=None, poison=None,
               stream=False):
    """Run ``rounds`` full rounds; return the observable world state.
    ``stream`` submits each chunk as it is emitted to a streaming service."""
    data = make_federated_ctr(num_devices=N, records_per_device=RPD,
                              dim=DIM, seed=0)
    X, Y, counts = data.stacked_shards(np.arange(N), RPD)
    mask = (np.arange(RPD)[None] < counts[:, None]).astype(np.float32)
    batches = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y),
               "mask": torch.from_numpy(mask)}
    svc = AggregationService(
        ctr.lr_init(DIM, device="cpu"),
        trigger=SampleThresholdTrigger(int(counts.sum())), streaming=stream)
    sink = RecordingSink(svc)
    flow = DeviceFlow(sink)
    flow.register_task(0, AccumulatedStrategy(thresholds=(1,)))
    logical, tiers = make_tiers()
    kw = {}
    if workers and delay is not None:
        kw = dict(worker_pool=FleetWorkerPool(
            WorkerSpec(make_tiers), workers, device="cpu",
            debug_delay_s=delay))
    elif workers:
        kw = dict(workers=workers, worker_spec=WorkerSpec(make_tiers))
    sim = HybridSimulation(logical, tiers=tiers, deviceflow=flow,
                           wire=wire, stream_chunks=stream, **kw)
    stats = failures = alive = workers = None
    segments = set()
    try:
        for rnd in range(rounds):
            if poison is not None and rnd == poison[0]:
                sim.pool.poison_worker(poison[1],
                                       fail_after_chunks=poison[2])
            sim.run_round(task_id=0, round_idx=rnd,
                          global_params=svc.global_params,
                          client_batches=batches, num_samples=counts,
                          num_logical=10,
                          rng=torch.Generator().manual_seed(rnd))
            flow.run(1e12)
            svc.tick(flow.clock.now)
        if sim.pool is not None:
            stats = dict(sim.pool.stats)
            failures = list(sim.pool.failures)
            alive = list(sim.pool.alive_workers)
            segments = {n for h in sim.pool._workers for n in h.announced}
            workers = sim.pool.worker_stats()
    finally:
        sim.close()
    shelf = flow.shelf(0)
    return {
        "params": {k: v.clone() for k, v in svc.global_params.items()},
        "bytes_received": shelf.total_bytes_received,
        "bytes_dispatched": shelf.total_bytes_dispatched,
        "aggregations": len(svc.history),
        "groups": sink.groups,
        "stats": stats,
        "failures": failures,
        "alive": alive,
        "segments": segments,
        "workers": workers,
    }


_REF_CACHE = {}


def _inline_ref(wire, stream=False):
    if (wire, stream) not in _REF_CACHE:
        _REF_CACHE[wire, stream] = _run_world(wire, 0, stream=stream)
    return _REF_CACHE[wire, stream]


def _assert_equivalent(ref, got):
    assert sorted(ref["params"]) == sorted(got["params"])
    for k in ref["params"]:
        assert torch.equal(ref["params"][k], got["params"][k]), k
    assert got["bytes_received"] == ref["bytes_received"]
    assert got["bytes_dispatched"] == ref["bytes_dispatched"]
    assert got["aggregations"] == ref["aggregations"]
    # Dispatch-group membership and created_t stamps match group-for-group.
    assert len(got["groups"]) == len(ref["groups"])
    for (t0, ids0, ct0), (t1, ids1, ct1) in zip(ref["groups"],
                                                got["groups"]):
        assert t0 == t1 and ids0 == ids1
        np.testing.assert_array_equal(np.asarray(ct0), np.asarray(ct1))


@pytest.mark.parametrize("wire,workers,delay", [
    ("f32", 2, None),       # even shard count
    ("int8", 3, (0.0, 0.03, 0.01)),  # odd shards + jittered interleaving
    ("int8", 1, None),      # degenerate pool: every chunk on one worker
])
def test_pool_round_bit_identical(wire, workers, delay):
    """A multi-process round — any shard count, any worker completion
    interleaving, quantized wire included — is bit-identical to the
    single-process columnar round: same params, byte counters, dispatch
    groups and created_t stamps (the int8 case also shows error-feedback
    residuals stay with their shard across rounds)."""
    ref = _inline_ref(wire)
    got = _run_world(wire, workers, delay=delay)
    _assert_equivalent(ref, got)
    st = got["stats"]
    assert st["chunks"] == 2 * 7  # 3 logical + 4 device chunks per round
    assert st["segments_created"] >= 1 and st["bytes_shipped"] > 0
    assert st["redispatched_chunks"] == 0 and got["failures"] == []


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_pool_streamed_round_bit_identical(wire):
    """With ``stream_chunks=True`` a pooled round still emits its chunks in
    chunk order, whatever order the jittered workers finish in, so the
    streaming service's partials and everything DeviceFlow saw are
    bit-identical to the inline streamed round."""
    ref = _inline_ref(wire, stream=True)
    got = _run_world(wire, 2, delay=(0.03, 0.0), stream=True)
    _assert_equivalent(ref, got)
    assert got["stats"]["chunks"] == 2 * 7 and got["failures"] == []


def test_pool_segment_ring_recycles():
    """Later rounds reuse earlier rounds' shared-memory segments: creations
    stay bounded while reuses accrue."""
    got = _run_world("f32", 2, rounds=3)
    st = got["stats"]
    assert st["segment_reuses"] > 0
    assert st["segments_created"] <= st["chunks"]
    # Each worker reports where it computed, its segments and busy time.
    assert sorted(got["workers"]) == [0, 1]
    assert all(w["device"] == "cpu" and w["peak_allocated_bytes"] is None
               and w["segments"] >= 1 and w["busy_s"] > 0
               for w in got["workers"].values())


def test_worker_death_mid_round_redispatch():
    """Kill a worker mid-round (after it ships one chunk): the coordinator
    re-dispatches its remaining chunks to survivors and the round still
    completes bit-identical to the inline reference."""
    ref = _inline_ref("f32")
    got = _run_world("f32", 3, poison=(1, 1, 1))  # round 1, worker 1
    _assert_equivalent(ref, got)
    assert got["alive"] is not None and len(got["alive"]) == 2
    assert 1 not in got["alive"]
    assert len(got["failures"]) == 1
    f = got["failures"][0]
    assert isinstance(f, WorkerFailure) and f.worker_id == 1
    assert f.chunks and set(f.survivors) == set(got["alive"])
    assert got["stats"]["redispatched_chunks"] == len(f.chunks)


def test_redispatch_chunks_round_robin():
    from repro.runtime.fault_tolerance import redispatch_chunks as ref

    got = redispatch_chunks([7, 3, 5], survivors=[0, 2])
    assert got == ref([7, 3, 5], survivors=[0, 2]) == {0: [3, 7], 2: [5]}
    with pytest.raises(RuntimeError):
        redispatch_chunks([1], survivors=[])


@pytest.mark.parametrize("shapes,dtypes,rows,wire", [
    ([(100,), (7,)], ["float32", "float32"], 3, "int8"),
    ([(100,)], ["float32"], 3, "f32"),
    ([(16,), ()], ["float32", "float32"], 8, "int8"),
    ([(256,), ()], ["float32", "float32"], 8192, "f32"),
    ([(4, 5), (3,)], ["float32", "int32"], 5, "f32"),
])
def test_segment_layout_matches_reference(shapes, dtypes, rows, wire):
    from repro.runtime.workers import segment_layout as ref_layout

    got, total = segment_layout(shapes, dtypes, rows, wire)
    want, want_total = ref_layout(shapes, dtypes, rows, wire)
    assert total == want_total
    assert [(o, s, str(d)) for o, s, d in got] == [
        (o, s, str(d)) for o, s, d in want]
    assert all(off % 64 == 0 for off, _, _ in got)


def test_segment_layout_alignment_and_wire():
    layout, total = segment_layout(
        [(100,), (7,)], ["float32", "float32"], 3, "int8")
    assert [d for _, _, d in layout] == ["int8", "int8",
                                        "float32", "float32"]
    assert all(off % 64 == 0 for off, _, _ in layout)
    assert layout[2][1] == (3,) and total >= layout[-1][0] + 12
    f_layout, _ = segment_layout([(100,)], ["float32"], 3, "f32")
    assert f_layout == [(0, (3, 100), "float32")]


def test_pooled_round_needs_a_spec_and_zero_copy():
    logical, tiers = make_tiers()
    with pytest.raises(ValueError, match="worker_spec"):
        HybridSimulation(logical, tiers=tiers, workers=2)
    with pytest.raises(ValueError, match="zero_copy"):
        HybridSimulation(logical, tiers=tiers, workers=2, zero_copy=False,
                         worker_spec=WorkerSpec(make_tiers))


def test_pool_defaults_to_the_card_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetWorkerPool(WorkerSpec(make_tiers), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetWorkerPool(WorkerSpec(make_tiers), 2, device="cuda")


def test_worker_on_another_device_than_told_raises():
    """A factory that builds its tiers elsewhere than the pool's device is
    refused by the worker, never run there quietly."""
    pool = FleetWorkerPool(WorkerSpec(make_tiers, {"device": "meta"}), 1,
                           device="cpu")
    logical, tiers = make_tiers()
    sim = HybridSimulation(logical, tiers=tiers, worker_pool=pool)
    batches = {"x": torch.zeros(N, RPD, DIM), "y": torch.zeros(N, RPD),
               "mask": torch.ones(N, RPD)}
    try:
        with pytest.raises(WorkerPoolError, match="meta"):
            sim.run_round(0, 0, ctr.lr_init(DIM, device="cpu"), batches,
                          np.full(N, RPD), 10, torch.Generator())
    finally:
        sim.close()


def test_close_leaves_no_segment_behind():
    """Every result segment the workers announced is gone from /dev/shm
    once the simulation closes its pool."""
    got = _run_world("int8", 2, rounds=2)
    assert got["segments"]
    assert not [n for n in got["segments"]
                if os.path.exists(os.path.join("/dev/shm", n))]
