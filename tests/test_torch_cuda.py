"""Tests that need an NVIDIA card: the ``fed_reduce`` CUDA kernel against its
plain version, and a small federated round on the card against the same
round on the CPU, with the hot-path sync sanitizer armed.  They skip where
CUDA is not available.  This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import sanitizers  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AccumulatedStrategy,
    AggregationService,
    DeviceFlow,
    GradeSpec,
    RoundPlan,
    RuntimeCalibrator,
    SampleThresholdTrigger,
    solve_allocation,
)
from repro_torch.core.devicemodel import GRADES, DeviceFleet  # noqa: E402
from repro_torch.core.simulation import (  # noqa: E402
    DeviceTier,
    HybridSimulation,
    LogicalTier,
)
from repro_torch.data.synthetic_ctr import make_federated_ctr  # noqa: E402
from repro_torch.kernels.fed_reduce.ops import fed_reduce  # noqa: E402
from repro_torch.models import ctr  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, n, d, dtype):
    g = torch.Generator().manual_seed(seed)
    if dtype == "int8":
        U = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8)
    else:
        U = torch.randn((n, d), generator=g)
        U = U.to(torch.bfloat16) if dtype == "bf16" else U
    w = torch.rand(n, generator=g) * 20
    w[torch.rand(n, generator=g) < 0.25] = 0.0
    s = torch.rand(n, generator=g) * 1e-2 + 1e-4
    return U, w, (s if dtype == "int8" else None)


@pytest.mark.parametrize("n,d", [(8192, 256), (8192, 1), (1696, 256),
                                 (70, 300), (1, 1)])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_kernel_matches_plain_and_repeats(cuda_device, n, d, dtype):
    U, w, s = (t if t is None else t.to(cuda_device)
               for t in _inputs(n + d, n, d, dtype))
    before = fed_reduce.launches
    a = fed_reduce(U, w, scales=s)
    b = fed_reduce(U, w, scales=s)
    plain = fed_reduce(U, w, scales=s, impl="ref")
    torch.cuda.synchronize()
    assert fed_reduce.launches == before + 2
    assert torch.equal(a, b)  # fixed reduction order, no float atomics
    wf = w if s is None else w * s
    mag = (wf.abs()[:, None] * U.float().abs()).sum(0).clamp_min(1e-30)
    assert float(((a - plain).abs() / mag).max()) <= 1e-4


def test_kernel_rejects_strided_and_takes_misaligned_stacks(cuda_device):
    U, w, _ = _inputs(1, 65, 257, "f32")
    with pytest.raises(ValueError, match="contiguous"):
        fed_reduce(U.to(cuda_device)[1:, 1:], w[1:].to(cuda_device))
    with pytest.raises(TypeError, match="float32"):
        fed_reduce(U.to(cuda_device), w.to(cuda_device).double())
    # A contiguous stack whose base is 4 bytes past a 16-byte boundary:
    # the plan falls back from 16-byte vector loads to scalar loads.
    flat = torch.randn(64 * 256 + 1, device=cuda_device)
    V = flat[1:].reshape(64, 256)
    wv = torch.rand(64, device=cuda_device)
    got = fed_reduce(V, wv)
    torch.testing.assert_close(got, (wv[:, None] * V).sum(0), atol=1e-4,
                               rtol=1e-5)


def _round(device, wire, streaming, n_high=240, n_low=160, dim=32, rounds=2):
    specs = [GradeSpec("High", n_high, benchmarking_devices=1,
                       logical_bundles=32, bundles_per_device=4,
                       physical_devices=40),
             GradeSpec("Low", n_low, benchmarking_devices=1,
                       logical_bundles=16, bundles_per_device=2,
                       physical_devices=40)]
    cal = RuntimeCalibrator()
    for g in ("High", "Low"):
        probe = DeviceFleet(GRADES[g], 64, seed=7)
        for r in range(3):
            cal.observe_fleet(probe.run_round(r))
    plan = RoundPlan.from_allocation(
        solve_allocation(specs, cal.runtimes_for(specs)), specs)
    batches, counts = {}, {}
    for i, spec in enumerate(specs):
        data = make_federated_ctr(num_devices=spec.num_devices,
                                  records_per_device=12, dim=dim, seed=i)
        X, Y, c = data.stacked_shards(np.arange(spec.num_devices), 12)
        mask = (np.arange(12)[None] < c[:, None]).astype(np.float32)
        batches[spec.grade] = {k: torch.from_numpy(v).to(device)
                               for k, v in (("x", X), ("y", Y),
                                            ("mask", mask))}
        counts[spec.grade] = c
    local = ctr.make_local_train_fn(lr=0.05, epochs=5)
    svc = AggregationService(ctr.lr_init(dim, device=device),
                             trigger=SampleThresholdTrigger(1500),
                             streaming=streaming)
    flow = DeviceFlow(svc)
    flow.register_task(0, AccumulatedStrategy(thresholds=(1,)))
    sim = HybridSimulation(
        LogicalTier(local, cohort_size=64, device=device),
        tiers={g: DeviceTier(local, GRADES[g], cohort_size=64, device=device)
               for g in ("High", "Low")},
        deviceflow=flow, wire=wire, stream_chunks=streaming)
    for rnd in range(rounds):
        sim.run_plan_round(0, rnd, svc.global_params, plan, batches, counts,
                           torch.Generator().manual_seed(rnd), calibrator=cal)
    return (ctr.params_to_numpy(svc.global_params), len(svc.history),
            flow.shelf(0).total_bytes_dispatched)


@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("streaming", [False, True])
def test_round_on_card_matches_cpu_under_sync_sanitizer(cuda_device, wire,
                                                        streaming):
    before = fed_reduce.launches
    with sanitizers.override(True):  # host syncs in hot paths raise
        gpu = _round(cuda_device, wire, streaming)
    assert fed_reduce.launches > before
    cpu = _round(torch.device("cpu"), wire, streaming)
    assert gpu[1:] == cpu[1:]
    for k in gpu[0]:
        np.testing.assert_allclose(gpu[0][k], cpu[0][k], atol=2e-2,
                                   rtol=2e-2)
