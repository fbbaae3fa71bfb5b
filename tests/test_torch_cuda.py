"""Tests that need an NVIDIA card: the ``fed_reduce``, ``decode_attention``,
``flash_attention`` and ``ssd_scan`` CUDA kernels against their plain
versions, a small federated round on the card against the same round on the
CPU, a short continuous-batching serving run (dense and MoE), both with
the hot-path sync sanitizer armed, Mamba2 fixed-batch serving against its
plain path, MoE routing on the card against the CPU's, and recycled update
buffers against fresh ones.  They skip where CUDA is not available.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

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
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention,
    scatter_prefill_rows,
)
from repro_torch.kernels.fed_reduce.ops import fed_reduce  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import ctr, mamba2  # noqa: E402

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


def test_kernel_leaves_its_tickets_at_zero(cuda_device):
    """One launch per call: calls of different shapes in a row each give
    the same bits as a fresh call (a new, zeroed ticket buffer), so every
    launch leaves its column tiles' tickets at 0."""
    from repro_torch.kernels.fed_reduce import ops

    shapes = [(8192, 256, "f32"), (8192, 1, "int8"), (1696, 256, "bf16"),
              (70, 300, "f32"), (5616, 256, "int8"), (8192, 256, "f32")]
    inputs = [tuple(t if t is None else t.to(cuda_device)
                    for t in _inputs(i, n, d, dt))
              for i, (n, d, dt) in enumerate(shapes)]
    in_a_row = [fed_reduce(U, w, scales=s) for U, w, s in inputs]
    torch.cuda.synchronize()
    assert not ops._tickets[cuda_device.index or 0].any()
    for (U, w, s), got in zip(inputs, in_a_row):
        ops._tickets.clear()  # a fresh call: a new zeroed buffer
        before = fed_reduce.launches
        fresh = fed_reduce(U, w, scales=s)
        torch.cuda.synchronize()
        assert fed_reduce.launches == before + 1
        assert torch.equal(got, fresh)
        wf = w if s is None else w * s
        mag = (wf.abs()[:, None] * U.float().abs()).sum(0).clamp_min(1e-30)
        plain = fed_reduce(U, w, scales=s, impl="ref")
        assert float(((got - plain).abs() / mag).max()) <= 1e-4


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


def _round(device, wire, streaming, n_high=240, n_low=160, dim=32, rounds=2,
           recycle=False):
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
        deviceflow=flow, wire=wire, stream_chunks=streaming,
        recycle_buffers=recycle)
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


# --------------------------------------------------------------------------
# attention kernels: the reference test cases (tests/test_kernels.py:27,65),
# the llama3.2-3b group of 3 and the serving shapes

ATTN_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
# The last three are granite-moe-3b's decode (24/8 heads of 64) and
# seamless-m4t-medium's self- and cross-attention decode (16/16 of 64).
DECODE_CASES = [(2, 256, 8, 2, 64), (1, 512, 4, 4, 128), (3, 300, 6, 1, 64),
                (2, 64, 16, 16, 32), (3, 96, 6, 2, 16),
                (16, 577, 24, 8, 128), (16, 577, 24, 8, 64),
                (16, 129, 16, 16, 64), (16, 256, 16, 16, 64)]
# (b, sq, sk, h, kv, d, causal, q_offset).  Beyond the reference's cases,
# the tensor-core kernel's edges (bf16 at d = 64, 128): sq not a multiple of
# its 64- or 128-row tile (70, 96, 200), a key tail past sk, q_offset 104
# and 255 with sq = 1, g in {1, 3, 4}, non-causal, a causal 128-row tile
# with rows for one warpgroup only (sq = 60, sk = 200), and both serving
# shapes (llama3.2-3b's 24/8 heads of 128, zamba2-1.2b's 32/32 heads of 64).
FLASH_CASES = [(2, 256, 256, 4, 2, 64, True, 0),
               (1, 128, 384, 8, 8, 128, False, 0),
               (2, 96, 200, 6, 2, 64, True, 104),
               (1, 1, 256, 4, 1, 64, True, 255),
               (1, 512, 512, 2, 1, 32, True, 0),
               (2, 40, 40, 6, 2, 16, True, 0),
               (2, 512, 512, 24, 8, 128, True, 0),
               (2, 200, 200, 12, 4, 128, True, 0),
               (2, 96, 200, 6, 2, 128, True, 104),
               (1, 1, 256, 4, 1, 128, True, 255),
               (2, 200, 330, 8, 2, 64, False, 0),
               (3, 70, 130, 4, 4, 128, False, 0),
               (1, 60, 200, 4, 2, 128, True, 0),
               (16, 512, 512, 24, 8, 128, True, 0),
               (16, 512, 512, 32, 32, 64, True, 0),
               # granite-moe-3b's prefill; seamless-m4t-medium's encoder,
               # decoder self-attention and cross-attention (sq != sk).
               (16, 512, 512, 24, 8, 64, True, 0),
               (16, 256, 256, 16, 16, 64, False, 0),
               (16, 64, 64, 16, 16, 64, True, 0),
               (16, 64, 256, 16, 16, 64, False, 0)]


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen).to(dtype).to(device)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_k", [None, 16, 512])
def test_decode_kernel_matches_plain_and_repeats(cuda_device, case, dtype,
                                                 block_k):
    b, s, h, kv, d = case
    gen = torch.Generator().manual_seed(b * s + h)
    q = _randn(gen, (b, h, d), dtype, cuda_device)
    kc = _randn(gen, (b, s, kv, d), dtype, cuda_device)
    vc = _randn(gen, (b, s, kv, d), dtype, cuda_device)
    lens = torch.randint(1, s + 1, (b,), generator=gen, dtype=torch.int32)
    lens[-1] = s
    if b > 1:
        lens[0] = 0  # an empty slot
    lens = lens.to(cuda_device)
    before = decode_attention.launches
    a = decode_attention(q, kc, vc, lens, block_k=block_k)
    a2 = decode_attention(q, kc, vc, lens, block_k=block_k)
    plain = decode_attention(q, kc, vc, lens, impl="ref")
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(a, a2)  # split order fixed, no float atomics
    assert (a[lens == 0] == 0).all()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(a.float(), plain.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_k", [None, 16, 64, 512])
def test_decode_kernel_ignores_stale_kv(cuda_device, block_k, dtype):
    """A reused slot's rows past its new length hold the previous
    occupant's K/V; under every split rule (by length, fixed rows) and on
    both streams (f32 plain FMAs, bf16 tensor cores) the kernel never
    reads them, and an empty slot gives exact zeros."""
    slots, s, h, kv, d, new_len = 4, 96, 24, 8, 128, 24
    gen = torch.Generator().manual_seed(7)
    old_k = _randn(gen, (slots, s, kv, d), dtype, cuda_device)
    old_v = _randn(gen, (slots, s, kv, d), dtype, cuda_device)
    rows = _randn(gen, (2, new_len, kv, d), dtype, cuda_device)
    sid = torch.tensor([2], dtype=torch.int32, device=cuda_device)
    dirty_k = scatter_prefill_rows(old_k.clone(), rows[:1], sid)
    dirty_v = scatter_prefill_rows(old_v.clone(), rows[1:], sid)
    clean_k, clean_v = dirty_k.clone(), dirty_v.clone()
    clean_k[2, new_len:] = 0.0
    clean_v[2, new_len:] = 0.0
    lens = torch.tensor([s, 13, new_len, 0], dtype=torch.int32,
                        device=cuda_device)
    q = _randn(gen, (slots, h, d), dtype, cuda_device)
    a = decode_attention(q, dirty_k, dirty_v, lens, block_k=block_k)
    c = decode_attention(q, clean_k, clean_v, lens, block_k=block_k)
    torch.testing.assert_close(a, c, atol=1e-6, rtol=0)
    assert (a[3] == 0).all()


@pytest.mark.parametrize("case,block_k", [
    ((16, 577, 24, 8, 128), None), ((16, 577, 32, 32, 64), None),
    ((1, 512, 4, 4, 128), None), ((2, 300, 8, 2, 64), 16),
    ((3, 96, 24, 8, 16), None)])
def test_decode_is_one_kernel_per_call(cuda_device, case, block_k):
    """One launch per call, the splits' fold included, by length (one
    cluster) or with a fixed block_k (an int ticket)."""
    from torch.profiler import ProfilerActivity, profile

    b, s, h, kv, d = case
    gen = torch.Generator().manual_seed(11)
    q = _randn(gen, (b, h, d), torch.bfloat16, cuda_device)
    kc = _randn(gen, (b, s, kv, d), torch.bfloat16, cuda_device)
    vc = _randn(gen, (b, s, kv, d), torch.bfloat16, cuda_device)
    lens = torch.randint(0, s + 1, (b,), generator=gen,
                         dtype=torch.int32).to(cuda_device)
    decode_attention(q, kc, vc, lens, block_k=block_k)  # build and warm up
    torch.cuda.synchronize()
    # The tracer can drop a window's first or last records, so the window
    # is bracketed by sentinel kernels (torch.cuda._sleep's spin_kernel) and
    # counts only when both edges are sentinels; else it runs again with a
    # longer pad, as chip_smoke.py's ``profiled`` does.
    for pad in (1024, 8192, 32768):
        before = decode_attention.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(1000)
            for _ in range(3):
                decode_attention(q, kc, vc, lens, block_k=block_k)
            for _ in range(pad):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        if kern and all("spin_kernel" in kern[i].name for i in (0, -1)):
            break
    else:
        pytest.fail("the profiler lost records at an edge of every window")
    names = [e.name for e in kern if "spin_kernel" not in e.name]
    assert decode_attention.launches == before + 3
    assert len(names) == 3 and all("decode_kernel" in n for n in names)


def test_decode_kernel_leaves_its_tickets_at_zero(cuda_device):
    """Calls of different shapes in a row, fixed-row splits that fold
    through the tickets among them, each give the bits of a fresh call (a
    new, zeroed ticket buffer): every launch leaves its tickets at 0."""
    from repro_torch.kernels.decode_attention import ops

    cases = [((16, 577, 24, 8, 128), 16), ((3, 300, 6, 1, 64), 32),
             ((16, 577, 24, 8, 128), None), ((2, 256, 8, 2, 64), 16),
             ((1, 512, 4, 4, 128), 48)]
    gen = torch.Generator().manual_seed(12)
    inputs = []
    for (b, s, h, kv, d), block_k in cases:
        q = _randn(gen, (b, h, d), torch.bfloat16, cuda_device)
        kc = _randn(gen, (b, s, kv, d), torch.bfloat16, cuda_device)
        vc = _randn(gen, (b, s, kv, d), torch.bfloat16, cuda_device)
        lens = torch.randint(0, s + 1, (b,), generator=gen,
                             dtype=torch.int32).to(cuda_device)
        inputs.append((q, kc, vc, lens, block_k))
    in_a_row = [decode_attention(q, kc, vc, ln, block_k=bk)
                for q, kc, vc, ln, bk in inputs]
    torch.cuda.synchronize()
    assert not ops._tickets[cuda_device.index or 0].any()
    for (q, kc, vc, ln, bk), got in zip(inputs, in_a_row):
        ops._tickets.clear()  # a fresh call: a new zeroed buffer
        fresh = decode_attention(q, kc, vc, ln, block_k=bk)
        torch.cuda.synchronize()
        assert torch.equal(got, fresh)
        plain = decode_attention(q, kc, vc, ln, impl="ref")
        torch.testing.assert_close(got.float(), plain.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_and_repeats(cuda_device, case, dtype):
    b, sq, sk, h, kv, d, causal, off = case
    gen = torch.Generator().manual_seed(sq + sk + h)
    q = _randn(gen, (b, sq, h, d), dtype, cuda_device)
    k = _randn(gen, (b, sk, kv, d), dtype, cuda_device)
    v = _randn(gen, (b, sk, kv, d), dtype, cuda_device)
    kw = dict(causal=causal, q_offset=off)
    before = flash_attention.launches
    wgmma_before = flash_attention.wgmma_launches
    a = flash_attention(q, k, v, **kw)
    a2 = flash_attention(q, k, v, **kw)
    plain = flash_attention(q, k, v, impl="ref", **kw)
    chunked = flash_attention(q, k, v, impl="chunked", **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    # bf16 at d = 64 and 128 runs on the tensor cores; f32 and the other
    # widths on the plain-FMA kernel.
    on_tensor_cores = dtype == torch.bfloat16 and d in (64, 128)
    assert flash_attention.wgmma_launches == wgmma_before + (
        2 if on_tensor_cores else 0)
    assert torch.equal(a, a2)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(a.float(), plain.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(a.float(), chunked.float(), atol=tol,
                               rtol=tol)


def test_attention_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(1, 8, 4, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q[..., :32], q[..., :32], q[..., :32])
    lens = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q[:, 0, :, :32].contiguous(), q[..., :32].contiguous(),
                         q[..., :32].contiguous(), lens.long())


def test_serving_run_on_card_under_sync_sanitizer(cuda_device):
    """A short continuous-batching run on the card with the sync sanitizer
    armed: no host sync in ``step``, both kernels launched, and the tokens
    equal the plain path's on the card (f32)."""
    import dataclasses

    cfg = dataclasses.replace(get_config("llama3_2_3b", smoke=True),
                              dtype="float32")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (5, 8))

    def run(attn_impl, attention_impl):
        c = dataclasses.replace(cfg, attention_impl=attention_impl)
        eng = ContinuousBatchingEngine(c, slots=3, prompt_len=8,
                                       decode_tokens=4, seed=0,
                                       attn_impl=attn_impl,
                                       device=cuda_device)
        for i in range(5):
            eng.submit(i, prompts[i], 0.0)
        t = 0.0
        with sanitizers.override(True):
            while eng.has_work:
                t += eng.step(t)
        return {r.request_id: r.tokens for r in eng.report().records}

    d0, f0 = decode_attention.launches, flash_attention.launches
    kernel = run("auto", "auto")
    assert decode_attention.launches > d0 and flash_attention.launches > f0
    plain = run("ref", "einsum")
    assert kernel == plain


# --------------------------------------------------------------------------
# ssd_scan: the reference test cases (tests/test_kernels.py:186), a ragged
# length, the overflowing decays, and Mamba2 serving on the card

SSD_CASES = [(2, 128, 4, 32, 1, 16, 32), (1, 256, 8, 64, 2, 64, 64),
             (2, 64, 2, 16, 2, 8, 16), (1, 128, 4, 64, 1, 128, 128),
             (2, 100, 4, 64, 1, 64, 32)]


def _ssd_inputs(gen, case, dtype, device, *, A=None, dt=None):
    b, l, h, p, g, n, _ = case
    x = (torch.randn((b, l, h, p), generator=gen) * 0.5).to(dtype)
    dtv = (torch.randn((b, l, h), generator=gen).abs() * 0.1 + 0.01
           if dt is None else torch.full((b, l, h), dt))
    Av = (-torch.randn(h, generator=gen).abs() - 0.1 if A is None
          else torch.full((h,), A))
    B = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dtype)
    C = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dtype)
    return [t.to(device) for t in (x, dtv, Av, B, C)]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_and_repeats(cuda_device, case, dtype):
    gen = torch.Generator().manual_seed(sum(case))
    args = _ssd_inputs(gen, case, dtype, cuda_device)
    chunk = case[-1]
    before = ssd_ops.ssd_scan.launches
    y, s = ssd_ops.ssd_scan(*args, chunk=chunk)
    y2, s2 = ssd_ops.ssd_scan(*args, chunk=chunk)
    py, ps = ssd_ops.ssd_scan(*args, chunk=chunk, impl="chunked")
    ry, rs = ssd_ops.ssd_scan(*args, chunk=chunk, impl="ref")
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2)  # no float atomics
    assert y.dtype == dtype and s.dtype == torch.float32
    if dtype == torch.float32:
        for want_y, want_s in ((py, ps), (ry, rs)):
            torch.testing.assert_close(y, want_y, atol=3e-4, rtol=0)
            torch.testing.assert_close(s, want_s, atol=3e-4, rtol=0)
    else:
        assert bool(((y.float() - py.float()).abs()
                     <= 2e-2 * (1 + py.float().abs())).all())
        torch.testing.assert_close(s, ps, atol=3e-4, rtol=0)


TC_CASES = [(16, 512, 64, 64, 1, 128, 128),  # mamba2-1.3b serving
            (16, 512, 64, 64, 1, 64, 128),   # zamba2-1.2b serving
            (2, 256, 6, 64, 2, 128, 64),     # chunk 64, two groups
            (1, 256, 8, 64, 2, 64, 64),
            (2, 192, 3, 64, 1, 64, 128),     # an odd head count per group
            (2, 500, 8, 64, 1, 128, 128)]    # a length that pads


@pytest.mark.parametrize("case", TC_CASES)
def test_ssd_tc_kernel_matches_plain_and_counts(cuda_device, case):
    """bf16 at the models' shapes runs on the tensor-core kernel: each
    call is one launch on both counters, the same bits twice, y within 2e-2
    relative and the state within 3e-4 of the plain chunked version; f32
    at the same shape stays on the plain-FMA kernel."""
    gen = torch.Generator().manual_seed(sum(case) + 1)
    chunk = case[-1]
    args = _ssd_inputs(gen, case, torch.bfloat16, cuda_device)
    before = (ssd_ops.ssd_scan.launches, ssd_ops.ssd_scan.tc_launches)
    y, s = ssd_ops.ssd_scan(*args, chunk=chunk)
    y2, s2 = ssd_ops.ssd_scan(*args, chunk=chunk)
    py, ps = ssd_ops.ssd_scan(*args, chunk=chunk, impl="chunked")
    torch.cuda.synchronize()
    assert (ssd_ops.ssd_scan.launches, ssd_ops.ssd_scan.tc_launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert bool(((y.float() - py.float()).abs()
                 <= 2e-2 * (1 + py.float().abs())).all())
    torch.testing.assert_close(s, ps, atol=3e-4, rtol=0)
    f32 = [t.float() if t.dtype == torch.bfloat16 else t for t in args]
    tc = ssd_ops.ssd_scan.tc_launches
    ssd_ops.ssd_scan(*f32, chunk=chunk)
    assert ssd_ops.ssd_scan.tc_launches == tc


def test_ssd_tc_and_plain_fma_kernels_agree(cuda_device):
    """The two kernels on the same bf16 inputs (the smoke times both)."""
    gen = torch.Generator().manual_seed(8)
    args = _ssd_inputs(gen, TC_CASES[0], torch.bfloat16, cuda_device)
    y, s = ssd_ops._ssd_scan_cuda(*args, 128)
    ys, ss = ssd_ops._ssd_scan_cuda(*args, 128, kernel="simt")
    assert bool(((y.float() - ys.float()).abs()
                 <= 2e-2 * (1 + ys.float().abs())).all())
    torch.testing.assert_close(s, ss, atol=3e-4, rtol=0)
    with pytest.raises(ValueError, match="does not take"):
        ssd_ops._ssd_scan_cuda(*[t.float() if t.dtype == torch.bfloat16
                                 else t for t in args], 128, kernel="tc")


def test_ssd_tc_kernel_overflowing_decays_give_no_nan(cuda_device):
    gen = torch.Generator().manual_seed(6)
    args = _ssd_inputs(gen, (2, 256, 8, 64, 1, 128, 128), torch.bfloat16,
                       cuda_device, A=-64.0, dt=0.1)
    tc = ssd_ops.ssd_scan.tc_launches
    y, s = ssd_ops.ssd_scan(*args, chunk=128)
    py, ps = ssd_ops.ssd_scan(*args, chunk=128, impl="chunked")
    assert ssd_ops.ssd_scan.tc_launches == tc + 1
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    assert bool(((y.float() - py.float()).abs()
                 <= 2e-2 * (1 + py.float().abs())).all())
    torch.testing.assert_close(s, ps, atol=3e-4, rtol=0)


def test_ssd_kernel_overflowing_decays_give_no_nan(cuda_device):
    gen = torch.Generator().manual_seed(3)
    args = _ssd_inputs(gen, (2, 256, 4, 64, 1, 128, 128), torch.float32,
                       cuda_device, A=-64.0, dt=0.1)
    y, s = ssd_ops.ssd_scan(*args, chunk=128)
    py, ps = ssd_ops.ssd_scan(*args, chunk=128, impl="chunked")
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, py, atol=3e-4, rtol=0)
    torch.testing.assert_close(s, ps, atol=3e-4, rtol=0)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    gen = torch.Generator().manual_seed(4)
    x, dt, A, B, C = _ssd_inputs(gen, (1, 64, 4, 16, 1, 8, 16),
                                 torch.float32, cuda_device)
    wide = torch.zeros((1, 64, 1, 16), device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x, dt, A, wide, C, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):  # even where it pads
        ssd_ops.ssd_scan(x[:, :60], dt[:, :60], A, wide[:, :60], C[:, :60],
                         chunk=16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_ops.ssd_scan(x.half(), dt, A, B.half(), C.half(), chunk=16)
    with pytest.raises(TypeError, match="dt"):
        ssd_ops.ssd_scan(x, dt.double(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="shared memory"):  # p = 128
        ssd_ops.ssd_scan(torch.zeros((1, 64, 4, 128), device=cuda_device),
                         dt, A, B, C, chunk=16)


def test_ssd_wrapper_raises_when_the_library_fails_to_load(cuda_device,
                                                           monkeypatch):
    from repro_torch.kernels import _build

    def broken(name):
        raise OSError(f"cannot load {name}")
    monkeypatch.setattr(ssd_ops, "_lib", None)
    monkeypatch.setattr(_build, "load_library", broken)
    gen = torch.Generator().manual_seed(5)
    args = _ssd_inputs(gen, (1, 64, 4, 16, 1, 8, 16), torch.float32,
                       cuda_device)
    before = ssd_ops.ssd_scan.launches
    with pytest.raises(OSError, match="cannot load ssd_scan"):
        ssd_ops.ssd_scan(*args, chunk=16)  # no fallback to the plain version
    assert ssd_ops.ssd_scan.launches == before


def test_mamba2_serving_on_card_matches_plain_path(cuda_device, monkeypatch):
    """mamba2 at 2 layers (smoke widths, f32) serving 2 batches through
    ``BatchedServer`` on the card: the ssd_scan kernel runs once per layer
    per prefill, and the tokens equal those of the plain chunked scan on the
    card."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.core.traffic_curves import diurnal

    cfg = dataclasses.replace(get_config("mamba2_1_3b", smoke=True),
                              dtype="float32", num_layers=2)

    def run():
        server = serve.BatchedServer(cfg, batch_size=3, prompt_len=40,
                                     decode_tokens=6, max_len=47,
                                     device=cuda_device)
        serve.run_trace(server, requests=6, prompt_len=40,
                        vocab_size=cfg.vocab_size, curve=diurnal(),
                        interval=60.0)
        return {r.request_id: r.tokens for r in server.report().records}

    before = ssd_ops.ssd_scan.launches
    kernel = run()
    assert ssd_ops.ssd_scan.launches == before + 2 * 2
    scan = mamba2.ssd_scan
    monkeypatch.setattr(mamba2, "ssd_scan",
                        lambda *a, impl="auto", **kw: scan(*a, impl="chunked",
                                                           **kw))
    plain = run()
    assert ssd_ops.ssd_scan.launches == before + 2 * 2
    assert len(kernel) == 6 and kernel == plain


# --------------------------------------------------------------------------
# slice 6: cross-attention decode at full lengths, MoE dispatch, recycled
# update buffers

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_at_full_source_lengths(cuda_device, dtype):
    """seamless-m4t-medium's cross-attention in decode: every length equals
    the 256 source frames; kernel against plain, bitwise repeatable."""
    b, s, h, kv, d = 16, 256, 16, 16, 64
    gen = torch.Generator().manual_seed(256)
    q = _randn(gen, (b, h, d), dtype, cuda_device)
    kc = _randn(gen, (b, s, kv, d), dtype, cuda_device)
    vc = _randn(gen, (b, s, kv, d), dtype, cuda_device)
    lens = torch.full((b,), s, dtype=torch.int32, device=cuda_device)
    before = decode_attention.launches
    a = decode_attention(q, kc, vc, lens)
    a2 = decode_attention(q, kc, vc, lens)
    plain = decode_attention(q, kc, vc, lens, impl="ref")
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(a, a2)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(a.float(), plain.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("tokens", [16, 16 * 48])
def test_moe_dispatch_on_card_equals_cpu(cuda_device, tokens):
    """granite-moe's MoE block at full width in f32 (TF32 off): the card
    routes every (token, k) pair to the CPU's expert and slot, at a decode
    step's 16 tokens (capacity 8: pairs drop) and at a prefill's; the
    output agrees within 1e-5 relative."""
    from repro_torch.models import moe

    cfg = get_config("granite_moe_3b_a800m")
    gen = torch.Generator().manual_seed(tokens)
    p = moe.moe_init(gen, cfg, torch.float32, "cpu")
    x = torch.randn((1, tokens, cfg.d_model), generator=gen)
    want = moe.route(p["router"], x[0], cfg)
    got = moe.route(p["router"].to(cuda_device), x[0].to(cuda_device), cfg)
    assert got.capacity == want.capacity
    assert torch.equal(got.expert.cpu(), want.expert)
    assert torch.equal(got.slot.cpu(), want.slot)
    if tokens == 16:
        assert int((want.slot == want.capacity).sum()) > 0  # drops
    torch.testing.assert_close(got.gate.cpu(), want.gate, atol=1e-6,
                               rtol=1e-6)
    out, aux = moe.moe_apply({k: v.to(cuda_device) for k, v in p.items()},
                             x.to(cuda_device), cfg)
    ref, ref_aux = moe.moe_apply(p, x, cfg)
    err = (out.cpu() - ref).abs().max() / ref.abs().max()
    assert float(err) <= 1e-5
    assert abs(float(aux) - float(ref_aux)) <= 1e-5 * float(ref_aux)


def test_recycled_rounds_equal_fresh_rounds_on_card(cuda_device):
    """``recycle_buffers=True`` on the card: the f32 rounds equal the
    fresh-storage rounds bitwise (params, aggregations, wire bytes)."""
    fresh = _round(cuda_device, "f32", False, rounds=3)
    recycled = _round(cuda_device, "f32", False, rounds=3, recycle=True)
    assert fresh[1:] == recycled[1:]
    for k in fresh[0]:
        np.testing.assert_array_equal(fresh[0][k], recycled[0][k])


def test_recycled_device_tier_chunk_writes_into_the_retired_leaves(
        cuda_device):
    """On the card the device tier's cast back to f32 writes a recycled
    chunk into the retired buffer's storage, with the fresh chunk's bits,
    and the caching allocator hands out at least that buffer's bytes
    fewer."""
    local = ctr.make_local_train_fn(lr=1e-2, epochs=2)
    tier = DeviceTier(local, GRADES["High"], device=cuda_device)
    gen = torch.Generator().manual_seed(5)
    params = {"w": (torch.randn(256, generator=gen) * 0.1).to(cuda_device),
              "b": torch.zeros((), device=cuda_device)}
    batch = {"x": torch.randn(512, 20, 256, generator=gen).to(cuda_device),
             "y": (torch.rand(512, 20, generator=gen) < 0.3).float()
             .to(cuda_device),
             "mask": torch.ones(512, 20, device=cuda_device)}
    seeds = torch.arange(512, dtype=torch.int64)
    want, _ = tier.run_cohort_zero_copy(params, batch, seeds)
    retired = type(want)([torch.zeros_like(l) for l in want.leaves2d],
                         want.keys, want.shapes, want.dtypes)

    def handed(run):
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
        out = run()
        torch.cuda.synchronize()
        return out, (torch.cuda.memory_stats()[
            "allocated_bytes.all.allocated"] - before)
    (fresh, _), fresh_bytes = handed(
        lambda: tier.run_cohort_zero_copy(params, batch, seeds))
    (got, _), got_bytes = handed(
        lambda: tier.run_cohort_zero_copy(params, batch, seeds,
                                          recycle=retired))
    for g, f, r in zip(got.leaves2d, fresh.leaves2d, retired.leaves2d):
        assert g.data_ptr() == r.data_ptr()
        assert torch.equal(g, f)
    assert fresh_bytes - got_bytes >= 512 * 257 * 4


def test_wrappers_record_the_shapes_they_launch_at(cuda_device):
    """With a set in ``.shapes``, each wrapper adds the shape of every
    launch (and nothing for a plain call)."""
    gen = torch.Generator().manual_seed(6)
    U = _randn(gen, (40, 24), torch.float32, cuda_device)
    w = torch.rand(40, generator=gen).to(cuda_device)
    q = _randn(gen, (2, 6, 64), torch.bfloat16, cuda_device)
    kc = _randn(gen, (2, 33, 2, 64), torch.bfloat16, cuda_device)
    lens = torch.tensor([5, 33], dtype=torch.int32, device=cuda_device)
    fq = _randn(gen, (2, 16, 6, 64), torch.bfloat16, cuda_device)
    fk = _randn(gen, (2, 24, 2, 64), torch.bfloat16, cuda_device)
    wrappers = (fed_reduce, decode_attention, flash_attention)
    for f in wrappers:
        f.shapes = set()
    try:
        fed_reduce(U, w)
        fed_reduce(U, w, impl="ref")
        decode_attention(q, kc, kc, lens)
        decode_attention(q, kc, kc, lens, impl="ref")
        flash_attention(fq, fk, fk, causal=False)
        flash_attention(fq, fk, fk, causal=True, q_offset=8, impl="ref")
        assert fed_reduce.shapes == {(40, 24, "float32")}
        assert decode_attention.shapes == {(2, 33, 6, 2, 64, "bfloat16")}
        assert flash_attention.shapes == {
            (2, 16, 24, 6, 2, 64, False, 0, "bfloat16")}
    finally:
        for f in wrappers:
            f.shapes = None


def test_moe_serving_run_on_card_under_sync_sanitizer(cuda_device):
    """granite-moe's smoke config serving on the card (f32) with the sync
    sanitizer armed: the MoE routing adds no host sync to ``step``, and
    the tokens equal the plain attention path's on the card."""
    import dataclasses

    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m", smoke=True),
                              dtype="float32")
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (5, 8))

    def run(attn_impl, attention_impl):
        c = dataclasses.replace(cfg, attention_impl=attention_impl)
        eng = ContinuousBatchingEngine(c, slots=3, prompt_len=8,
                                       decode_tokens=4, seed=0,
                                       attn_impl=attn_impl,
                                       device=cuda_device)
        for i in range(5):
            eng.submit(i, prompts[i], 0.0)
        t = 0.0
        with sanitizers.override(True):
            while eng.has_work:
                t += eng.step(t)
        return {r.request_id: r.tokens for r in eng.report().records}

    assert run("auto", "auto") == run("ref", "einsum")


# --------------------------------------------------------------------------
# slice 7: pooled rounds (worker processes on the card) and scheduled rounds

N_POOL, RPD_POOL, DIM_POOL = 24, 8, 16


def make_pool_tiers(device="cuda"):
    """Module-level so spawned workers can unpickle it by reference."""
    local = ctr.make_local_train_fn(lr=1e-2, epochs=2)
    return (LogicalTier(local, cohort_size=4, device=device),
            {"High": DeviceTier(local, GRADES["High"], seed=7,
                                cohort_size=4, device=device)})


def _pool_world(device, wire, workers, rounds=2, stream=False):
    from repro_torch.runtime.workers import WorkerSpec

    data = make_federated_ctr(num_devices=N_POOL, records_per_device=RPD_POOL,
                              dim=DIM_POOL, seed=0)
    X, Y, counts = data.stacked_shards(np.arange(N_POOL), RPD_POOL)
    mask = (np.arange(RPD_POOL)[None] < counts[:, None]).astype(np.float32)
    batches = {k: torch.from_numpy(v).to(device)
               for k, v in (("x", X), ("y", Y), ("mask", mask))}
    svc = AggregationService(
        ctr.lr_init(DIM_POOL, device=device),
        trigger=SampleThresholdTrigger(int(counts.sum())), streaming=stream)
    seen = []

    def sink(d):
        buf = d.batch.buffer if d.batch is not None else None
        if buf is not None:
            seen.append({leaf.device.type for leaf in buf.leaves2d})
        svc(d)

    flow = DeviceFlow(sink)
    flow.register_task(0, AccumulatedStrategy(thresholds=(1,)))
    logical, tiers = make_pool_tiers(str(device))
    kw = ({} if not workers else dict(
        workers=workers, worker_spec=WorkerSpec(make_pool_tiers,
                                                {"device": str(device)})))
    before = fed_reduce.launches
    with HybridSimulation(logical, tiers=tiers, deviceflow=flow, wire=wire,
                          stream_chunks=stream, **kw) as sim:
        with sanitizers.override(True):
            for rnd in range(rounds):
                sim.run_round(0, rnd, svc.global_params, batches, counts, 10,
                              torch.Generator().manual_seed(rnd))
                flow.run(1e12)
                svc.tick(flow.clock.now)
        stats = None if sim.pool is None else dict(sim.pool.stats)
    shelf = flow.shelf(0)
    return {"params": {k: v.cpu() for k, v in svc.global_params.items()},
            "bytes": (shelf.total_bytes_received,
                      shelf.total_bytes_dispatched),
            "aggregations": len(svc.history),
            "launches": fed_reduce.launches - before, "stats": stats,
            "devices": seen}


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_pooled_round_on_card_equals_inline_bitwise(cuda_device, wire):
    """Two workers on the card (each its own CUDA context) against the
    inline rounds at 24 devices: params bitwise, bytes, aggregations and
    ``fed_reduce`` launches equal; the inline rounds ran under the sync
    sanitizer."""
    inline = _pool_world(cuda_device, wire, 0)
    pooled = _pool_world(cuda_device, wire, 2)
    for k in inline["params"]:
        assert torch.equal(inline["params"][k], pooled["params"][k]), k
    for key in ("bytes", "aggregations", "launches"):
        assert inline[key] == pooled[key], key
    assert pooled["launches"] > 0 and pooled["stats"]["chunks"] == 14


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_pooled_streamed_round_on_card_equals_inline_bitwise(cuda_device,
                                                            wire):
    """Streamed pooled rounds (``stream_chunks=True`` into a streaming
    service) emit in chunk order, so they equal the inline streamed rounds
    bitwise, with equal ``fed_reduce`` launches."""
    inline = _pool_world(cuda_device, wire, 0, stream=True)
    pooled = _pool_world(cuda_device, wire, 2, stream=True)
    for k in inline["params"]:
        assert torch.equal(inline["params"][k], pooled["params"][k]), k
    for key in ("bytes", "aggregations", "launches"):
        assert inline[key] == pooled[key], key
    assert pooled["launches"] > 0 and pooled["stats"]["chunks"] == 14


def test_pooled_buffer_leaves_reach_aggregation_on_the_card(cuda_device):
    """A pooled chunk's leaves are copied onto the card before they enter
    DeviceFlow, so aggregation launches the kernel, never the CPU path."""
    pooled = _pool_world(cuda_device, "int8", 2, rounds=1)
    assert pooled["devices"] and all(d == {"cuda"}
                                     for d in pooled["devices"])
    assert pooled["launches"] > 0


def _scheduled(device):
    """Three tasks through one preemptive, elastic engine with real rounds
    (the pattern of the reference's ``launch/train.py --tasks``): one
    streaming service per task behind a task router."""
    from repro_torch.core import (ClientCountTrigger, ResourceManager,
                                  ResourcePool, TaskEngine)
    from repro_torch.core.task import OperatorFlow, Task

    n, rpd, dim = 8, 4, 16
    local = ctr.make_local_train_fn(lr=1e-2, epochs=2)
    cal = RuntimeCalibrator()
    tasks = [Task(OperatorFlow(("train",)),
                  (GradeSpec("High", n, logical_bundles=4,
                             physical_devices=2),),
                  rounds=2, priority=prio, task_id=tid)
             for tid, prio in ((0, 0), (1, 0), (2, 5))]
    svcs = {}
    flow = DeviceFlow(lambda d: svcs[d.task_id](d))
    for t in tasks:
        flow.register_task(t.task_id, AccumulatedStrategy(thresholds=(1,)))
        svcs[t.task_id] = AggregationService(
            ctr.lr_init(dim, device=device), trigger=ClientCountTrigger(n),
            streaming=True)
    sim = HybridSimulation(
        LogicalTier(local, cohort_size=4, device=device),
        tiers={"High": DeviceTier(local, GRADES["High"], cohort_size=4,
                                  device=device)},
        deviceflow=flow, stream_chunks=True)

    def round_runner(t, round_idx, allocation, now):
        rng = np.random.default_rng(100 * t.task_id + round_idx)
        x = rng.standard_normal((n, rpd, dim)).astype(np.float32)
        y = (rng.random((n, rpd)) < 0.3).astype(np.float32)
        batches = {"x": torch.from_numpy(x).to(device),
                   "y": torch.from_numpy(y).to(device),
                   "mask": torch.ones(n, rpd, device=device)}
        plan = RoundPlan.from_allocation(allocation, t.grades)
        svc = svcs[t.task_id]
        out = sim.run_plan_round(
            t.task_id, round_idx, svc.global_params, plan, {"High": batches},
            {"High": np.full(n, rpd)},
            torch.Generator().manual_seed(1000 * t.task_id + round_idx),
            calibrator=cal)
        return out.makespan_s

    rm = ResourceManager(ResourcePool({"High": 8}, {"High": 4}))
    eng = TaskEngine(rm, cal, round_runner=round_runner, clock=flow.clock,
                     elastic=True, preemptive=True)
    eng.submit(tasks[0])
    eng.submit(tasks[1])
    eng.submit(tasks[2], at=1.0)
    eng.run_until()
    tl = {tid: (ex.started_t, ex.finished_t, ex.rounds_done, ex.preemptions,
                ex.reallocations, [dict(d) for d in ex.preemption_decisions])
          for tid, ex in sorted(eng.executions.items())}
    assert all(len(s.history) == 2 for s in svcs.values())
    return tl, eng.makespan, {tid: ctr.params_to_numpy(s.global_params)
                              for tid, s in svcs.items()}


def test_scheduled_rounds_on_card_match_the_cpu_timeline(cuda_device):
    """A preemptive, elastic ``TaskEngine`` driving real rounds of three
    tasks on the card gives the CPU run's timeline exactly; every task's
    params moved from their zero init and agree within 1e-6 absolute,
    the round cross-check's tolerance (phases 3 and 13)."""
    gpu_tl, gpu_mk, gpu_p = _scheduled(cuda_device)
    cpu_tl, cpu_mk, cpu_p = _scheduled(torch.device("cpu"))
    assert gpu_tl == cpu_tl and gpu_mk == cpu_mk
    assert any(v[3] for v in gpu_tl.values())  # a victim was preempted
    for tid in gpu_p:
        assert max(np.abs(v).max() for v in gpu_p[tid].values()) > 1e-4, tid
        for k in gpu_p[tid]:
            np.testing.assert_allclose(gpu_p[tid][k], cpu_p[tid][k],
                                       atol=1e-6, rtol=0)


# (b, sq, sk, h, kv, d, causal, q_offset): the smoke width (g = 3 at d =
# 16), granite's g = 3 at d = 64, llama's d = 128 with a ragged tail,
# non-causal cross-attention (sq != sk), a query offset, and causal keys
# that no query sees (their dK and dV are exact zeros).
BWD_CASES = [
    (2, 64, 64, 6, 2, 16, True, 0),
    (2, 130, 130, 12, 4, 128, True, 0),
    (2, 96, 96, 6, 2, 64, True, 0),
    (1, 64, 256, 4, 4, 64, False, 0),
    (2, 96, 200, 6, 2, 64, True, 104),
    (1, 200, 200, 4, 1, 32, True, 0),
    (1, 64, 320, 6, 2, 128, True, 0),
]


def _bwd_inputs(case, dtype, device):
    b, sq, sk, h, kv, d, causal, off = case
    gen = torch.Generator().manual_seed(sq * 7 + sk + h + d)
    q = _randn(gen, (b, sq, h, d), dtype, device)
    k = _randn(gen, (b, sk, kv, d), dtype, device)
    v = _randn(gen, (b, sk, kv, d), dtype, device)
    do = _randn(gen, (b, sq, h, d), dtype, device)
    return q, k, v, do


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_matches_plain_and_repeats(cuda_device, case, dtype):
    """The backward kernels (K3b) against ``attention_bwd_ref`` on the card,
    from the forward kernel's own o and lse; two calls give the same bits
    and each counts one backward launch."""
    from repro_torch.kernels.flash_attention import ops

    b, sq, sk, h, kv, d, causal, off = case
    q, k, v, do = _bwd_inputs(case, dtype, cuda_device)
    scale = d ** -0.5
    o, lse = ops._flash_attention_cuda(q, k, v, causal, off, scale,
                                       with_lse=True)
    o_ref, lse_ref = ops.attention_fwd_lse(q, k, v, causal=causal,
                                           q_offset=off)
    before = flash_attention.bwd_launches
    wgmma_before = flash_attention.wgmma_bwd_launches
    got = ops._flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, off,
                                        scale)
    again = ops._flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, off,
                                          scale)
    plain = ops.attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                  q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.bwd_launches == before + 2
    # bf16 at d = 64, 128 on wgmma; the rest on plain FMAs.
    on_tensor_cores = dtype == torch.bfloat16 and d in (64, 128)
    assert flash_attention.wgmma_bwd_launches == wgmma_before + (
        2 if on_tensor_cores else 0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    for name, a, a2, p in zip(("dq", "dk", "dv"), got, again, plain):
        assert a.dtype == dtype and a.shape == p.shape, name
        assert torch.equal(a, a2), f"{name} is not bitwise repeatable"
        torch.testing.assert_close(a.float(), p.float(), atol=tol, rtol=tol,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_flash_attention_vmap_grad_on_card_equals_a_loop(cuda_device):
    """``vmap(grad(...))`` through ``FlashAttention`` folds the vmapped
    dimension into the kernels' batch: equal to per-sample grads."""
    from torch.func import grad, vmap

    from repro_torch.kernels.flash_attention.ops import FlashAttention

    gen = torch.Generator().manual_seed(5)
    n, b, s, h, kv, d = 3, 2, 80, 6, 2, 16
    q = _randn(gen, (n, b, s, h, d), torch.float32, cuda_device)
    k = _randn(gen, (n, b, s, kv, d), torch.float32, cuda_device)
    v = _randn(gen, (n, b, s, kv, d), torch.float32, cuda_device)

    def loss(q, k, v):
        return (FlashAttention.apply(q, k, v, True, 0, d ** -0.5)[0]
                ** 2).sum()

    before = (flash_attention.launches, flash_attention.bwd_launches)
    batched = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    for i in range(n):
        one = grad(loss, argnums=(0, 1, 2))(q[i], k[i], v[i])
        for a, b_ in zip(batched, one):
            torch.testing.assert_close(a[i], b_, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", [c for c in BWD_CASES if c[5] in (64, 128)])
def test_flash_bwd_wgmma_kernels_agree_with_plain_fma(cuda_device, case):
    """bf16: the wgmma backward (the route, dQ summed across key tiles in
    the fused kernel) against the plain-FMA backward on the same inputs
    (2e-2); each call counts on its own kernel's counter."""
    from repro_torch.kernels.flash_attention import ops

    b, sq, sk, h, kv, d, causal, off = case
    q, k, v, do = _bwd_inputs(case, torch.bfloat16, cuda_device)
    o, lse = ops._flash_attention_cuda(q, k, v, causal, off, d ** -0.5,
                                       with_lse=True)
    before = (flash_attention.bwd_launches,
              flash_attention.wgmma_bwd_launches)
    wg = ops._flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, off,
                                       d ** -0.5)
    ref = ops._flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, off,
                                        d ** -0.5, kernel="simt")
    torch.cuda.synchronize()
    assert (flash_attention.bwd_launches,
            flash_attention.wgmma_bwd_launches) == (before[0] + 2,
                                                    before[1] + 1)
    for name, a, b_ in zip(("dq", "dk", "dv"), wg, ref):
        torch.testing.assert_close(a.float(), b_.float(), atol=2e-2,
                                   rtol=2e-2,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_flash_bwd_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import ops

    q = torch.zeros(1, 8, 4, 256, device=cuda_device)
    lse = torch.zeros(1, 4, 8, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops._flash_attention_bwd_cuda(q, q, q, q, lse, q, True, 0, 1.0)
    q = q[..., :64].contiguous()
    with pytest.raises(ValueError, match="lse"):
        ops._flash_attention_bwd_cuda(q, q, q, q, lse[..., :4], q, True, 0,
                                      1.0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_train_step_kernel_path_matches_plain_path_on_card(cuda_device, dtype,
                                                           tol):
    """Two ``build_train_step`` steps of a 2-layer model (GQA g = 3 at d =
    16 and d = 64): the flash kernels' path against the plain attention
    path (``attention_impl="einsum"``), both on the card.  Loss and grad
    norm, every updated leaf and each leaf's first-step gradient (AdamW's
    first moment after one step: the updated leaves move ~3 % in 2 steps,
    and Adam's near-sign steps hide the gradients' magnitude) agree within
    ``tol`` relative; the kernel path launches one backward per layer and
    microbatch."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution.steps import (
        build_train_step,
        init_train_state,
    )
    from repro_torch.optim.optimizers import AdamWConfig, tree_leaves

    shape = ShapeConfig("t", 128, 4, "train", microbatches=2)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 512, (2, 2, 128)).astype(np.int32),
                "targets": rng.integers(0, 512, (2, 2, 128)).astype(np.int32),
                "mask": np.ones((2, 2, 128), np.float32)} for _ in range(2)]
    for head_dim in (16, 64):
        cfg = dataclasses.replace(get_config("llama3_2_3b", smoke=True),
                                  dtype=dtype, head_dim=head_dim)
        runs = {}
        for path, c in (("kernel", cfg), ("plain", dataclasses.replace(
                cfg, attention_impl="einsum"))):
            state = init_train_state(c, seed=0, device=cuda_device)
            step, _, _ = build_train_step(c, None, shape,
                                          AdamWConfig(warmup_steps=1))
            before = flash_attention.bwd_launches
            metrics, grads = [], None
            for b in batches:
                state, m = step(state, {k: torch.from_numpy(v).to(cuda_device)
                                        for k, v in b.items()})
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
                if grads is None:
                    grads = [t.clone() for t in tree_leaves(state["opt"]["m"])]
            torch.cuda.synchronize()
            runs[path] = (metrics, tree_leaves(state["params"]), grads,
                          flash_attention.bwd_launches - before)
        (mk, pk, gk, nk), (mp, pp, gp, np_) = runs["kernel"], runs["plain"]
        assert nk == 2 * 2 * 2 and np_ == 0
        np.testing.assert_allclose(mk, mp, rtol=tol)
        for a, b in (*zip(pk, pp), *zip(gk, gp)):
            err = float((a.float() - b.float()).norm() / b.float().norm())
            assert err <= tol


# --------------------------------------------------------------------------
# slice 10: the SSD scan's backward (K4b) and SSM training on the card

SSD_BWD_CASES = SSD_CASES + [(1, 4096, 64, 64, 1, 128, 128),  # mamba2 train
                             (1, 4096, 64, 64, 1, 64, 128)]   # zamba2 train


def _rel_to_max(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_matches_plain_and_repeats(cuda_device, case, dtype):
    """The backward kernels against ``ssd_bwd_ref`` on the card, with a
    nonzero cotangent of the final state: dx, ddt, dA, dB, dC within 3e-4
    (f32) or 2e-2 (bf16) of the plain version's largest entry, in their
    dtypes, two calls bitwise equal, one backward launch each, on the
    tensor-core route for bf16 at the models' shapes (the training shapes
    among them) and on the plain-FMA route otherwise."""
    gen = torch.Generator().manual_seed(sum(case) + 2)
    args = _ssd_inputs(gen, case, dtype, cuda_device)
    b, l, h, p, g, n, chunk = case
    dy = _randn(gen, (b, l, h, p), dtype, cuda_device)
    ds = _randn(gen, (b, h, p, n), torch.float32, cuda_device)
    tc = ssd_ops.kernel_for_bwd(dtype, p, n, chunk) == "tc"
    before = (ssd_ops.ssd_scan.bwd_launches, ssd_ops.ssd_scan.tc_bwd_launches)
    got = ssd_ops._ssd_scan_bwd_cuda(*args, dy, ds, chunk)
    again = ssd_ops._ssd_scan_bwd_cuda(*args, dy, ds, chunk)
    plain = ssd_ops.ssd_bwd_ref(*args, dy, ds, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd_ops.ssd_scan.bwd_launches, ssd_ops.ssd_scan.tc_bwd_launches
            ) == (before[0] + 2, before[1] + (2 if tc else 0))
    tol = 3e-4 if dtype == torch.float32 else 2e-2
    for name, a, a2, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again,
                              plain):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, a2), f"{name} is not bitwise repeatable"
        assert _rel_to_max(a, w) <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_overflowing_decays_give_no_nan(cuda_device, dtype):
    """A = -64, dt = 0.1: every gradient finite; dx, dB and dC, which no
    cancellation touches, within the limits of the case above; bf16 on the
    tensor-core route."""
    case = (2, 256, 8, 64, 1, 128, 128)
    gen = torch.Generator().manual_seed(64)
    args = _ssd_inputs(gen, case, dtype, cuda_device, A=-64.0, dt=0.1)
    dy = _randn(gen, (2, 256, 8, 64), dtype, cuda_device)
    tc = ssd_ops.ssd_scan.tc_bwd_launches
    got = ssd_ops._ssd_scan_bwd_cuda(*args, dy, None, 128)
    plain = ssd_ops.ssd_bwd_ref(*args, dy, None, chunk=128)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_scan.tc_bwd_launches == tc + (
        dtype == torch.bfloat16)
    tol = 3e-4 if dtype == torch.float32 else 2e-2
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, plain):
        assert bool(torch.isfinite(a.float()).all()), name
        if name in ("dx", "dB", "dC"):
            assert _rel_to_max(a, w) <= tol, name


@pytest.mark.parametrize("case", [c for c in SSD_BWD_CASES
                                  if c[3] == 64 and c[5] in (64, 128)
                                  and c[6] in (64, 128)])
def test_ssd_bwd_tc_and_plain_fma_routes_agree(cuda_device, case):
    """On the same bf16 inputs the tensor-core route and the plain-FMA
    route give each gradient within 2e-2 of the plain-FMA one's largest
    entry."""
    gen = torch.Generator().manual_seed(sum(case) + 5)
    args = _ssd_inputs(gen, case, torch.bfloat16, cuda_device)
    b, l, h, p, g, n, chunk = case
    dy = _randn(gen, (b, l, h, p), torch.bfloat16, cuda_device)
    ds = _randn(gen, (b, h, p, n), torch.float32, cuda_device)
    assert ssd_ops.kernel_for_bwd(torch.bfloat16, p, n, chunk) == "tc"
    tc = ssd_ops._ssd_scan_bwd_cuda(*args, dy, ds, chunk)
    simt = ssd_ops._ssd_scan_bwd_cuda(*args, dy, ds, chunk, kernel="simt")
    torch.cuda.synchronize()
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), tc, simt):
        assert _rel_to_max(a, w) <= 2e-2, name


def test_ssd_scan_vmap_grad_on_card_equals_a_loop(cuda_device):
    """``vmap(grad(...))`` through ``SsdScan`` with A shared and the data
    batched (the federated clients' pattern) folds the vmapped dimension
    into the heads: one forward and one backward launch, equal to the
    per-sample grads."""
    from torch.func import grad, vmap

    gen = torch.Generator().manual_seed(7)
    n, case = 3, (2, 100, 4, 16, 2, 16, 32)
    x, dt, A, B, C = _ssd_inputs(gen, case, torch.float32, cuda_device)
    xs, dts, Bs, Cs = (torch.stack([t * (1 + 0.1 * i) for i in range(n)])
                       for t in (x, dt, B, C))

    def loss(A, x, dt, B, C):
        y, s = ssd_ops.SsdScan.apply(x, dt, A, B, C, 32, "auto")
        return (y ** 2).sum() + s.sum()

    argnums = (0, 1, 2, 3, 4)
    before = (ssd_ops.ssd_scan.launches, ssd_ops.ssd_scan.bwd_launches)
    batched = vmap(grad(loss, argnums=argnums),
                   in_dims=(None, 0, 0, 0, 0))(A, xs, dts, Bs, Cs)
    torch.cuda.synchronize()
    assert (ssd_ops.ssd_scan.launches, ssd_ops.ssd_scan.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    for i in range(n):
        one = grad(loss, argnums=argnums)(A, xs[i], dts[i], Bs[i], Cs[i])
        for a, w in zip(batched, one):
            torch.testing.assert_close(a[i], w, atol=1e-6, rtol=1e-5)


def test_ssd_bwd_rejects_what_it_does_not_take(cuda_device):
    gen = torch.Generator().manual_seed(3)
    case = (1, 64, 2, 128, 1, 16, 32)
    x, dt, A, B, C = _ssd_inputs(gen, case, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        ssd_ops._ssd_scan_bwd_cuda(x, dt, A, B, C, x, None, 32)  # p > 64
    x, dt, A, B, C = _ssd_inputs(gen, (1, 64, 2, 16, 1, 16, 32),
                                 torch.float16, cuda_device)
    with pytest.raises(TypeError):
        ssd_ops._ssd_scan_bwd_cuda(x, dt, A, B, C, x, None, 32)
    x, dt, A, B, C = _ssd_inputs(gen, (1, 64, 2, 16, 1, 16, 32),
                                 torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dy"):
        ssd_ops._ssd_scan_bwd_cuda(x, dt, A, B, C, x.transpose(1, 2), None,
                                   32)


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_1_2b"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_ssm_train_step_kernel_path_matches_plain_path_on_card(
        cuda_device, arch, dtype, tol):
    """Two ``build_train_step`` steps of the smoke SSM and hybrid models:
    the kernels' path (the scan's forward and backward kernels, and for
    zamba2 the flash kernels) against the plain path
    (``attention_impl="einsum"``: the plain scan, its written-out backward
    and the plain attention), both on the card.  Loss and grad norm
    within ``tol`` relative, and the first-step gradients: each leaf's in
    f32; in bf16 all leaves' together (at this width a leaf with a small
    gradient, A_log or dt_bias, sums terms that cancel, and bf16 rounding
    in the activations moves it by a few percent; ``chip_smoke.py`` phase
    19 holds each leaf at full width).  The kernel path launches one scan
    backward per layer and microbatch."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution.steps import (
        build_train_step,
        init_train_state,
    )
    from repro_torch.optim.optimizers import AdamWConfig, tree_leaves

    shape = ShapeConfig("t", 128, 4, "train", microbatches=2)
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, 512, (2, 2, 128)).astype(np.int32),
                "targets": rng.integers(0, 512, (2, 2, 128)).astype(np.int32),
                "mask": np.ones((2, 2, 128), np.float32)} for _ in range(2)]
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    runs = {}
    for path, c in (("kernel", cfg), ("plain", dataclasses.replace(
            cfg, attention_impl="einsum"))):
        state = init_train_state(c, seed=0, device=cuda_device)
        step, _, _ = build_train_step(c, None, shape,
                                      AdamWConfig(warmup_steps=1))
        before = ssd_ops.ssd_scan.bwd_launches
        metrics, grads = [], None
        for b in batches:
            state, m = step(state, {k: torch.from_numpy(v).to(cuda_device)
                                    for k, v in b.items()})
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
            if grads is None:
                grads = [t.clone() for t in tree_leaves(state["opt"]["m"])]
        torch.cuda.synchronize()
        runs[path] = (metrics, grads, ssd_ops.ssd_scan.bwd_launches - before)
    (mk, gk, nk), (mp, gp, np_) = runs["kernel"], runs["plain"]
    assert nk == cfg.num_layers * 2 * 2 and np_ == 0
    np.testing.assert_allclose(mk, mp, rtol=tol)
    if dtype == "bfloat16":
        gk, gp = ([torch.cat([t.float().flatten() for t in g])]
                  for g in (gk, gp))
    for a, b in zip(gk, gp):
        err = float((a.float() - b.float()).norm()
                    / b.float().norm().clamp_min(1e-30))
        assert err <= tol


# --------------------------------------------------------------------------- #
# The sharded paths on one NCCL rank (chip_smoke.py's phase 20, small)
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def nccl_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL has no CPU mode)")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield torch.device("cuda")
    if started:
        dist.destroy_process_group()


def _one_by_one(cfg):
    from repro_torch.configs.base import choose_mesh_plan
    from repro_torch.distribution.sharding import derive_logical_mesh
    from repro_torch.launch.mesh import make_host_mesh

    return derive_logical_mesh(make_host_mesh(1, 1, device="cuda"),
                               choose_mesh_plan(cfg, model_axis=1))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fed_reduce_on_a_fleet_mesh_equals_no_mesh(nccl_rank, dtype):
    from repro_torch.distribution.sharding import make_fleet_mesh

    dev = nccl_rank
    g = torch.Generator(device=dev).manual_seed(4)
    n, d = 1000, 256
    w = torch.rand(n, generator=g, device=dev)
    if dtype == "int8":
        stack = torch.randint(-127, 128, (n, d), generator=g, device=dev,
                              dtype=torch.int8)
        scales = torch.rand(n, generator=g, device=dev) / 127
    else:
        stack, scales = torch.randn((n, d), generator=g, device=dev), None
    want = fed_reduce(stack, w, scales=scales)
    fed_reduce.launches = 0
    got = fed_reduce(stack, w, scales=scales,
                     mesh=make_fleet_mesh(1, device=dev))
    assert fed_reduce.launches == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "granite_moe_3b_a800m"])
def test_sharded_train_step_on_one_rank_equals_unsharded(nccl_rank, arch):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution.steps import (build_train_step, gather,
                                                init_train_state,
                                                place_train_state)
    from repro_torch.optim.optimizers import tree_leaves

    dev = nccl_rank
    cfg = get_config(arch, smoke=True)
    shape = ShapeConfig("x", 128, 4, "train", microbatches=2)
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2, 128),
                                     generator=g, device=dev,
                                     dtype=torch.int32),
             "targets": torch.randint(0, cfg.vocab_size, (2, 2, 128),
                                      generator=g, device=dev,
                                      dtype=torch.int32),
             "mask": torch.ones((2, 2, 128), device=dev)}
    runs = []
    for lmesh in (None, _one_by_one(cfg)):
        state = init_train_state(cfg, seed=0, device=dev)
        if lmesh is not None:
            state = place_train_state(state, cfg, lmesh)
        step = build_train_step(cfg, lmesh, shape)[0]
        flash_attention.launches = flash_attention.bwd_launches = 0
        metrics = [step(state, batch)[1] for _ in range(2)]
        runs.append(([(float(m["loss"]), float(m["grad_norm"]))
                      for m in metrics],
                     [t.float() for t in tree_leaves(
                         gather(state["params"]))],
                     (flash_attention.launches, flash_attention.bwd_launches)))
    (m0, p0, l0), (m1, p1, l1) = runs
    assert m1 == m0 and l1 == l0 and l1[0] > 0 and l1[1] > 0
    for a, b in zip(p1, p0):
        assert torch.equal(a, b)


def test_sharded_serving_on_one_rank_equals_unsharded(nccl_rank):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution.steps import (build_prefill_step,
                                                build_serve_step,
                                                place_params)
    from repro_torch.models import transformer

    dev = nccl_rank
    cfg = get_config("llama3_2_3b", smoke=True)
    params = transformer.init(0, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), device=dev,
                            dtype=torch.int32,
                            generator=torch.Generator(device=dev)
                            .manual_seed(6))
    with torch.no_grad():
        want, cache = transformer.prefill(params, prompts, cfg, 72)
        tok = want[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        want2, _ = transformer.decode_step(params, tok, cfg, cache)
    lmesh = _one_by_one(cfg)
    shape = ShapeConfig("s", 72, 4, "decode")
    placed = place_params(params, cfg, lmesh)
    decode_attention.launches = 0
    got, cache = build_prefill_step(cfg, lmesh, shape)[0](placed, prompts)
    got2, _ = build_serve_step(cfg, lmesh, shape)[0](placed, cache, tok)
    assert decode_attention.launches == cfg.num_layers
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(got2.full_tensor(), want2)
