#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # from the root of a checkout
    python3 chip_smoke.py --profile       # where a federated round's time goes
    python3 chip_smoke.py --serving-only  # skip the federated-round phases
    python3 chip_smoke.py --ssm-only      # the SSD kernel and SSM serving only

All four kernels (``fed_reduce``, ``decode_attention``, ``flash_attention``
and ``ssd_scan``, the last three with tensor-core and plain-FMA paths) are
built first from ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a``, one
compiler per source, all at once; ptxas's registers and spills of the new
kernels and the tensor-core instructions in each library's SASS
(``cuobjdump``: HGMMA, HMMA) are printed.  Nine phases; any failure raises
and the script exits non-zero:

1. **Kernel.**  Runs ``fed_reduce`` on the card against its plain
   PyTorch version at every shape the slice's ``RoundPlan`` gives it: each
   distinct cohort-chunk row count (full 8192-row chunks and each ragged
   last chunk) x {the 256-wide ``w`` leaf, the 1-wide ``b`` leaf} x {f32,
   int8 with scales}, plus 8192 x 256 in bf16; zero weights included.
   Checks the error (<= 1e-4 of sum |w||U| per column), that two
   launches give the same bits and that a call is one kernel launch
   (``torch.profiler``), and times kernel, plain version,
   ``torch.mv`` (f32 only) and the HBM bound with CUDA events.
2. **Slice.**  The quickstart's federated CTR round (calibrate, allocate,
   ``HybridSimulation`` over DeviceFlow into ``AggregationService``) at the
   paper's size: 100 000 devices over two grades with the quickstart's one
   benchmarking device (q_i = 1) per grade, 20 records each, ``avazu_lr``
   at dim 256, cohorts of 8192 — 3 rounds on the f32 wire, then 3 on the
   int8 wire with error feedback.  The launch counter is zeroed before and
   read after, and must equal the (buffer, leaf) reductions the
   aggregations issued; every (rows, width, dtype) the aggregations reduced
   must be a shape the kernel phase checked; the test loss must fall every
   round.
3. **Cross-check.**  The same slice at 2 000 devices on the card and on the
   CPU (plain ``fed_reduce``): after every round the params agree within
   1e-6 absolute and the round's update within 1e-3 relative; aggregation
   counts, arrival times and shelf bytes are identical.
4. **Attention kernels.**  ``decode_attention`` and ``flash_attention`` on
   the card against their plain versions on the card, at the serving runs'
   shapes (llama3.2-3b decode: q (16, 24, 128) vs a (16, 577, 8, 128) bf16
   cache with ragged lengths including 0 and 577; prefill: q (16, 512, 24,
   128) vs k/v (16, 512, 8, 128), causal; zamba2-1.2b's shared block: q
   (16, 32, 64) vs a (16, 577, 32, 64) cache and (16, 512, 32, 64) causal)
   and at the reference test cases (``tests/test_kernels.py`` FLASH_CASES,
   DECODE_CASES) in f32 and bf16: error within 3e-5 (f32) / 2e-2 (bf16),
   exact zeros for empty slots, stale-KV invariance of a reused slot
   (1e-6), bitwise repeatability; bf16 at d = 64 and 128 runs on the
   tensor-core flash kernel, the rest on the plain-FMA one; a
   ``decode_attention`` call is one kernel (``torch.profiler``).  Times
   both decode shapes (llama's, also at the continuous engine's own
   occupancy: 3 busy slots of 16) and both prefill shapes (llama's and
   zamba2's) with CUDA events: kernel (and, for flash, the plain-FMA
   kernel on the same bf16 inputs), plain version,
   ``F.scaled_dot_product_attention`` (GQA; a boolean length mask for
   decode) as the library yardstick, and the bound.
5. **Serving slice.**  llama3.2-3b at full width (28 layers, d_model 3072,
   24 query / 8 KV heads, vocab 128256 padded to 129024) in bf16, params
   from ``transformer.init`` with a seeded CUDA generator: a 64-request
   ``diurnal`` trace, prompts of 512 tokens, 64 decode tokens each, through
   ``ContinuousServer(ContinuousBatchingEngine(slots=16))`` and then
   ``BatchedServer(batch_size=16)``.  Per mode: the virtual-time report
   (which must equal the same trace's CPU run), wall ms per prefill call
   and per decode iteration, decode tokens/s and peak device memory; the
   launch counters are zeroed before each mode and must read 28 per decode
   iteration (``decode_attention``) and 28 per prefill (``flash_attention``,
   every one on the tensor-core kernel) after it, at shapes phase 4
   checked; the continuous p99 must be >= 2x better than the fixed
   batch's.  A short profiled window gives the
   device's idle share.
6. **Serving cross-check.**  Full width at 2 layers, the same params and
   prompts: the kernel path against the plain path (``attention_impl=
   "einsum"``, decode ``impl="ref"``), both on the card, prefill then 16
   teacher-forced decode steps: last-position logits within 2e-2 relative
   in bf16 (greedy-token agreement printed, not gated), and within 1e-4
   with identical greedy tokens in f32.
7. **SSD kernel.**  ``ssd_scan`` on the card against its chunked plain
   version and the sequential oracle on the card, in f32 and with bf16 x,
   B and C: the reference's SSD_CASES, both serving shapes (mamba2-1.3b
   (16, 512, 64 heads of 64, 1 group, state 128) and zamba2-1.2b (state
   64), chunk 128), a length that pads (500) and decays that overflow above
   the diagonal (A = -64, dt = 0.1).  y and the state within 3e-4 absolute
   in f32, y within 2e-2 relative in bf16, no NaN, two launches bitwise
   equal; bf16 at the models' shapes runs on the tensor-core kernel, the
   rest on the plain-FMA one.  Times the serving shapes (inputs cycled past
   the L2): kernel, the plain-FMA kernel on the same bf16 inputs, plain
   version and the bound; no PyTorch op computes the scan.
8. **SSM serving.**  mamba2-1.3b and then zamba2-1.2b at full width in
   bf16, params from each model's ``init`` with a seeded CUDA generator,
   the same trace through ``BatchedServer(batch_size=16)`` (the continuous
   engine's arena holds attention K/V only).  Per model: the report (equal
   to the CPU run's with the smoke-size model), wall ms per prefill and
   decode iteration, decode tokens/s, peak memory; launch counters zeroed
   before and read after: one ``ssd_scan`` per layer per prefill (48 x 4,
   38 x 4), every one on the tensor-core kernel, and for zamba2 one
   tensor-core ``flash_attention`` per shared-block application per
   prefill (7 x 4) and one ``decode_attention`` per application per
   decode step (7 x 256), at shapes phases 4 and 7 checked; a profiled
   window (1 prefill + 20 decode steps) gives the idle share and shows
   each counted scan and decode call as one kernel.
9. **SSM cross-check.**  Each model at full width and 2 layers (zamba2 with
   its shared block at layer 0): the kernel path against the plain path
   (``block_prefill(impl="chunked")`` layer by layer; for zamba2's
   attention ``attention_impl="einsum"``), both on the card, prefill then
   16 teacher-forced decode steps: logits within 2e-2 relative in bf16
   (agreement printed), within 1e-4 with identical greedy tokens in f32.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit from ``nvidia-smi``, and before that one JSON
line with the kernels' numbers (each kernel's launches summed over the
main paths that ran it, each path's counter read just after it).

``--compare-with DIR`` times the decode and scan kernels of the checkout at
DIR (e.g. the parent commit, unpacked by ``git archive``) against this
checkout's at the serving shapes, in turns (DIR, this, this, DIR), each in
its own process and build, and prints one ``{"kernel_ab": ...}`` line per
run.  ``--profile`` runs the federated slice alone instead: per wire, round 1
under ``torch.profiler`` (device busy time as the union of kernel
intervals, device idle share, device time by kernel) and round 2 under
``cProfile`` (host time by function).  It prints one JSON line per profiled
round and writes the full tables and a Chrome trace of the f32 round under
``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at the 700 W limit
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2**20
RECORDS = 20  # paper: 2 M records over 100 000 devices
COHORT = 8192
LEAF_WIDTHS = (256, 1)  # avazu_lr's w and b leaves
BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor-core peak
KERNEL_SOURCE = "src/repro_torch/csrc/fed_reduce.cu"
KERNEL_REPLACES = "src/repro/kernels/fed_reduce/fed_reduce.py:41"
KERNELS = ("fed_reduce", "decode_attention", "flash_attention", "ssd_scan")
PROFILE_DIR = os.path.join(ROOT, "chiprun_out")


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# timing

def time_ms(fn, iters: int = 40) -> float:
    """Device time per call of ``fn(i)``, back to back: the host enqueues
    every call while the card sleeps, so host launch overhead is hidden."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# the round's plan and the shapes it gives the kernel

def grade_specs(n_devices: int, bench: int = 1):
    """Two grades (60 % High, 40 % Low), each with ``bench`` benchmarking
    devices (the quickstart's one by default), and resources scaled so that
    the allocator gives each grade's logical and device tier a share."""
    from repro_torch.core import GradeSpec

    n_high = n_devices * 3 // 5
    n_low = n_devices - n_high
    return [
        GradeSpec("High", n_high, benchmarking_devices=bench,
                  logical_bundles=max(1, n_high * 2 // 15),
                  bundles_per_device=4, physical_devices=max(1, n_high // 6)),
        GradeSpec("Low", n_low, benchmarking_devices=bench,
                  logical_bundles=max(1, n_low // 10),
                  bundles_per_device=2, physical_devices=max(1, n_low // 4)),
    ]


def calibrated_plan(specs):
    from repro_torch.core import RoundPlan, RuntimeCalibrator, solve_allocation
    from repro_torch.core.devicemodel import GRADES, DeviceFleet

    cal = RuntimeCalibrator()
    for g in ("High", "Low"):
        probe = DeviceFleet(GRADES[g], 64, seed=7)  # pre-measurement fleet
        for r in range(3):
            cal.observe_fleet(probe.run_round(r))
    alloc = solve_allocation(specs, cal.runtimes_for(specs))
    return cal, alloc, RoundPlan.from_allocation(alloc, specs)


def chunk_rows(plan, cohort: int) -> list[int]:
    """Distinct row counts of the round's update buffers: per grade, the
    logical rows and then the device-tier rows (physical and benchmarking)
    are cut into chunks of ``cohort`` (``HybridSimulation._run_split``)."""
    rows = set()
    for e in plan.entries:
        for n in (e.num_logical, e.num_physical + e.num_benchmarking):
            if n >= cohort:
                rows.add(cohort)
            if n % cohort:
                rows.add(n % cohort)
    return sorted(rows)


# --------------------------------------------------------------------------
# phase 1: the kernel against its plain version

def kernel_phase(dev, rows: list[int]) -> tuple[dict, set]:
    """Returns the kernel's JSON entry and the (rows, width, dtype) shapes
    it was checked at."""
    import torch

    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    cases = [(n, d, dt) for n in rows for d in LEAF_WIDTHS
             for dt in (torch.float32, torch.int8)]
    cases.append((COHORT, LEAF_WIDTHS[0], torch.bfloat16))
    gen = torch.Generator().manual_seed(0)
    results, checked, calls = [], set(), []
    for n, d, dtype in cases:
        scaled = dtype == torch.int8
        if scaled:
            U = torch.randint(-127, 128, (n, d), generator=gen,
                              dtype=torch.int8)
        else:
            U = (torch.randn((n, d), generator=gen) * 1e-2).to(dtype)
        w = torch.rand(n, generator=gen) * 20.0
        w[torch.rand(n, generator=gen) < 0.25] = 0.0  # undelivered rows
        s = (torch.rand(n, generator=gen) * 1e-3 + 1e-5) if scaled else None
        U, w = U.to(dev), w.to(dev)
        s = None if s is None else s.to(dev)
        out1 = fed_reduce(U, w, scales=s, impl="cuda")
        out2 = fed_reduce(U, w, scales=s, impl="cuda")
        plain = fed_reduce(U, w, scales=s, impl="ref")
        torch.cuda.synchronize()
        wf = w if s is None else w * s
        mag = (wf.abs()[:, None] * U.float().abs()).sum(0).clamp_min(1e-30)
        err = (out1 - plain).abs()
        rel = float((err / mag).max())
        bitwise = bool(torch.equal(out1, out2))
        name = f"{n}x{d} {str(dtype).replace('torch.', '')}"
        if not (rel <= 1e-4):
            raise AssertionError(
                f"fed_reduce[{name}] disagrees with its plain version: "
                f"relative error {rel:.3e} > 1e-4")
        if not bitwise:
            raise AssertionError(f"fed_reduce[{name}] is not repeatable")
        # Cycle through enough copies of the stack to exceed the L2, as the
        # round finds a chunk buffer written long before its reduction.
        nbytes = U.numel() * U.element_size()
        copies = max(1, min(64, math.ceil(3 * L2_BYTES / nbytes)))
        Us = [U.clone() for _ in range(copies)]
        ms = time_ms(lambda i: fed_reduce(Us[i % copies], w, scales=s,
                                          impl="cuda"))
        plain_ms = time_ms(lambda i: fed_reduce(Us[i % copies], w, scales=s,
                                                impl="ref"))
        library_ms = (time_ms(lambda i: torch.mv(Us[i % copies].t(), w))
                      if dtype == torch.float32 else None)
        moved = nbytes + 4 * n * (2 if scaled else 1) + 4 * d
        ops = 2 * n * d + (n if scaled else 0)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_FLOPS * 1e3
        row = {"case": name, "shape": [n, d],
               "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": float(err.max()), "max_rel_err": rel,
               "bitwise_repeatable": bitwise, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": moved}
        row["bound_share"] = row["bound_ms"] / ms
        results.append(row)
        checked.add((n, d, row["dtype"]))
        log(json.dumps({"fed_reduce_case": row}))
        calls.append((U, w, s))
        del Us
    # One kernel launch per call: one call per case in a profiled window.
    launched = device_kernels(lambda: [fed_reduce(U, w, scales=s,
                                                  impl="cuda")
                                       for U, w, s in calls])
    per_kernel = {name: n for name, _, n in launched}
    if sum(per_kernel.values()) != len(calls) or not all(
            "fed_reduce_kernel" in k for k in per_kernel):
        raise AssertionError(f"{len(calls)} fed_reduce calls launched "
                             f"{launched}, not one fed_reduce_kernel each")
    log(f"fed_reduce: {len(calls)} calls, {sum(per_kernel.values())} kernel "
        f"launches ({', '.join(sorted(per_kernel))[:200]})")
    # The full f32 chunk buffer's w leaf: the main path's commonest call.
    main = next(r for r in results
                if r["shape"] == [max(rows), LEAF_WIDTHS[0]]
                and r["dtype"] == "float32")
    entry = {"name": "fed_reduce", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": KERNEL_REPLACES, "launches": 0,
             "max_abs_err": max(r["max_abs_err"] for r in results),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": main["library_ms"]}
    return entry, checked


# --------------------------------------------------------------------------
# phase 2/3: the federated round

def grade_data(specs, dim: int, device):
    """Per-grade ``{x, y, mask}`` moved to ``device`` once, and counts."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic_ctr import make_federated_ctr

    batches, counts = {}, {}
    for i, spec in enumerate(specs):
        data = make_federated_ctr(num_devices=spec.num_devices,
                                  records_per_device=RECORDS, dim=dim, seed=i)
        X, Y, c = data.stacked_shards(np.arange(spec.num_devices), RECORDS)
        mask = (np.arange(RECORDS)[None] < c[:, None]).astype(np.float32)
        batches[spec.grade] = {k: torch.from_numpy(v).to(device)
                               for k, v in (("x", X), ("y", Y),
                                            ("mask", mask))}
        counts[spec.grade] = c
    return batches, counts


class LaunchAudit:
    """DeviceFlow sink in front of the service: records which update buffers
    each aggregation consumed, so the expected number of ``fed_reduce``
    launches (one per buffer and leaf) and the shapes they reduce are known
    independently of the service's own code.  Host payloads (the q_i
    benchmarking devices' materialized updates) launch nothing."""

    def __init__(self, svc, n_leaves: int):
        self.svc = svc
        self.n_leaves = n_leaves
        self.buffers: dict[int, object] = {}
        self.expected = 0
        self.per_aggregation: list[int] = []
        self.shapes: set = set()  # (rows, width, dtype) reduced

    def __call__(self, d):
        from repro_torch.core.updates import UpdateHandle

        buf = None
        if d.batch is not None:
            buf = d.batch.buffer
        elif isinstance(d.message.payload, UpdateHandle):
            buf = d.message.payload.buffer
        if buf is not None:
            self.buffers[id(buf)] = buf
        before = len(self.svc.history)
        self.svc(d)
        if len(self.svc.history) > before:
            k = len(self.buffers) * self.n_leaves
            self.per_aggregation.append(k)
            self.expected += k
            for b in self.buffers.values():
                self.shapes.update(
                    (*leaf.shape, str(leaf.dtype).replace("torch.", ""))
                    for leaf in b.leaves2d)
            self.buffers = {}


class RoundProfiler:
    """``--profile``: round 1 of each wire under ``torch.profiler``, round 2
    under ``cProfile``; tables and the f32 trace go to ``chiprun_out/``."""

    def __init__(self, card: str):
        self.card = card
        self.profs: dict = {}
        os.makedirs(PROFILE_DIR, exist_ok=True)

    @contextlib.contextmanager
    def round(self, wire: str, rnd: int):
        if rnd == 1:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                yield
            self.profs[(wire, "torch")] = prof
        elif rnd == 2:
            import cProfile

            pr = cProfile.Profile()
            pr.enable()
            try:
                yield
            finally:
                pr.disable()
            self.profs[(wire, "cprofile")] = pr
        else:
            yield

    def report(self, wire: str, wall_ms: list[float]) -> None:
        import io
        import pstats

        prof = self.profs.get((wire, "torch"))
        if prof is not None:
            busy, n, by_name = kernel_time(prof)
            fed = [r for r in by_name if "fed_reduce" in r[0]]
            log(json.dumps({"round_profile": {
                "wire": wire, "round": 1, "wall_ms": wall_ms[1],
                "kernels": n, "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall_ms[1],
                "fed_reduce_ms": sum(r[1] for r in fed),
                "fed_reduce_kernel_launches": sum(r[2] for r in fed),
                "top_kernels_ms": by_name[:12],
                "card": self.card}}))
            with open(os.path.join(PROFILE_DIR, f"profile_{wire}_kernels.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=40))
            if wire == "f32":
                prof.export_chrome_trace(
                    os.path.join(PROFILE_DIR, "profile_f32_round1.json"))
        pr = self.profs.get((wire, "cprofile"))
        if pr is not None:
            buf = io.StringIO()
            st = pstats.Stats(pr, stream=buf).sort_stats("cumulative")
            st.print_stats(40)
            with open(os.path.join(PROFILE_DIR, f"cprofile_{wire}.txt"),
                      "w") as f:
                f.write(buf.getvalue())
            rows = sorted(((f"{os.path.basename(k[0])}:{k[2]}", v[3])
                           for k, v in st.stats.items()),
                          key=lambda kv: -kv[1])
            log(json.dumps({"host_profile": {
                "wire": wire, "round": 2, "wall_ms": wall_ms[2],
                "cumulative_s_top": rows[:25], "card": self.card}}))


def run_slice(device, n_devices: int, *, dim: int, cohort: int, rounds: int,
              wires=("f32", "int8"), verbose: bool = True, bench: int = 1,
              profiler: "RoundProfiler | None" = None) -> dict:
    """Quickstart sections 1-5 (and the int8 wire of section 9) through the
    port's public API.  Returns per-wire results."""
    import numpy as np
    import torch

    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.core import (AccumulatedStrategy, AggregationService,
                                  DeviceFlow, SampleThresholdTrigger)
    from repro_torch.core.devicemodel import GRADES
    from repro_torch.core.simulation import (DeviceTier, HybridSimulation,
                                             LogicalTier)
    from repro_torch.data.synthetic_ctr import make_federated_ctr
    from repro_torch.models import ctr

    dev = torch.device(device)
    specs = grade_specs(n_devices, bench)
    cal, alloc, plan = calibrated_plan(specs)
    if verbose:
        for e in plan.entries:
            log(f"allocation[{e.grade}]: {e.num_logical} logical / "
                f"{e.num_physical} physical / {e.num_benchmarking} "
                f"benchmarking")
        log(f"estimated makespan {alloc.makespan:.1f}s")
    t0 = time.perf_counter()
    batches, counts = grade_data(specs, dim, dev)
    test = make_federated_ctr(num_devices=64, dim=dim, seed=9)
    test_x = torch.from_numpy(test.features).to(dev)
    test_y = torch.from_numpy(test.labels).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if verbose:
        log(f"data: {n_devices} devices x {RECORDS} records x {dim} on "
            f"{dev} in {time.perf_counter() - t0:.1f}s")
    local_train = ctr.make_local_train_fn(lr=CONFIG.lr,
                                          epochs=CONFIG.local_epochs)
    out = {"plan": plan, "wires": {}}
    for wire in wires:
        svc = AggregationService(
            ctr.lr_init(dim, device=dev),
            trigger=SampleThresholdTrigger(n_devices * RECORDS // 2))
        audit = LaunchAudit(svc, n_leaves=2)
        flow = DeviceFlow(audit)
        flow.register_task(0, AccumulatedStrategy(thresholds=(1,)))
        sim = HybridSimulation(
            LogicalTier(local_train, cohort_size=cohort, device=dev),
            tiers={g: DeviceTier(local_train, GRADES[g], cohort_size=cohort,
                                 device=dev) for g in ("High", "Low")},
            deviceflow=flow, wire=wire, error_feedback=True)
        params, losses, arrivals, walls = [], [], [], []
        for rnd in range(rounds):
            with (profiler.round(wire, rnd) if profiler is not None
                  else contextlib.nullcontext()):
                t = time.perf_counter()
                outcome = sim.run_plan_round(
                    task_id=0, round_idx=rnd,
                    global_params=svc.global_params, plan=plan,
                    grade_batches=batches, grade_num_samples=counts,
                    rng=torch.Generator().manual_seed(rnd), calibrator=cal)
                if wire == "int8":
                    flow.run(1e12)
                    svc.tick(flow.clock.now)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            acc = float(ctr.accuracy(svc.global_params, test_x, test_y))
            loss = float(ctr.bce_loss(svc.global_params, test_x, test_y))
            p = ctr.params_to_numpy(svc.global_params)
            for k, v in p.items():
                if not np.all(np.isfinite(v)):
                    raise AssertionError(f"[{wire}] params[{k!r}] not finite")
            if p["w"].shape != (dim,) or p["b"].shape != ():
                raise AssertionError(f"[{wire}] params have the wrong shapes")
            per_grade = " ".join(f"{g}={b.makespan_s:.0f}s"
                                 for g, b in outcome.per_grade.items())
            if verbose:
                log(f"round {rnd}: aggregations={len(svc.history)} "
                    f"test_acc={acc:.4f} test_loss={loss:.6f} "
                    f"makespan[{per_grade}] wall_ms={wall_ms:.1f} "
                    f"wire={wire} |w|={float(np.linalg.norm(p['w'])):.6f}")
            params.append(p)
            losses.append(loss)
            walls.append(wall_ms)
            arrivals.append(outcome.arrival_times.copy())
        shelf = flow.shelf(0)
        if not flow.conservation_ok(0):
            raise AssertionError(f"[{wire}] DeviceFlow lost messages")
        out["wires"][wire] = {
            "params": params, "test_loss": losses,
            "aggregations": len(svc.history), "arrivals": arrivals,
            "bytes": shelf.total_bytes_dispatched,
            "dispatched": shelf.total_dispatched, "audit": audit,
            "wall_ms": walls}
        if verbose:
            log(f"[{wire}] deviceflow traffic: "
                f"{shelf.total_bytes_dispatched / 2**20:.1f} MiB dispatched "
                f"across {shelf.total_dispatched} update messages; "
                f"fed_reduce launches expected {audit.expected} "
                f"({audit.per_aggregation} per aggregation)")
        if profiler is not None:
            profiler.report(wire, walls)
    return out


def slice_phase(dev, n_devices: int, rounds: int, checked: set,
                bench: int) -> dict:
    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    fed_reduce.launches = 0  # zeroed just before the main path ...
    res = run_slice(dev, n_devices, dim=CONFIG.dim, cohort=COHORT,
                    rounds=rounds, bench=bench)
    launches = fed_reduce.launches  # ... and read just after it
    expected = sum(w["audit"].expected for w in res["wires"].values())
    log(f"fed_reduce launches on the main path: {launches} "
        f"(expected {expected})")
    if launches <= 0 or launches != expected:
        raise AssertionError(
            f"fed_reduce launched {launches} times on the main path, "
            f"expected {expected} (> 0)")
    reduced = set().union(*(w["audit"].shapes
                            for w in res["wires"].values()))
    if not reduced <= checked:
        raise AssertionError(
            f"the main path reduced shapes the kernel phase did not check: "
            f"{sorted(reduced - checked)}")
    log(f"main-path shapes {sorted(reduced)} all checked in the kernel phase")
    for wire, w in res["wires"].items():
        # From zero params the test loss starts at ln 2 and FedAvg of local
        # SGD must lower it every round.
        losses = [math.log(2.0)] + w["test_loss"]
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"[{wire}] test loss did not fall every "
                                 f"round: {losses}")
    res["launches"] = launches
    return res


def cross_check_phase(n_devices: int, rounds: int) -> dict:
    import numpy as np

    from repro_torch.configs.avazu_lr import CONFIG

    def flat(p):
        return np.concatenate([p[k].reshape(-1) for k in sorted(p)])

    kw = dict(dim=CONFIG.dim, cohort=512, rounds=rounds, verbose=False)
    gpu = run_slice("cuda", n_devices, **kw)
    cpu = run_slice("cpu", n_devices, **kw)
    report = {}
    for wire in gpu["wires"]:
        g, c = gpu["wires"][wire], cpu["wires"][wire]
        diff = rel = 0.0
        prev_g = prev_c = np.zeros_like(flat(c["params"][0]))
        for pg, pc in zip(g["params"], c["params"]):
            fg, fc = flat(pg), flat(pc)
            diff = max(diff, float(np.abs(fg - fc).max()))
            rel = max(rel, float(np.linalg.norm((fg - prev_g) - (fc - prev_c))
                                 / np.linalg.norm(fc - prev_c)))
            prev_g, prev_c = fg, fc
        same_host = (g["aggregations"] == c["aggregations"]
                     and g["bytes"] == c["bytes"]
                     and g["dispatched"] == c["dispatched"]
                     and all(np.array_equal(a, b) for a, b in
                             zip(g["arrivals"], c["arrivals"])))
        report[wire] = {"max_param_diff": diff, "max_update_rel_err": rel,
                        "host_state_equal": same_host,
                        "aggregations": g["aggregations"]}
        log(f"cross-check [{wire}] {n_devices} devices: card vs cpu max "
            f"param diff {diff:.3e} (tol 1e-6), max relative update error "
            f"{rel:.3e} (tol 1e-3), host state equal {same_host}")
        if not (diff <= 1e-6 and rel <= 1e-3) or not same_host:
            raise AssertionError(f"cross-check [{wire}] failed: {report}")
    return report


# --------------------------------------------------------------------------
# phase 4: the attention kernels against their plain versions

SERVE_ARCH = "llama3_2_3b"
SERVE_SLOTS = 16
SERVE_REQUESTS = 64
SERVE_PROMPT = 512
SERVE_DECODE = 64
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_DECODE + 1
SERVE_SEED = 0
# (b, s, h, kv, d) and (b, sq, sk, h, kv, d, causal, q_offset): the serving
# run's shapes first, then tests/test_kernels.py's DECODE_CASES (l.65) and
# FLASH_CASES (l.27).
DECODE_SERVE = (SERVE_SLOTS, SERVE_MAX_LEN, 24, 8, 128)
FLASH_SERVE = (SERVE_SLOTS, SERVE_PROMPT, SERVE_PROMPT, 24, 8, 128, True, 0)
# zamba2-1.2b's shared attention block at the SSM serving run's shapes: 32
# heads of 64, one query head per KV head.
DECODE_ZAMBA = (SERVE_SLOTS, SERVE_MAX_LEN, 32, 32, 64)
FLASH_ZAMBA = (SERVE_SLOTS, SERVE_PROMPT, SERVE_PROMPT, 32, 32, 64, True, 0)
DECODE_CASES = [DECODE_SERVE, DECODE_ZAMBA, (2, 256, 8, 2, 64),
                (1, 512, 4, 4, 128), (3, 300, 6, 1, 64), (2, 64, 16, 16, 32)]
FLASH_CASES = [FLASH_SERVE, FLASH_ZAMBA, (2, 256, 256, 4, 2, 64, True, 0),
               (1, 128, 384, 8, 8, 128, False, 0),
               (2, 96, 200, 6, 2, 64, True, 104),
               (1, 1, 256, 4, 1, 64, True, 255),
               (1, 512, 512, 2, 1, 32, True, 0),
               (2, 200, 200, 12, 4, 128, True, 0)]
DECODE_SOURCE = "src/repro_torch/csrc/decode_attention.cu"
DECODE_REPLACES = "src/repro/kernels/decode_attention/decode_attention.py:31"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:33"
FLASH_KERNEL = "flash_fwd_wgmma_kernel"  # bf16 at d = 64, 128: tensor cores
DECODE_KERNEL = "decode_kernel (mma stream)"  # bf16 at d = 64, 128: mma.sync


def _attn_tol(dtype) -> float:
    import torch

    return 3e-5 if dtype == torch.float32 else 2e-2


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _check_close(name: str, out, plain, dtype) -> float:
    """Max |out - plain|; raises unless |out - plain| <= tol (1 + |plain|)
    everywhere (the reference tests' atol = rtol = tol)."""
    tol = _attn_tol(dtype)
    err = (out.float() - plain.float()).abs()
    if not bool((err <= tol * (1.0 + plain.float().abs())).all()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs error {float(err.max()):.3e} "
                             f"(tol {tol})")
    return float(err.max())


def _copies(nbytes: int) -> int:
    """Copies to cycle through so the timed calls find their inputs cold in
    the 50 MB L2, as the serving path does layer after layer."""
    return max(1, min(16, math.ceil(3 * L2_BYTES / nbytes)))


def _timed_entry(name, source, replaces, errs, serve_row) -> dict:
    """A kernel's JSON entry: its numbers at the main path's shape (None
    where that shape was not run, as under ``--ssm-only``)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": max(errs),
            **{k: (serve_row or {}).get(k) for k in keys}}


def decode_cases(dev, cases=DECODE_CASES) -> tuple[dict, set]:
    import torch

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, scatter_prefill_rows)

    gen = torch.Generator().manual_seed(1)
    checked, errs, serve_row, calls = set(), [], None, []
    for case in cases:
        b, s, h, kv, d = case
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, d), generator=gen).to(dtype).to(dev)
            kc = torch.randn((b, s, kv, d), generator=gen).to(dtype).to(dev)
            vc = torch.randn((b, s, kv, d), generator=gen).to(dtype).to(dev)
            lens = torch.randint(1, s + 1, (b,), generator=gen,
                                 dtype=torch.int32)
            lens[0], lens[-1] = 0, s  # an empty slot and a full one
            lens = lens.to(dev)
            name = f"decode_attention{case} {_dtype_name(dtype)}"
            out = decode_attention(q, kc, vc, lens, impl="cuda")
            out2 = decode_attention(q, kc, vc, lens, impl="cuda")
            plain = decode_attention(q, kc, vc, lens, impl="ref")
            torch.cuda.synchronize()
            err = _check_close(name, out, plain, dtype)
            if not torch.equal(out, out2):
                raise AssertionError(f"{name} is not repeatable")
            if not bool((out[lens == 0] == 0).all()):
                raise AssertionError(f"{name}: an empty slot is not zeros")
            # A reused slot: rows past its new length hold the previous
            # occupant's K/V, and attention must not see them.
            new_len = max(1, s // 3)
            sid = torch.tensor([b - 1], dtype=torch.int32, device=dev)
            dk = scatter_prefill_rows(kc.clone(), kc[:1, :new_len], sid)
            dv = scatter_prefill_rows(vc.clone(), vc[:1, :new_len], sid)
            ck, cv = dk.clone(), dv.clone()
            ck[b - 1, new_len:] = 0
            cv[b - 1, new_len:] = 0
            lens2 = lens.clone()
            lens2[-1] = new_len
            stale = float((decode_attention(q, dk, dv, lens2, impl="cuda")
                           .float() - decode_attention(
                               q, ck, cv, lens2, impl="cuda").float())
                          .abs().max())
            if not stale <= 1e-6:
                raise AssertionError(f"{name} reads stale KV: {stale:.3e}")
            errs.append(err)
            calls.append((q, kc, vc, lens))
            checked.add(("decode", case, _dtype_name(dtype)))
            row = {"case": list(case), "dtype": _dtype_name(dtype),
                   "max_abs_err": err, "stale_kv_diff": stale,
                   "bitwise_repeatable": True, "empty_slots_zero": True}
            if (case in (DECODE_SERVE, DECODE_ZAMBA)
                    and dtype == torch.bfloat16):
                row.update(decode_timing(q, kc, vc, lens, case))
                if case == DECODE_SERVE:
                    # The continuous engine's decode steps: 3 busy slots of
                    # 16 (lengths 512-577), the rest empty.
                    busy = torch.zeros(b, dtype=torch.int32)
                    busy[-3:] = torch.tensor([512, 545, 577],
                                             dtype=torch.int32)
                    occ = decode_timing(q, kc, vc, busy.to(dev), case)
                    row["main_occupancy"] = {
                        "lengths": busy.tolist(),
                        **{k: occ[k] for k in ("ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by")}}
                    serve_row = row
            log(json.dumps({"decode_attention_case": row}))
    # One kernel per call, the splits' fold included: each call once more
    # to warm it, then twice per case in a profiled window.
    calls = calls[1::2][:2] + calls[-2:]  # both bf16 serving shapes first
    # After the federated phases the profiler drops a window's first few
    # kernel records (never adds any), so the window opens with a pad of
    # tiny fill kernels, which the count leaves out.
    pad = torch.empty(1, device=dev)

    def window():
        for _ in range(16):
            pad.fill_(0.0)
        for _ in range(2):
            for c in calls:
                decode_attention(*c, impl="cuda")
    for c in calls:
        decode_attention(*c, impl="cuda")
    launched = [r for r in device_kernels(window)
                if "fill" not in r[0].lower()]
    n_launched = sum(n for _, _, n in launched)
    if n_launched != 2 * len(calls) or any("decode_kernel" not in k
                                           for k, _, _ in launched):
        raise AssertionError(f"{2 * len(calls)} decode_attention calls "
                             f"launched {launched}, not one decode_kernel "
                             f"each")
    log(f"decode_attention: {2 * len(calls)} calls, {n_launched} kernel "
        f"launches ({', '.join(sorted({k for k, _, _ in launched}))[:200]})")
    entry = _timed_entry("decode_attention", DECODE_SOURCE, DECODE_REPLACES,
                         errs, serve_row)
    entry["kernel"] = DECODE_KERNEL  # the main path's: bf16 at d = 64, 128
    return entry, checked


def decode_timing(q, kc, vc, lens, case) -> dict:
    """A bf16 serving shape's times at these lengths: the kernel, the plain
    version, SDPA (GQA, a boolean length mask) and the bound (the K/V rows
    these lengths need, read once)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention

    b, s, h, kv, d = case
    n = _copies(2 * kc.numel() * kc.element_size())
    ks = [kc.clone() for _ in range(n)]
    vs = [vc.clone() for _ in range(n)]
    kts = [k.transpose(1, 2).contiguous() for k in ks]
    vts = [v.transpose(1, 2).contiguous() for v in vs]
    q4 = q[:, :, None, :]
    mask = (torch.arange(s, device=q.device)[None] < lens[:, None])[
        :, None, None, :]
    row = {"kernel": DECODE_KERNEL}
    row["ms"] = time_ms(lambda i: decode_attention(
        q, ks[i % n], vs[i % n], lens, impl="cuda"), iters=100)
    row["plain_ms"] = time_ms(lambda i: decode_attention(
        q, ks[i % n], vs[i % n], lens, impl="ref"), iters=10)
    row["library_ms"] = time_ms(
        lambda i: F.scaled_dot_product_attention(
            q4, kts[i % n], vts[i % n], attn_mask=mask, enable_gqa=True),
        iters=100)
    rows_read = int(lens.clamp(0, s).sum())
    moved = (2 * rows_read * kv * d * kc.element_size()
             + 2 * q.numel() * q.element_size() + 4 * b)
    ops = 4 * rows_read * h * d
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_FLOPS * 1e3
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=moved, flops=ops)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def causal_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs attention must score: the causal triangle with
    its offset, cut at the key length."""
    if not causal:
        return sq * sk
    return sum(min(sk, q_offset + i + 1) for i in range(sq))


def flash_cases(dev, cases=FLASH_CASES) -> tuple[dict, set]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator().manual_seed(2)
    checked, errs, serve_row = set(), [], None
    for case in cases:
        b, sq, sk, h, kv, d, causal, off = case
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, sq, h, d), generator=gen).to(dtype).to(dev)
            k = torch.randn((b, sk, kv, d), generator=gen).to(dtype).to(dev)
            v = torch.randn((b, sk, kv, d), generator=gen).to(dtype).to(dev)
            kw = dict(causal=causal, q_offset=off)
            name = f"flash_attention{case} {_dtype_name(dtype)}"
            out = flash_attention(q, k, v, impl="cuda", **kw)
            out2 = flash_attention(q, k, v, impl="cuda", **kw)
            plain = flash_attention(q, k, v, impl="ref", **kw)
            torch.cuda.synchronize()
            err = _check_close(name, out, plain, dtype)
            if not torch.equal(out, out2):
                raise AssertionError(f"{name} is not repeatable")
            errs.append(err)
            checked.add(("flash", case, _dtype_name(dtype)))
            row = {"case": list(case), "dtype": _dtype_name(dtype),
                   "max_abs_err": err, "bitwise_repeatable": True}
            if case in (FLASH_SERVE, FLASH_ZAMBA) and dtype == torch.bfloat16:
                row.update(flash_timing(q, k, v, case))
                if case == FLASH_SERVE:
                    serve_row = row
            log(json.dumps({"flash_attention_case": row}))
    entry = _timed_entry("flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                         errs, serve_row)
    entry["kernel"] = FLASH_KERNEL  # the main path's: bf16 at d = 64, 128
    return entry, checked


def flash_timing(q, k, v, case) -> dict:
    """A bf16 serving shape's times: the tensor-core kernel, the plain-FMA
    kernel on the same inputs (the previous design, for comparison in this
    call), the plain version, SDPA (GQA, causal) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    b, sq, sk, h, kv, d, causal, off = case
    kw = dict(causal=causal, q_offset=off)
    scale = d ** -0.5
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    row = {"kernel": FLASH_KERNEL}
    row["ms"] = time_ms(lambda i: ops.flash_attention(
        q, k, v, impl="cuda", **kw), iters=40)
    row["simt_ms"] = time_ms(lambda i: ops._flash_attention_cuda(
        q, k, v, causal, off, scale, kernel="simt"), iters=20)
    row["plain_ms"] = time_ms(lambda i: ops.flash_attention(
        q, k, v, impl="ref", **kw), iters=5)
    row["library_ms"] = time_ms(
        lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters=40)
    moved = 2 * (q.numel() + k.numel()) * q.element_size()
    ops_n = 4 * d * h * b * causal_pairs(sq, sk, causal, off)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_n / BF16_FLOPS * 1e3
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=moved, flops=ops_n)
    row["tflops"] = ops_n / (row["ms"] * 1e9)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


# --------------------------------------------------------------------------
# phase 5/6: continuous-batching serving at llama3.2-3b width

class WallTimer:
    """Host wall ms of each call of a wrapped function, the card drained
    before and after (so a call's time is its own)."""

    def __init__(self):
        self.ms: dict[str, list[float]] = {}

    def wrap(self, name: str, fn):
        import torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms.setdefault(name, []).append(
                (time.perf_counter() - t) * 1e3)
            return out
        return timed


@contextlib.contextmanager
def timed_arena_ops(timer: WallTimer):
    """The continuous engine's arena_prefill/arena_decode, wall-timed."""
    from repro_torch.core import serving

    saved = serving.arena_prefill, serving.arena_decode
    serving.arena_prefill = timer.wrap("prefill", saved[0])
    serving.arena_decode = timer.wrap("decode", saved[1])
    try:
        yield
    finally:
        serving.arena_prefill, serving.arena_decode = saved


def _trace_kw(cfg) -> dict:
    from repro_torch.core.traffic_curves import diurnal

    return dict(requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                vocab_size=cfg.vocab_size, curve=diurnal(), interval=60.0,
                seed=SERVE_SEED)


def cpu_reports() -> dict:
    """The same trace on the CPU: the virtual-time reports depend on the
    arrivals and the cost model only, so the continuous engine runs without
    a model and the fixed batches with the smoke-size model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deviceflow import VirtualClock
    from repro_torch.core.serving import (ContinuousBatchingEngine,
                                          ContinuousServer)
    from repro_torch.launch import serve

    cfg = get_config(SERVE_ARCH, smoke=True)
    eng = ContinuousBatchingEngine(slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                                   decode_tokens=SERVE_DECODE,
                                   max_len=SERVE_MAX_LEN, simulate_only=True)
    clock = VirtualClock()
    serve.run_trace(ContinuousServer(eng, clock), clock=clock,
                    **_trace_kw(cfg))
    return {"continuous": eng.report(), "fixed": fixed_cpu_report(SERVE_ARCH)}


def fixed_cpu_report(arch: str):
    """The trace's fixed-batch run on the CPU with ``arch``'s smoke-size
    model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch, smoke=True)
    fixed = serve.BatchedServer(cfg, batch_size=SERVE_SLOTS,
                                prompt_len=SERVE_PROMPT,
                                decode_tokens=SERVE_DECODE,
                                max_len=SERVE_MAX_LEN, device="cpu")
    serve.run_trace(fixed, **_trace_kw(cfg))
    return fixed.report()


def kernel_time(prof) -> tuple[float, int, list]:
    """Device busy time of a ``torch.profiler`` window (the union of kernel
    intervals, ms), its kernel count, and ``[name, ms, calls]`` per kernel
    name (first 90 characters), most device time first."""
    from torch.autograd import DeviceType

    kern = [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in kern:
        rec = by_name.setdefault(e.name[:90], [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e3
        rec[1] += 1
    rows = sorted(([k, *v] for k, v in by_name.items()), key=lambda r: -r[1])
    return busy / 1e3, len(kern), rows


def device_kernels(fn) -> list:
    """``[name, ms, launches]`` of each device kernel one call of ``fn``
    runs, under ``torch.profiler`` (CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # let the tracer settle before the first launch
        fn()
        torch.cuda.synchronize()
    return kernel_time(prof)[2]


def profile_window(fn, steps: int, match=()) -> dict:
    """``fn()`` under ``torch.profiler`` (CUDA activity only): its host wall,
    the device's busy time and idle share, the kernels that took it, and
    how many kernels' names contain each string of ``match``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # let the tracer settle before the first launch
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
    busy, n, by_name = kernel_time(prof)
    names = [e.name for e in prof.events()
             if getattr(e, "device_type", None) == DeviceType.CUDA]
    return {"steps": steps, "wall_ms": wall, "device_busy_ms": busy,
            "kernels": n, "device_idle_share": 1.0 - busy / wall,
            "top_kernels_ms": by_name[:8],
            "matched": {m: sum(m in k for k in names) for m in match}}


def serving_profile(cfg, params, prompts, card: str) -> dict:
    """Device idle share of the continuous engine: one step admitting three
    requests (the trace's usual occupancy: prefill + decode), then 20
    decode-only steps, each window under ``torch.profiler`` (CUDA activity
    only) with its host wall."""
    from repro_torch.core.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, slots=SERVE_SLOTS,
                                   prompt_len=SERVE_PROMPT,
                                   decode_tokens=SERVE_DECODE,
                                   max_len=SERVE_MAX_LEN, params=params,
                                   device=params["ln_f"].device)
    for i in range(3):
        eng.submit(i, prompts[i], 0.0)
    out, clock = {}, [0.0]

    def steps(k):
        for _ in range(k):
            clock[0] += eng.step(clock[0])
    for window, k in (("prefill_step", 1), ("decode_steps", 20)):
        out[window] = profile_window(lambda: steps(k), k)
    log(json.dumps({"serving_profile": out, "card": card}))
    del eng
    return out


def serving_phase(dev, checked: set, card: str) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.deviceflow import VirtualClock
    from repro_torch.core.serving import (ContinuousBatchingEngine,
                                          ContinuousServer)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = transformer.init(
        torch.Generator(device=dev).manual_seed(SERVE_SEED), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params} params ({n_params * 2 / 1e9:.2f} GB bf16) "
        f"initialized on the card in {time.perf_counter() - t0:.1f}s")
    L = cfg.num_layers

    def flash_shape(b):  # what a prefill of b prompts gives the kernel
        return (b, SERVE_PROMPT, SERVE_PROMPT, cfg.num_heads,
                cfg.num_kv_heads, cfg.head_dim, True, 0)

    def decode_shape(b):  # what a decode step over b rows gives it
        return (b, SERVE_MAX_LEN, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim)

    cpu = cpu_reports()
    reports, results = {}, {}
    for mode in ("continuous", "fixed"):
        timer = WallTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode_attention.launches = 0  # zeroed just before the main path ...
        flash_attention.launches = flash_attention.wgmma_launches = 0
        w0 = time.perf_counter()
        if mode == "continuous":
            engine = ContinuousBatchingEngine(
                cfg, slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                decode_tokens=SERVE_DECODE, max_len=SERVE_MAX_LEN,
                params=params, device=dev)
            clock = VirtualClock()
            with timed_arena_ops(timer):
                serve.run_trace(ContinuousServer(engine, clock), clock=clock,
                                **_trace_kw(cfg))
            rep = engine.report()
            n_prefill = sum(1 for it in engine.iterations if it.admitted)
            n_decode = sum(1 for it in engine.iterations if it.n_active)
            tokens = sum(it.n_active for it in engine.iterations)
            shapes = {("flash", flash_shape(SERVE_SLOTS), "bfloat16"),
                      ("decode", decode_shape(SERVE_SLOTS), "bfloat16")}
            occupancy = max(it.n_active for it in engine.iterations)
        else:
            server = serve.BatchedServer(
                cfg, batch_size=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                decode_tokens=SERVE_DECODE, max_len=SERVE_MAX_LEN,
                params=params, device=dev)
            server.api = dataclasses.replace(
                server.api, prefill=timer.wrap("prefill", server.api.prefill),
                decode_step=timer.wrap("decode", server.api.decode_step))
            serve.run_trace(server, **_trace_kw(cfg))
            rep = server.report()
            n_prefill = len(server.metrics)
            n_decode = n_prefill * SERVE_DECODE
            tokens = sum(m.tokens_decoded for m in server.metrics)
            shapes = set()
            for m in server.metrics:
                shapes.add(("flash", flash_shape(m.batch_size), "bfloat16"))
                shapes.add(("decode", decode_shape(m.batch_size), "bfloat16"))
            occupancy = max(m.batch_size for m in server.metrics)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - w0
        launches = {"decode_attention": decode_attention.launches,
                    "flash_attention": flash_attention.launches,
                    "flash_attention_wgmma":
                        flash_attention.wgmma_launches}  # ... read
        # Every prefill's attention runs on the tensor-core kernel.
        expected = {"decode_attention": L * n_decode,
                    "flash_attention": L * n_prefill,
                    "flash_attention_wgmma": L * n_prefill}
        peak = torch.cuda.max_memory_allocated()
        s = rep.summary(30.0)
        if s != cpu[mode].summary(30.0):
            raise AssertionError(f"[{mode}] the card's virtual-time report "
                                 f"{s} differs from the CPU run's "
                                 f"{cpu[mode].summary(30.0)}")
        if launches != expected or min(launches.values()) <= 0:
            raise AssertionError(f"[{mode}] launches {launches}, expected "
                                 f"{expected}")
        if not shapes <= checked:
            raise AssertionError(f"[{mode}] launched shapes the kernel phase "
                                 f"did not check: {sorted(shapes - checked)}")
        toks = {r.request_id: r.tokens for r in rep.records}
        if len(rep.finished()) != SERVE_REQUESTS or any(
                len(t) != SERVE_DECODE + 1 for t in toks.values()):
            raise AssertionError(f"[{mode}] not every request finished")
        pre, dec = timer.ms["prefill"], timer.ms["decode"]
        res = {"mode": mode, "report": s, "prefill_calls": n_prefill,
               "decode_iterations": n_decode,
               "wall_ms_per_prefill": sum(pre) / len(pre),
               "wall_ms_per_decode_iteration": sum(dec) / len(dec),
               "decode_tokens_per_s": tokens / (sum(dec) / 1e3),
               "peak_memory_gb": peak / 1e9, "wall_s": wall_s,
               "launches": launches, "expected_launches": expected,
               "peak_occupancy": occupancy, "card": card}
        log(json.dumps({"serving": res}))
        log(f"  {mode:10s} p50={s['p50_latency_s'] * 1e3:.1f}ms "
            f"p99={s['p99_latency_s'] * 1e3:.1f}ms "
            f"ttft_p99={s['p99_ttft_s'] * 1e3:.1f}ms "
            f"goodput={s['goodput_rps']:.4f} req/s (= CPU run) | "
            f"{res['wall_ms_per_prefill']:.1f} ms/prefill, "
            f"{res['wall_ms_per_decode_iteration']:.2f} ms/decode "
            f"iteration, {res['decode_tokens_per_s']:.0f} decode tok/s, "
            f"peak {peak / 1e9:.2f} GB; launches {launches} = expected")
        reports[mode], results[mode] = rep, res
        results[mode]["tokens"] = toks
    c, f = reports["continuous"], reports["fixed"]
    cut = f.p99_latency_s / c.p99_latency_s
    log(f"p99 latency cut: {cut:.2f}x (>= 2 required)")
    if not cut >= 2.0:
        raise AssertionError(f"continuous p99 cut {cut:.2f}x < 2x")
    tc, tf = results["continuous"].pop("tokens"), results["fixed"].pop(
        "tokens")
    same = sum(tc[i] == tf[i] for i in tc)
    log(f"continuous vs fixed tokens: {same}/{len(tc)} requests identical "
        "(bf16; not gated)")
    prompts = np.random.default_rng(SERVE_SEED).integers(
        1, cfg.vocab_size, size=(SERVE_REQUESTS, SERVE_PROMPT))
    profile = serving_profile(cfg, params, prompts, card)
    return {"params": params, "cfg": cfg, "prompts": prompts,
            "results": results, "p99_cut": cut, "profile": profile,
            "launches": {k: sum(r["launches"][k] for r in results.values())
                         for k in ("decode_attention", "flash_attention",
                                   "flash_attention_wgmma")}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def compare_paths(name: str, kernel, plain, vocab: int, dtype: str,
                  tol: float, steps: int = 16) -> dict:
    """Teacher-forced comparison of two serving paths at full width and 2
    layers.  ``kernel`` and ``plain`` are ``(prefill() -> (logits, cache),
    decode(token, cache) -> (logits, cache))``; both paths get the plain
    path's greedy token.  Last-position logits must agree within ``tol``
    relative, and in f32 every greedy token must be equal."""
    import torch

    lk, ck = kernel[0]()
    lp, cp = plain[0]()
    worst, agree, total = 0.0, 0, 0
    for step in range(steps + 1):
        worst = max(worst, float((lk - lp).abs().max() / lp.abs().max()))
        gk, gp = lk[:, :vocab].argmax(-1), lp[:, :vocab].argmax(-1)
        agree += int((gk == gp).sum())
        total += gk.numel()
        if step == steps:
            break
        nxt = gp.to(torch.int32)
        lk, ck = kernel[1](nxt, ck)
        lp, cp = plain[1](nxt, cp)
    rate = agree / total
    log(f"{name} 2 layers at full width: kernel vs plain max relative "
        f"logit diff {worst:.3e} (tol {tol}), greedy tokens agree "
        f"{agree}/{total} ({rate:.4f})")
    if not worst <= tol:
        raise AssertionError(f"{name} failed")
    if dtype == "float32" and agree != total:
        raise AssertionError(f"{name}: greedy tokens differ")
    return {"max_rel_logit_diff": worst, "tol": tol,
            "greedy_agreement": rate, "steps": steps}


def _float_tree(tree):
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_tree(v) for v in tree]
    return tree.float()


CROSS_DTYPES = (("bfloat16", 2e-2), ("float32", 1e-4))


def serving_cross_check(params, cfg, prompts) -> dict:
    """The kernel path against the plain path (``attention_impl="einsum"``)
    at full width and 2 layers."""
    import dataclasses

    import torch

    from repro_torch.models import transformer

    two = {**params, "layers": params["layers"][:2]}
    toks = torch.as_tensor(prompts[:SERVE_SLOTS], dtype=torch.int32,
                           device=params["ln_f"].device)
    out = {}
    for dtype, tol in CROSS_DTYPES:
        p = two if dtype == "bfloat16" else _float_tree(two)
        paths = []
        for impl in ("auto", "einsum"):
            c = dataclasses.replace(cfg, num_layers=2, dtype=dtype,
                                    attention_impl=impl)
            paths.append((
                lambda c=c: transformer.prefill(p, toks, c, SERVE_MAX_LEN),
                lambda t, cache, c=c: transformer.decode_step(p, t, c,
                                                              cache)))
        out[dtype] = compare_paths(f"serving cross-check [{dtype}]", *paths,
                                   cfg.vocab_size, dtype, tol)
    return out


# --------------------------------------------------------------------------
# phase 7: the SSD scan kernel against its plain versions

SSM_ARCHS = ("mamba2_1_3b", "zamba2_1_2b")
# (b, l, h, p, g, n, chunk): tests/test_kernels.py's SSD_CASES (l.186), both
# serving shapes (16 prompts of 512 at mamba2-1.3b's and zamba2-1.2b's
# widths), a length that pads to the chunk, and decays that overflow above
# the diagonal (A = -64, dt = 0.1).
SSD_CASES = [(2, 128, 4, 32, 1, 16, 32), (1, 256, 8, 64, 2, 64, 64),
             (2, 64, 2, 16, 2, 8, 16), (1, 128, 4, 64, 1, 128, 128)]
SSD_MAMBA = (SERVE_SLOTS, SERVE_PROMPT, 64, 64, 1, 128, 128)
SSD_ZAMBA = (SERVE_SLOTS, SERVE_PROMPT, 64, 64, 1, 64, 128)
SSD_RAGGED = (2, 500, 64, 64, 1, 128, 128)
SSD_OVERFLOW = (2, 256, 8, 64, 1, 128, 128)
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:30"
SSD_KERNELS = {"tc": "ssd_scan_tc_kernel", "simt": "ssd_scan_kernel"}


def ssd_inputs(gen, case, dtype, dev, *, overflow: bool = False):
    """x, dt, A, B, C drawn as the reference's tests draw them (x, B and C
    in ``dtype``; dt and A f32, as the model passes them)."""
    import torch

    b, l, h, p, g, n, _ = case
    x = (torch.randn((b, l, h, p), generator=gen) * 0.5).to(dtype)
    if overflow:
        dt, A = torch.full((b, l, h), 0.1), torch.full((h,), -64.0)
    else:
        dt = torch.randn((b, l, h), generator=gen).abs() * 0.1 + 0.01
        A = -torch.randn(h, generator=gen).abs() - 0.1
    B = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dtype)
    C = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dtype)
    return [t.to(dev) for t in (x, dt, A, B, C)]


def ssd_bound(case, itemsize: int, flops_per_s: float) -> dict:
    """Bytes the scan must move (x, dt, A, B, C read once; y and the f32
    state written once) and the operations it must do: per head and chunk,
    C.B and M.x over the causal triangle, C.S^T and the state update."""
    b, l, h, p, g, n, q = case
    moved = (2 * b * l * h * p * itemsize + 4 * b * l * h + 4 * h
             + 2 * b * l * g * n * itemsize + 4 * b * h * p * n)
    chunks = -(-l // q)
    ops = 2 * b * h * chunks * (q * (q + 1) // 2 * (n + p) + 2 * q * p * n)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / flops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": moved, "flops": ops}


def ssd_cases(dev) -> tuple[dict, set]:
    """``ssd_scan`` on the card against its chunked plain version and the
    sequential oracle on the card: y and the state within 3e-4 absolute in
    f32 (tests/test_kernels.py:207), y within 2e-2 relative in bf16, no
    NaN, two launches bitwise equal.  The serving shapes are timed."""
    import torch

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ops import kernel_for, ssd_scan

    gen = torch.Generator().manual_seed(3)
    cases = [(c, False) for c in SSD_CASES + [SSD_MAMBA, SSD_ZAMBA,
                                               SSD_RAGGED]]
    cases.append((SSD_OVERFLOW, True))
    checked, errs, main_row = set(), [], None
    for case, overflow in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(gen, case, dtype, dev, overflow=overflow)
            q = case[-1]
            tc0 = ssd_scan.tc_launches
            y, s = ssd_scan(*args, chunk=q, impl="cuda")
            y2, s2 = ssd_scan(*args, chunk=q, impl="cuda")
            name = (f"ssd_scan{case}{' overflow' if overflow else ''} "
                    f"{_dtype_name(dtype)}")
            finite = bool(torch.isfinite(y.float()).all()
                          and torch.isfinite(s).all())
            if not finite:
                raise AssertionError(f"{name} gave a non-finite value")
            bitwise = bool(torch.equal(y, y2) and torch.equal(s, s2))
            if not bitwise:
                raise AssertionError(f"{name} is not repeatable")
            route = kernel_for(dtype, case[3], case[5], min(q, case[1]))
            if ssd_scan.tc_launches - tc0 != (2 if route == "tc" else 0):
                raise AssertionError(f"{name} should run on the {route} "
                                     f"kernel")
            row = {"case": list(case), "dtype": _dtype_name(dtype),
                   "kernel": SSD_KERNELS[route],
                   "overflow": overflow, "bitwise_repeatable": bitwise,
                   "finite": finite}
            for plain in ("chunked", "ref"):
                py, ps = ssd_scan(*args, chunk=q, impl=plain)
                torch.cuda.synchronize()
                ey = (y.float() - py.float()).abs()
                es = float((s - ps).abs().max())
                if dtype == torch.float32:
                    ok = float(ey.max()) <= 3e-4 and es <= 3e-4
                else:
                    ok = bool((ey <= 2e-2 * (1 + py.float().abs())).all()
                              and es <= 3e-4)
                if not ok:
                    raise AssertionError(
                        f"{name} disagrees with its {plain} version: y "
                        f"{float(ey.max()):.3e}, state {es:.3e}")
                row[f"max_abs_err_y_{plain}"] = float(ey.max())
                row[f"max_abs_err_state_{plain}"] = es
                errs += [float(ey.max()), es]
            checked.add(("ssd", case, _dtype_name(dtype)))
            if case in (SSD_MAMBA, SSD_ZAMBA) and dtype == torch.bfloat16:
                nbytes = sum(t.numel() * t.element_size() for t in args)
                n = _copies(nbytes)
                sets = [[t.clone() for t in args] for _ in range(n)]
                row["ms"] = time_ms(lambda i: ssd_scan(
                    *sets[i % n], chunk=q, impl="cuda"), iters=40)
                # The plain-FMA kernel (the previous design) on the same
                # inputs, for comparison in this call.
                row["simt_ms"] = time_ms(lambda i: ops._ssd_scan_cuda(
                    *sets[i % n], q, kernel="simt"), iters=10)
                row["plain_ms"] = time_ms(lambda i: ssd_scan(
                    *sets[i % n], chunk=q, impl="chunked"), iters=5)
                row["library_ms"] = None  # no PyTorch op computes the scan
                row.update(ssd_bound(case, 2, BF16_FLOPS))
                row["bound_share"] = row["bound_ms"] / row["ms"]
                if case == SSD_MAMBA:
                    main_row = row
                del sets
            log(json.dumps({"ssd_scan_case": row}))
    entry = _timed_entry("ssd_scan", SSD_SOURCE, SSD_REPLACES, errs,
                         main_row)
    entry["kernel"] = SSD_KERNELS["tc"]  # the main path's: bf16 serving
    return entry, checked


# --------------------------------------------------------------------------
# phase 8/9: fixed-batch serving of the SSM and hybrid models

def _ssm_shapes(cfg, batch: int) -> set:
    """(kernel, shape, dtype) of every launch a prefill of ``batch`` prompts
    and its decode steps give the kernels."""
    from repro_torch.models import hybrid

    q = min(cfg.ssm_chunk, SERVE_PROMPT)
    out = {("ssd", (batch, SERVE_PROMPT, cfg.ssm_heads, cfg.ssm_head_dim,
                    cfg.ssm_groups, cfg.ssm_state, q), cfg.dtype)}
    if cfg.family == "hybrid" and hybrid._attn_positions(cfg):
        out.add(("flash", (batch, SERVE_PROMPT, SERVE_PROMPT, cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, True, 0),
                 cfg.dtype))
        out.add(("decode", (batch, SERVE_MAX_LEN, cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim), cfg.dtype))
    return out


def ssm_profile(api, cfg, params, prompts, card: str) -> dict:
    """Device idle share of fixed-batch serving: one prefill of 16 prompts,
    then 20 greedy decode steps, each window profiled; in those windows
    every counted ``ssd_scan`` tensor-core launch and ``decode_attention``
    call must be one kernel of its name."""
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    toks = torch.as_tensor(prompts[:SERVE_SLOTS], dtype=torch.int32,
                           device=params["ln_f"].device)
    state = {}

    def greedy(logits):
        state["tok"] = logits[:, : cfg.vocab_size].argmax(-1).to(torch.int32)

    def prefill():
        logits, state["cache"] = api.prefill(params, toks, cfg,
                                             SERVE_MAX_LEN)
        greedy(logits)

    def decode():
        for _ in range(20):
            logits, state["cache"] = api.decode_step(
                params, state["tok"], cfg, state["cache"])
            greedy(logits)
    # Each counted launch is one kernel of its name: the bf16 scans on the
    # tensor-core kernel, each decode_attention call one decode_kernel.
    for _ in range(2):  # again if the tracer dropped records (see phase 4)
        tc0 = ssd_scan.tc_launches
        out = {"prefill": profile_window(prefill, 1, ("ssd_scan_tc_kernel",))}
        d0 = decode_attention.launches
        out["decode_steps"] = profile_window(decode, 20, ("decode_kernel",))
        seen = {"ssd_scan_tc_kernel": (out["prefill"]["matched"][
                    "ssd_scan_tc_kernel"], ssd_scan.tc_launches - tc0),
                "decode_kernel": (out["decode_steps"]["matched"][
                    "decode_kernel"], decode_attention.launches - d0)}
        if all(k == c for k, c in seen.values()):
            break
    if any(k != c for k, c in seen.values()) or seen[
            "ssd_scan_tc_kernel"][1] != cfg.num_layers:
        raise AssertionError(f"[{cfg.name}] profiled kernels vs counted "
                             f"launches: {seen}")
    out["kernels_vs_launches"] = seen
    log(json.dumps({"ssm_serving_profile": out, "arch": cfg.name,
                    "card": card}))
    return out


def ssm_serving_phase(dev, arch: str, checked: set, card: str) -> dict:
    """``arch`` at full width in bf16 through ``BatchedServer(16)`` on the
    serving trace: the report equals the CPU run's, the launch counters
    read one ``ssd_scan`` per layer per prefill (and, for the hybrid, one
    ``flash_attention`` per shared-block application per prefill and one
    ``decode_attention`` per application per decode step) at shapes phases
    4 and 7 checked."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import hybrid
    from repro_torch.models.registry import get_model

    cfg = get_config(arch)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SERVE_SEED),
                      cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params} params ({n_params * 2 / 1e9:.2f} GB bf16) "
        f"initialized on the card in {time.perf_counter() - t0:.1f}s")
    apps = len(hybrid._attn_positions(cfg)) if cfg.family == "hybrid" else 0
    cpu = fixed_cpu_report(arch).summary(30.0)
    timer = WallTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = ssd_scan.tc_launches = 0  # zeroed just before the
    decode_attention.launches = flash_attention.launches = 0  # main path ...
    flash_attention.wgmma_launches = 0
    w0 = time.perf_counter()
    server = serve.BatchedServer(
        cfg, batch_size=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
        decode_tokens=SERVE_DECODE, max_len=SERVE_MAX_LEN, params=params,
        device=dev)
    server.api = dataclasses.replace(
        server.api, prefill=timer.wrap("prefill", server.api.prefill),
        decode_step=timer.wrap("decode", server.api.decode_step))
    serve.run_trace(server, **_trace_kw(cfg))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - w0
    launches = {"ssd_scan": ssd_scan.launches,
                "ssd_scan_tc": ssd_scan.tc_launches,
                "flash_attention": flash_attention.launches,
                "flash_attention_wgmma": flash_attention.wgmma_launches,
                "decode_attention": decode_attention.launches}  # ... read
    rep = server.report()
    n_prefill = len(server.metrics)
    n_decode = n_prefill * SERVE_DECODE
    # Every bf16 prefill's scan runs on the tensor-core kernel.
    expected = {"ssd_scan": cfg.num_layers * n_prefill,
                "ssd_scan_tc": cfg.num_layers * n_prefill,
                "flash_attention": apps * n_prefill,
                "flash_attention_wgmma": apps * n_prefill,
                "decode_attention": apps * n_decode}
    peak = torch.cuda.max_memory_allocated()
    s = rep.summary(30.0)
    if s != cpu:
        raise AssertionError(f"[{arch}] the card's virtual-time report {s} "
                             f"differs from the CPU run's {cpu}")
    if launches != expected or launches["ssd_scan"] <= 0:
        raise AssertionError(f"[{arch}] launches {launches}, expected "
                             f"{expected}")
    shapes = set().union(*(_ssm_shapes(cfg, m.batch_size)
                           for m in server.metrics))
    if not shapes <= checked:
        raise AssertionError(f"[{arch}] launched shapes the kernel phases "
                             f"did not check: {sorted(shapes - checked)}")
    toks = {r.request_id: r.tokens for r in rep.records}
    if len(rep.finished()) != SERVE_REQUESTS or any(
            len(t) != SERVE_DECODE + 1 for t in toks.values()):
        raise AssertionError(f"[{arch}] not every request finished")
    pre, dec = timer.ms["prefill"], timer.ms["decode"]
    tokens = sum(m.tokens_decoded for m in server.metrics)
    res = {"arch": cfg.name, "mode": "fixed", "report": s,
           "prefill_calls": n_prefill, "decode_iterations": n_decode,
           "wall_ms_per_prefill": sum(pre) / len(pre),
           "wall_ms_per_decode_iteration": sum(dec) / len(dec),
           "decode_tokens_per_s": tokens / (sum(dec) / 1e3),
           "peak_memory_gb": peak / 1e9, "wall_s": wall_s,
           "launches": launches, "expected_launches": expected,
           "params": n_params, "card": card}
    log(json.dumps({"ssm_serving": res}))
    log(f"  {cfg.name:12s} fixed p50={s['p50_latency_s'] * 1e3:.1f}ms "
        f"p99={s['p99_latency_s'] * 1e3:.1f}ms "
        f"goodput={s['goodput_rps']:.4f} req/s (= CPU run) | "
        f"{res['wall_ms_per_prefill']:.1f} ms/prefill, "
        f"{res['wall_ms_per_decode_iteration']:.2f} ms/decode iteration, "
        f"{res['decode_tokens_per_s']:.0f} decode tok/s, peak "
        f"{peak / 1e9:.2f} GB; launches {launches} = expected")
    prompts = np.random.default_rng(SERVE_SEED).integers(
        1, cfg.vocab_size, size=(SERVE_REQUESTS, SERVE_PROMPT))
    res["profile"] = ssm_profile(api, cfg, params, prompts, card)
    return {"params": params, "cfg": cfg, "prompts": prompts,
            "results": res, "launches": launches}


def ssm_plain_prefill(p, toks, cfg):
    """The plain path of a prefill, layer by layer: the model's own blocks
    with the chunked scan (``block_prefill(impl="chunked")``) and, for the
    hybrid, the shared block's plain attention (``cfg.attention_impl``)."""
    from repro_torch.models import hybrid, mamba2
    from repro_torch.models.layers import embed_apply, rmsnorm, unembed_apply

    x = embed_apply(p["embed"], toks)
    if cfg.family == "ssm":
        caches = []
        for lp in p["layers"]:
            x, c = mamba2.block_prefill(lp, x, cfg, impl="chunked")
            caches.append(c)
    else:
        positions = hybrid._positions(x)
        attn_at = set(hybrid._attn_positions(cfg))
        caches = {"mamba": [], "attn": []}
        for i, lp in enumerate(p["mamba_layers"]):
            if i in attn_at:
                x, ac = hybrid.attention_prefill(p["shared_attn"], x, cfg,
                                                 positions, SERVE_MAX_LEN)
                caches["attn"].append(ac)
            x, mc = mamba2.block_prefill(lp, x, cfg, impl="chunked")
            caches["mamba"].append(mc)
    x = rmsnorm(x, p["ln_f"], cfg.norm_eps)
    return unembed_apply(p["embed"], x[:, -1]), caches


def ssm_cross_check(params, cfg, prompts) -> dict:
    """The kernel path against the plain path at full width and 2 layers
    (zamba2: its shared block applied at layer 0).  The kernel path's
    prefill must launch one ``ssd_scan`` per layer, the plain path's
    none."""
    import dataclasses

    import torch

    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    layers = "layers" if cfg.family == "ssm" else "mamba_layers"
    two = {**params, layers: params[layers][:2]}
    toks = torch.as_tensor(prompts[:SERVE_SLOTS], dtype=torch.int32,
                           device=params["ln_f"].device)
    out, launched = {}, []

    def kernel_prefill(p, c):
        before = ssd_scan.launches
        res = api.prefill(p, toks, c, SERVE_MAX_LEN)
        launched.append(ssd_scan.launches - before)
        return res

    def plain_prefill(p, c):
        before = ssd_scan.launches
        res = ssm_plain_prefill(p, toks, c)
        launched.append(ssd_scan.launches - before)
        return res
    for dtype, tol in CROSS_DTYPES:
        p = two if dtype == "bfloat16" else _float_tree(two)
        cfg2 = dataclasses.replace(cfg, num_layers=2, dtype=dtype)
        cfg_plain = dataclasses.replace(cfg2, attention_impl="einsum")
        out[dtype] = compare_paths(
            f"ssm cross-check [{cfg.name} {dtype}]",
            (lambda: kernel_prefill(p, cfg2),
             lambda t, cache: api.decode_step(p, t, cfg2, cache)),
            (lambda: plain_prefill(p, cfg_plain),
             lambda t, cache: api.decode_step(p, t, cfg_plain, cache)),
            cfg.vocab_size, dtype, tol)
        if launched[-2:] != [2, 0]:
            raise AssertionError(f"[{cfg.name}] ssd_scan launches in the "
                                 f"kernel and plain prefills: {launched}")
    return out


def ssm_phases(dev, checked: set, card: str) -> dict:
    """Phases 8 and 9 for each SSM architecture; returns the launches read
    on each model's main path."""
    import torch

    out = {}
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        srv = ssm_serving_phase(dev, arch, checked, card)
        log(f"ssm serving phase [{arch}] passed in "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        ssm_cross_check(srv["params"], srv["cfg"], srv["prompts"])
        log(f"ssm cross-check [{arch}] passed in "
            f"{time.perf_counter() - t0:.1f}s")
        out[arch] = srv["launches"]
        del srv
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------

# --compare-with DIR: the decode and scan kernels of this checkout and of
# the checkout at DIR (e.g. the parent commit), timed in turns (DIR, this,
# this, DIR) on one card, each in its own process with its own build.  The
# code runs against either package: it uses only the wrappers' public
# calls, with inputs drawn from fixed seeds.
AB_CODE = r"""
import json, math, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan

def time_ms(fn, iters):
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters

def copies(nbytes):
    return max(1, min(16, math.ceil(3 * 50 * 2**20 / nbytes)))

dev = torch.device("cuda")
out = {"decode": {}, "ssd": {}}
for name, (b, s, h, kv, d), lens in (
        ("serve_ragged", (16, 577, 24, 8, 128), None),
        ("serve_main_occupancy", (16, 577, 24, 8, 128),
         [0] * 13 + [512, 545, 577]),
        ("serve_one_row", (16, 577, 24, 8, 128), [1] * 16),
        ("serve_full", (16, 577, 24, 8, 128), [577] * 16),
        ("zamba_ragged", (16, 577, 32, 32, 64), None)):
    g = torch.Generator().manual_seed(21)
    q = torch.randn((b, h, d), generator=g).bfloat16().to(dev)
    k = torch.randn((b, s, kv, d), generator=g).bfloat16()
    v = torch.randn((b, s, kv, d), generator=g).bfloat16()
    if lens is None:
        ln = torch.randint(1, s + 1, (b,), generator=g, dtype=torch.int32)
        ln[0], ln[-1] = 0, s
    else:
        ln = torch.tensor(lens, dtype=torch.int32)
    ln = ln.to(dev)
    n = copies(2 * k.numel() * 2)
    ks = [k.to(dev) for _ in range(n)]
    vs = [v.to(dev) for _ in range(n)]
    out["decode"][name] = time_ms(lambda i: decode_attention(
        q, ks[i % n], vs[i % n], ln, impl="cuda"), 100)
for name, n_state in (("mamba", 128), ("zamba", 64)):
    g = torch.Generator().manual_seed(22)
    b, l, h, p = 16, 512, 64, 64
    x = (torch.randn((b, l, h, p), generator=g) * 0.5).bfloat16()
    dt = torch.randn((b, l, h), generator=g).abs() * 0.1 + 0.01
    A = -torch.randn(h, generator=g).abs() - 0.1
    B = (torch.randn((b, l, 1, n_state), generator=g) * 0.3).bfloat16()
    C = (torch.randn((b, l, 1, n_state), generator=g) * 0.3).bfloat16()
    args = [t.to(dev) for t in (x, dt, A, B, C)]
    n = copies(sum(t.numel() * t.element_size() for t in args))
    sets = [[t.clone() for t in args] for _ in range(n)]
    out["ssd"][name] = time_ms(lambda i: ssd_scan(*sets[i % n], chunk=128,
                                                 impl="cuda"), 20)
print(json.dumps(out))
"""


def compare_kernels(other: str) -> dict:
    """``--compare-with``: the kernel times of ``other`` and of this
    checkout, in turns (other, this, this, other), on one card."""
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        proc = subprocess.run([sys.executable, "-c", AB_CODE,
                               os.path.abspath(root)], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel timing of {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        row = {"run": label, "root": root,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        log(json.dumps({"kernel_ab": row}))
        runs.append(row)
    return {"runs": runs}


# The new kernels' instantiations on the main paths, by mangled-name part.
PTXAS_KERNELS = {
    "decode_attention": {
        "d128 g<=4": "decode_kernelI13__nv_bfloat16Li128ELi4ELb1E",
        "d64 g<=4": "decode_kernelI13__nv_bfloat16Li64ELi4ELb1E"},
    "ssd_scan": {"n128 q128": "ssd_scan_tc_kernelILi128ELi128E",
                 "n64 q128": "ssd_scan_tc_kernelILi64ELi128E"}}


def ptxas_summary(name: str) -> dict:
    """Registers and spill bytes ptxas reported for the main paths'
    instantiations of kernel ``name`` (from its build log)."""
    import re

    from repro_torch.kernels import _build

    lines = _build.BUILD_LOGS.get(name, "").splitlines()
    out = {}
    for label, needle in PTXAS_KERNELS.get(name, {}).items():
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and needle in line:
                text = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores", text)
                out[label] = {
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None}
                break
    return out


def tensor_core_sass(libs: dict) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in each built
    library's SASS (``cuobjdump -sass``); raises unless flash_attention and
    ssd_scan hold HGMMA and decode_attention HMMA."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    out = {}
    for name, path in libs.items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout.splitlines()
        out[name] = {op: sum(op + "." in line or op + " " in line
                             for line in sass) for op in ("HGMMA", "HMMA")}
    want = {"flash_attention": "HGMMA", "ssd_scan": "HGMMA",
            "decode_attention": "HMMA"}
    if any(out[name][op] == 0 for name, op in want.items()):
        raise AssertionError(f"tensor-core instructions missing: {out}")
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=100_000)
    p.add_argument("--rounds", type=int, default=3,
                   help="rounds per wire format")
    p.add_argument("--cross-devices", type=int, default=2_000)
    p.add_argument("--benchmarking-devices", type=int, default=1,
                   help="q_i per grade (the quickstart's 1; 0 runs every "
                        "aggregation on buffer rows alone)")
    p.add_argument("--kernel-only", action="store_true",
                   help="build and check the kernels, skip the round and "
                        "serving phases")
    p.add_argument("--serving-only", action="store_true",
                   help="skip the federated-round phases (1-3)")
    p.add_argument("--ssm-only", action="store_true",
                   help="build, then run the SSD kernel phase (7), zamba2's "
                        "attention shapes and the SSM phases (8-9) only")
    p.add_argument("--profile", action="store_true",
                   help="profile the federated slice's rounds 1 and 2 "
                        "instead")
    p.add_argument("--compare-with", metavar="DIR",
                   help="time the decode and scan kernels of the checkout "
                        "at DIR against this one's, in turns, instead")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.compare_with:
        compare_kernels(args.compare_with)
        log(card)
        return 0
    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS)
    log(f"built {', '.join(lib.name for lib in libs.values())} in "
        f"{time.perf_counter() - t0:.1f}s (one nvcc per source, in parallel)")
    for name in KERNELS:
        log(f"--- {name}: ptxas")
        log("\n".join(line for line in _build.BUILD_LOGS.get(name, "")
                      .splitlines() if "Used" in line or "spill" in line))
    ptxas = {name: ptxas_summary(name) for name in ("decode_attention",
                                                      "ssd_scan")}
    log(json.dumps({"ptxas": ptxas}))
    log(json.dumps({"tensor_core_sass": tensor_core_sass(libs)}))
    if args.profile:
        run_slice(dev, args.devices, dim=CONFIG.dim, cohort=COHORT,
                  rounds=max(3, args.rounds), bench=args.benchmarking_devices,
                  profiler=RoundProfiler(card))
        log(card)
        return 0

    entries = []
    if args.ssm_only:
        t0 = time.perf_counter()
        ssd_entry, ssd_checked = ssd_cases(dev)
        _, dec_checked = decode_cases(dev, [DECODE_ZAMBA])
        _, flash_checked = flash_cases(dev, [FLASH_ZAMBA])
        log(f"ssd and zamba2 attention kernel phases passed in "
            f"{time.perf_counter() - t0:.1f}s")
        ssd_entry["launches"] = None
        if not args.kernel_only:
            ssm = ssm_phases(dev, ssd_checked | dec_checked | flash_checked,
                             card)
            ssd_entry["launches"] = sum(v["ssd_scan"] for v in ssm.values())
        entries.append(ssd_entry)
    if not (args.serving_only or args.ssm_only):
        _, _, plan = calibrated_plan(
            grade_specs(args.devices, args.benchmarking_devices))
        rows = chunk_rows(plan, COHORT)
        log(f"chunk rows of the round's update buffers: {rows}")
        t0 = time.perf_counter()
        entry, checked = kernel_phase(dev, rows)
        log(f"kernel phase passed in {time.perf_counter() - t0:.1f}s")
        entry["launches"] = None
        if not args.kernel_only:
            t0 = time.perf_counter()
            res = slice_phase(dev, args.devices, args.rounds, checked,
                              args.benchmarking_devices)
            entry["launches"] = res["launches"]
            log(f"slice phase passed in {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            cross_check_phase(args.cross_devices, args.rounds)
            log(f"cross-check phase passed in "
                f"{time.perf_counter() - t0:.1f}s")
        entries.append(entry)
    if not args.ssm_only:
        t0 = time.perf_counter()
        dec_entry, dec_checked = decode_cases(dev)
        flash_entry, flash_checked = flash_cases(dev)
        log(f"attention kernel phase passed in "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        ssd_entry, ssd_checked = ssd_cases(dev)
        log(f"ssd kernel phase passed in {time.perf_counter() - t0:.1f}s")
        for e in (dec_entry, flash_entry, ssd_entry):
            e["launches"] = None
        if not args.kernel_only:
            t0 = time.perf_counter()
            srv = serving_phase(dev, dec_checked | flash_checked, card)
            log(f"serving phase passed in {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
            serving_cross_check(srv["params"], srv["cfg"], srv["prompts"])
            log(f"serving cross-check passed in "
                f"{time.perf_counter() - t0:.1f}s")
            llama = srv["launches"]
            del srv
            torch.cuda.empty_cache()
            ssm = ssm_phases(dev, dec_checked | flash_checked | ssd_checked,
                             card)
            # Each path's own count, read just after it ran, summed; the
            # flash entry is the tensor-core kernel's.
            for e, key in ((dec_entry, "decode_attention"),
                           (flash_entry, "flash_attention_wgmma")):
                e["launches"] = llama[key] + sum(v[key] for v in ssm.values())
            ssd_entry["launches"] = sum(v["ssd_scan"] for v in ssm.values())
        entries += [dec_entry, flash_entry, ssd_entry]
    for e in entries:
        if ptxas.get(e["name"]):
            e["ptxas"] = ptxas[e["name"]]
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
