#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # where a round's time goes

Three phases; any failure raises and the script exits non-zero:

1. **Kernel.**  Builds ``fed_reduce`` from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` and runs it on the card against its plain
   PyTorch version at every shape the slice's ``RoundPlan`` gives it: each
   distinct cohort-chunk row count (full 8192-row chunks and each ragged
   last chunk) x {the 256-wide ``w`` leaf, the 1-wide ``b`` leaf} x {f32,
   int8 with scales}, plus 8192 x 256 in bf16; zero weights included.
   Checks the error (<= 1e-4 of sum |w||U| per column) and that two
   launches give the same bits, and times kernel, plain version,
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

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit from ``nvidia-smi``, and before that one JSON
line with the kernel's numbers.

``--profile`` runs the slice alone instead: per wire, round 1 under
``torch.profiler`` (device busy time as the union of kernel intervals,
device idle share, device time by kernel) and round 2 under ``cProfile``
(host time by function).  It prints one JSON line per profiled round and
writes the full tables and a Chrome trace of the f32 round under
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
KERNEL_SOURCE = "src/repro_torch/csrc/fed_reduce.cu"
KERNEL_REPLACES = "src/repro/kernels/fed_reduce/fed_reduce.py:41"
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
    results, checked = [], set()
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
        del Us
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

        from torch.autograd import DeviceType

        prof = self.profs.get((wire, "torch"))
        if prof is not None:
            kern = [e for e in prof.events()
                    if getattr(e, "device_type", None) == DeviceType.CUDA]
            busy, cur_s, cur_e = 0.0, None, None  # union of kernel spans, us
            for s, e in sorted((e.time_range.start, e.time_range.end)
                               for e in kern):
                if cur_e is None or s > cur_e:
                    busy += 0.0 if cur_e is None else cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy += 0.0 if cur_e is None else cur_e - cur_s
            by_name: dict[str, list] = {}
            for e in kern:
                rec = by_name.setdefault(e.name, [0.0, 0])
                rec[0] += e.time_range.end - e.time_range.start
                rec[1] += 1
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
            fed = [v for k, v in by_name.items() if "fed_reduce" in k]
            log(json.dumps({"round_profile": {
                "wire": wire, "round": 1, "wall_ms": wall_ms[1],
                "kernels": len(kern), "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / 1e3 / wall_ms[1],
                "fed_reduce_ms": sum(v[0] for v in fed) / 1e3,
                "fed_reduce_partial_launches": sum(
                    v[1] for k, v in by_name.items()
                    if "fed_reduce_partial" in k),
                "top_kernels_ms": [[k[:90], v[0] / 1e3, v[1]]
                                   for k, v in top[:12]],
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
                   help="build and check the kernel, skip the round phases")
    p.add_argument("--profile", action="store_true",
                   help="profile the slice's rounds 1 and 2 instead")
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
    t0 = time.perf_counter()
    lib = _build.build("fed_reduce")
    log(f"built {lib.name} in {time.perf_counter() - t0:.1f}s")
    log(_build.BUILD_LOGS.get("fed_reduce", "").strip())
    if args.profile:
        run_slice(dev, args.devices, dim=CONFIG.dim, cohort=COHORT,
                  rounds=max(3, args.rounds), bench=args.benchmarking_devices,
                  profiler=RoundProfiler(card))
        log(card)
        return 0

    _, _, plan = calibrated_plan(
        grade_specs(args.devices, args.benchmarking_devices))
    rows = chunk_rows(plan, COHORT)
    log(f"chunk rows of the round's update buffers: {rows}")
    t0 = time.perf_counter()
    entry, checked = kernel_phase(dev, rows)
    log(f"kernel phase passed in {time.perf_counter() - t0:.1f}s")
    if not args.kernel_only:
        t0 = time.perf_counter()
        res = slice_phase(dev, args.devices, args.rounds, checked,
                          args.benchmarking_devices)
        entry["launches"] = res["launches"]
        log(f"slice phase passed in {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        cross_check_phase(args.cross_devices, args.rounds)
        log(f"cross-check phase passed in {time.perf_counter() - t0:.1f}s")
    else:
        entry["launches"] = None
    log(json.dumps({"kernels": [entry]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
