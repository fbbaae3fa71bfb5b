"""Readings that the limits of ``correct`` and the serving rates are set
from (on the card; never run by the benchmark's own runs).

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--rates 4,5,6]

For each seed, one JSON line per reading: ``program`` (the timed path's
numbers against the reference), ``control`` (the reference with its weight
products and the scan's operands in float8, the nearest precision below
the configurations' bfloat16, put in the program's place) and, for a
training cell,
``half_batch`` (the program with half of each batch left out and the mean
taken over the rest).  A serving cell serves ``check_requests`` requests at
its own rate and compares all of them; ``--rates`` instead sweeps the open
loop over those request rates for ``--seconds`` each (the knee).
"""
import argparse
import gc
import json
import os
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "kernels")

from harness import checks  # noqa: E402
from harness.cli import Run  # noqa: E402
from harness.layout import Layout  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x] if s else []


def _emit(d):
    print(json.dumps(d), flush=True)


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def training(cell, dev, args, train):
    from reference.lowp import fp8_matmul
    from reference.matmul import plain_matmul

    for seed in _ints(args.seeds):
        r = Run(cell=cell, seed=seed, seconds=0, trace=False,
                t0=time.perf_counter(), device=dev, rehearsal=False)
        t = time.perf_counter()
        state, step, prog, spec = train.prepare(r)
        del state, step
        _free()
        names = train.leaf_names(spec)
        t_prog = time.perf_counter() - t
        ref = train.reference(cell, seed, dev, spec, plain_matmul)
        _free()
        t_ref = time.perf_counter() - t - t_prog
        n = checks.training(prog, ref, names)
        _emit({"seed": seed, "kind": "program", "prog_s": t_prog,
               "ref_s": t_ref, **n, "losses": prog["losses"],
               "ref_losses": ref["losses"]})
        if seed in _ints(args.control_seeds):
            ctl = train.reference(cell, seed, dev, spec, fp8_matmul)
            _free()
            _emit({"seed": seed, "kind": "control",
                   **checks.training(ctl, ref, names)})
        if seed in _ints(args.fault_seeds):
            r.fault = "half_batch"
            state, step, bad, _ = train.prepare(r)
            del state, step
            _free()
            _emit({"seed": seed, "kind": "half_batch",
                   **checks.training(bad, ref, names)})


def serving(cell, dev, args, serve):
    import numpy as np

    from reference.lowp import fp8_matmul
    from reference.matmul import plain_matmul

    tr = cell.traffic
    B = tr["batch_size"]
    if args.rates:
        for rate in [float(x) for x in args.rates.split(",")]:
            n = B * max(2, int(args.seconds * rate / B))
            r = Run(cell=cell, seed=_ints(args.seeds)[0], seconds=0,
                    trace=False, t0=time.perf_counter(), device=dev,
                    rehearsal=False)
            srv = serve.Server(r, B + n)
            srv.batch()
            lat, last = serve._open_loop(srv, rate, n)
            _emit({"rate_per_s": rate, "requests": n,
                   "p50_s": float(np.median(lat)),
                   "p95_s": float(np.percentile(lat, 95)),
                   "max_s": max(lat), "last_done_s": last,
                   "arrivals_s": n / rate,
                   "backlog_s": last - (n - 1) / rate})
            del srv
            _free()
        return
    for seed in _ints(args.seeds):
        r = Run(cell=cell, seed=seed, seconds=0, trace=False,
                t0=time.perf_counter(), device=dev, rehearsal=False)
        n = B * (-(-tr["check_requests"] // B))
        srv = serve.Server(r, B * tr["warmup_batches"] + n)
        for _ in range(tr["warmup_batches"]):
            srv.batch()
        first = len(srv.server.records)
        serve._open_loop(srv, cell.cell["rate_per_s"], n)
        records, prompts, spec = srv.server.records, srv.prompts, srv.spec
        del srv
        _free()
        rows = list(range(first, len(records)))
        lowp = fp8_matmul if seed in _ints(args.control_seeds) else None
        t = time.perf_counter()
        g = serve.served_gaps(cell, seed, dev, spec, prompts, records, rows,
                              plain_matmul, lowp)
        _emit({"seed": seed, "kind": "program", "requests": len(rows),
               "served_gap": g["served_gap"],
               "ref_s": time.perf_counter() - t})
        if lowp is not None:
            _emit({"seed": seed, "kind": "control",
                   "served_gap": g["control_gap"]})
        _free()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args()
    import torch

    layout = Layout(ROOT, [BENCH])
    cell = layout.cell(args.workload)
    driver = layout.load_module("drivers", cell.traffic["driver"])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    torch.set_num_threads(4)
    if cell.traffic["driver"] == "train":
        training(cell, dev, args, driver)
    else:
        serving(cell, dev, args, driver)


if __name__ == "__main__":
    main()
