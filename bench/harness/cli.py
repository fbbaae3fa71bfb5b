"""``bench/run.py``'s main: one run of one cell.

The cell's driver (named by its traffic file) builds the program from the
seed, warms up, measures for ``--seconds`` (or, with ``--trace 1``, times
and profiles a few steps or batches) and checks what the timed path
produced against the reference.  The harness adds the per-layer metrics
(each read by its own ``metrics/<name>.py``), the device record and the
result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys

from harness import guard
from harness.layout import Cell, Layout


@dataclasses.dataclass
class Run:
    """What a driver is given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: object            # a torch.device
    rehearsal: bool           # CPU: no device metric is written
    fault: "str | None" = None

    def log(self, *a) -> None:
        print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class TraceData:
    """What a per-layer metric's reader reads (see ``metrics/``)."""

    window: object            # harness.trace.Window of the profiled units
    units: int                # steps or batches in the profiled window
    unit_wall_s: float        # host wall per unit, untraced, synchronized
    model_flops_per_unit: float
    shapes: dict              # {kernel: [(work formula args, calls per unit)]}
    counters: dict            # the port's launch counters over the window
    peaks: "dict | None"      # the card's row of yardstick/peaks.json


def parse(argv):
    p = argparse.ArgumentParser(prog="bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def peaks_for(kind: str) -> "dict | None":
    path = pathlib.Path(__file__).resolve().parents[1] / "yardstick" / \
        "peaks.json"
    return json.loads(path.read_text()).get(kind)


def per_layer(cell: Cell, data: TraceData) -> dict:
    """Each per-layer metric of the cell that its reader finds: ``{name:
    {"value", "unit"}}``.  A reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = cell.layout.load_module("metrics", m["name"])
        value = reader.read(data)
        if value is None:
            print(f"per-layer metric {m['name']}: nothing to read",
                  file=sys.stderr)
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(window) -> dict:
    return {"device_ops": [[n[:160], s] for n, s, _ in window.by_name()[:10]],
            "idle_gaps": window.idle_by_host()[:10]}


def main(argv, *, t0: float, root, dirs=None, device=None,
         fault=None) -> int:
    """Runs the cell; returns the exit code.  ``device="cpu"`` is the
    rehearsal the CPU tests drive (``dirs`` adds directories searched
    before the benchmark's own); ``fault`` breaks the timed path for the
    tests that must see ``correct`` come out false."""
    args = parse(argv)
    if not guard.check("start"):
        return 3
    root = pathlib.Path(root).resolve()
    bench = pathlib.Path(__file__).resolve().parents[1]
    layout = Layout(root, [*(dirs or []), root / "bench", bench])
    # The port's kernel builds stay inside this checkout, at a fixed path.
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    cell = layout.cell(args.workload)
    rehearsal = device == "cpu"
    if not rehearsal:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark measures the card only",
                  file=sys.stderr)
            return 4
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 4
    dev = torch.device("cpu") if rehearsal else torch.device("cuda", 0)
    if not rehearsal:
        torch.cuda.set_device(dev)
        torch.cuda.init()
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    driver = layout.load_module("drivers", cell.traffic["driver"])
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), t0=t0, device=dev, rehearsal=rehearsal,
              fault=fault)
    out = driver.run(run)
    correct, checks = out["correct"], out["checks"]
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": {}}
    if rehearsal:
        line["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                          "memory_peak_bytes": 0}
        for m in cell.per_layer:  # loaded, so that the guard sees them
            layout.load_module("metrics", m["name"])
    else:
        kind = torch.cuda.get_device_name(0)
        line["device"] = {"platform": "gpu", "kind": kind,
                          "count": cell.chips,
                          "memory_peak_bytes": int(out["memory_peak_bytes"])}
        if run.trace:
            data = out["trace"]
            data.peaks = peaks_for(kind)
            line["metrics"] = per_layer(cell, data)
            line["device"]["busy_s"] = data.window.busy_s
            line["device"]["window_s"] = data.window.wall_s
            line["breakdown"] = breakdown(data.window)
        else:
            line["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end}
    line["checks"] = checks
    # Last, once every reader has been loaded: no result if the run holds
    # JAX or the JAX package.
    if not guard.check("before the result"):
        return 3
    print(f"correct: {bool(correct)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
