"""CPU tests of the benchmark (``python -m pytest bench/tests``).

They run the harness at smoke size on the CPU, in its rehearsal mode (no
device metric is written), and compare the reference with the port's CPU
path: the only place the port is imported beside the reference.  Tests
marked ``cuda`` need the card and skip here.
"""
import json
import pathlib
import shutil
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FIXTURES = BENCH / "tests" / "fixtures"
HYBRID = "zamba2-1.2b-smoke"  # fixtures/<HYBRID>.json, fixtures/zamba2.py
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def smoke_config(name: str) -> dict:
    """The cell's configuration at the port's smoke widths (its registry's
    ``SMOKE_CONFIG``)."""
    c = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c.update(name=f"{c['arch']}-smoke", smoke=True, d_model=64, vocab_size=512,
             d_state=16, headdim=16, chunk_size=16, num_hidden_layers=3)
    return c


SMOKE_TRAFFIC = {
    "train-4k": dict(seq_len=64, microbatches=2, microbatch_size=2),
    "prefill-4k": dict(batch_size=2, prompt_len=48, check_requests=4,
                       reference_batch=2),
}


def write_smoke_layout(root: pathlib.Path, limits: dict | None = None) -> dict:
    """A checkout root holding ``BENCHMARK.json`` and, under ``bench/``,
    smoke-size copies of every cell's configuration, traffic and cell files
    (found before the benchmark's own); returns ``{cell: its smoke name}``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = root / "bench"
    for d in ("configs", "traffic", "cells"):
        (b / d).mkdir(parents=True, exist_ok=True)
    names, configs, workloads = {}, [], []
    for c in spec["configs"]:
        sc = smoke_config(c["name"])
        (b / "configs" / f"{sc['name']}.json").write_text(json.dumps(sc))
        configs.append(dict(c, name=sc["name"],
                            file=f"bench/configs/{sc['name']}.json"))
    for t in {w["traffic"] for w in spec["workloads"]}:
        tr = json.loads((BENCH / "traffic" / f"{t}.json").read_text())
        tr.update(SMOKE_TRAFFIC[t])
        (b / "traffic" / f"{t}-smoke.json").write_text(json.dumps(tr))
    for w in spec["workloads"]:
        cfg = smoke_config(w["config"])["name"]
        name = f"{cfg}.{w['traffic']}-smoke"
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        if "rate_per_s" in cell:
            cell["rate_per_s"] = 200.0
        if limits:
            cell["limits"].update(limits)
        (b / "cells" / f"{name}.json").write_text(json.dumps(cell))
        workloads.append(dict(w, name=name, config=cfg,
                              traffic=f"{w['traffic']}-smoke"))
        names[w["name"]] = name
    smoke = {w["name"]: w for w in workloads}

    def rename(m):
        if "workloads" in m:
            m = dict(m, workloads=[names[x] for x in m["workloads"]])
        return m

    out = dict(spec, configs=configs, workloads=list(smoke.values()),
               end_to_end=[rename(m) for m in spec["end_to_end"]],
               per_layer=[rename(m) for m in spec["per_layer"]])
    (root / "BENCHMARK.json").write_text(json.dumps(out))
    return names


def add_hybrid(root: pathlib.Path, names: dict) -> dict:
    """Adds to a smoke layout (``write_smoke_layout``'s ``names``) a second
    architecture as files alone: the port's hybrid at smoke size
    (``fixtures/zamba2.py`` as ``models/zamba2.py`` and its configuration),
    a cell of it under each smoke traffic mix with the mamba2 cell's limits,
    and their ``BENCHMARK.json`` entries; returns ``{mamba2 cell: the
    hybrid's cell}``."""
    b = root / "bench"
    (b / "models").mkdir(exist_ok=True)
    shutil.copy(FIXTURES / "zamba2.py", b / "models" / "zamba2.py")
    shutil.copy(FIXTURES / f"{HYBRID}.json", b / "configs" / f"{HYBRID}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": HYBRID, "source": "arXiv:2411.15242",
                            "file": f"bench/configs/{HYBRID}.json",
                            "reduced": [], "why": "the port's hybrid"})
    out = {}
    for w in list(spec["workloads"]):
        if w["name"] not in names.values():
            continue
        name = f"{HYBRID}.{w['traffic']}"
        shutil.copy(b / "cells" / f"{w['name']}.json",
                    b / "cells" / f"{name}.json")
        spec["workloads"].append(dict(w, name=name, config=HYBRID))
        for m in spec["end_to_end"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
        out[next(k for k, v in names.items() if v == w["name"])] = name
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return out


def rehearse(root, workload, seed=2147483659, fault=None, capsys=None):
    """One rehearsal run of ``workload`` under ``root``: (exit code, the
    last line of standard output parsed, standard error)."""
    import time

    from harness.cli import main

    rc = main(["--workload", workload, "--seed", str(seed), "--seconds",
               "0.5", "--trace", "0"], t0=time.perf_counter(), root=root,
              dirs=[pathlib.Path(root) / "bench"], device="cpu", fault=fault)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), out, err


@pytest.fixture
def smoke_root(tmp_path):
    names = write_smoke_layout(tmp_path)
    return tmp_path, names
