"""BENCHMARK.json against the contract's shape, every cell rehearsed at
smoke size, and a new cell added by files alone."""
import hashlib
import json
import re
import shutil

import pytest
from conftest import BENCH, ROOT, add_hybrid, rehearse, write_smoke_layout

from harness.cli import TraceData, per_layer
from harness.layout import Layout
from harness.trace import Window

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_has_the_contracts_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1] == "bench/run.py"
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert 1 <= SPEC["run_seconds"] <= 51
    # A full check of 24 cells fits the driver's 43 200 s.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    layout = Layout(ROOT, [BENCH])
    for w in SPEC["workloads"]:
        cell = layout.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert all(m["moves"] in e2e for m in cell.per_layer)
        for m in cell.per_layer:
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert w["chips"] == 1
        assert {"driver"} <= set(cell.traffic) and cell.cell["limits"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_rehearses_and_prints_the_contracts_last_line(
        cell, tmp_path, capsys):
    names = write_smoke_layout(tmp_path)
    rc, line, out, err = rehearse(tmp_path, names[cell], capsys=capsys)
    assert rc == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True and line["failed"] == 0, err[-3000:]
    assert line["metrics"] == {}  # a rehearsal writes no device metric
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and "limit" in t for t in tail)


def test_a_new_configuration_traffic_cell_and_metric_come_as_files_alone(
        tmp_path, capsys):
    names = write_smoke_layout(tmp_path)
    b = tmp_path / "bench"
    base = json.loads((b / "configs" / "mamba2_1_3b-smoke.json").read_text())
    (b / "configs" / "mamba2-new.json").write_text(
        json.dumps(dict(base, name="mamba2-new")))
    tr = json.loads((b / "traffic" / "train-4k-smoke.json").read_text())
    (b / "traffic" / "train-short.json").write_text(
        json.dumps(dict(tr, seq_len=32, microbatches=4)))
    cell = json.loads((b / "cells" / f"{names['mamba2-1.3b.train-4k']}.json")
                      .read_text())
    (b / "cells" / "mamba2-new.train-short.json").write_text(json.dumps(cell))
    (b / "metrics").mkdir()
    (b / "metrics" / "kernels_seen.train.py").write_text(
        "UNIT = 'launches'\n\n\ndef read(t):\n"
        "    return float(len(t.window.kernels))\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mamba2-new", "source": "x",
                            "file": "bench/configs/mamba2-new.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "mamba2-new.train-short",
                              "config": "mamba2-new", "traffic": "train-short",
                              "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("mamba2-new.train-short")
    spec["per_layer"].append({"name": "kernels_seen.train", "unit": "launches",
                              "better": "lower", "source": "device_trace",
                              "layer": "training step",
                              "moves": "train_tokens_per_s",
                              "workloads": ["mamba2-new.train-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line, _, err = rehearse(tmp_path, "mamba2-new.train-short",
                                capsys=capsys)
    assert rc == 0 and line["correct"] is True, err[-3000:]
    new = Layout(tmp_path, [b, BENCH]).cell("mamba2-new.train-short")
    assert [m["name"] for m in new.per_layer] == ["kernels_seen.train"]
    win = Window(kernels=[("k", 0.0, 0.1)] * 3, wall_s=1.0, samples=[],
                 start_s=0.0, end_s=1.0)
    data = TraceData(window=win, units=1, unit_wall_s=1.0,
                     model_flops_per_unit=1.0, shapes={}, counters={},
                     peaks=None)
    assert per_layer(new, data) == {"kernels_seen.train": {
        "value": 3.0, "unit": "launches"}}


def _bench_digest() -> dict:
    return {str(p.relative_to(BENCH)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(BENCH.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_second_architecture_comes_as_files_alone(cell, tmp_path, capsys):
    """The port's hybrid (Mamba2 layers and a shared attention block) added
    as an architecture module, a configuration and a cell under each mix,
    with no file of the benchmark edited, rehearses correct."""
    before = _bench_digest()
    names = write_smoke_layout(tmp_path)
    hybrid = add_hybrid(tmp_path, names)[cell]
    rc, line, _, err = rehearse(tmp_path, hybrid, capsys=capsys)
    assert rc == 0 and line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and line["checks"], line
    new = Layout(tmp_path, [tmp_path / "bench", BENCH]).cell(hybrid)
    assert new.model.__file__ == str(tmp_path / "bench" / "models" /
                                     "zamba2.py")
    assert _bench_digest() == before


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    layout = Layout(ROOT, [BENCH])
    cell = layout.cell("mamba2-1.3b.train-4k")
    win = Window(kernels=[("other", 0.0, 0.1)], wall_s=1.0, samples=[],
                 start_s=0.0, end_s=1.0)
    data = TraceData(window=win, units=1, unit_wall_s=1.0,
                     model_flops_per_unit=1.0, shapes={}, counters={},
                     peaks={"bf16_flops_per_s": 1.0, "hbm_bytes_per_s": 1.0})
    got = per_layer(cell, data)
    assert "ssd_scan_roofline.train" not in got
    assert {"launches_per_step.train", "device_idle_share.train",
            "mfu.train"} <= set(got)


def test_a_checkout_of_the_benchmark_alone_exits_with_no_result(tmp_path):
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
