"""The import guard, and what a run on a machine without the card does."""
import json
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness import guard


@pytest.mark.parametrize("modules,found", [
    (["repro_torch", "repro_torch.models.mamba2", "torch", "numpy"], []),
    (["repro", "repro.core"], ["repro", "repro.core"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen", "reprox", "jaxtyping"], ["flax.linen"]),
])
def test_guard_compares_top_level_names_whole(modules, found):
    assert guard.forbidden_loaded(modules) == found


def test_a_rehearsed_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A fresh interpreter rehearses one training and one serving cell
    and then lists what the guard forbids."""
    code = f"""
import io, json, pathlib, sys, time, contextlib
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r},
                {str(BENCH / 'tests')!r}]
from conftest import write_smoke_layout
from harness import guard
from harness.cli import main
root = pathlib.Path({str(tmp_path)!r})
names = write_smoke_layout(root)
rcs = []
for w in ("mamba2-1.3b.train-4k", "mamba2-1.3b.prefill-4k"):
    with contextlib.redirect_stdout(io.StringIO()), \\
            contextlib.redirect_stderr(io.StringIO()):
        rcs.append(main(["--workload", names[w], "--seed", "3",
                         "--seconds", "0.3", "--trace", "0"],
                        t0=time.perf_counter(), root=root,
                        dirs=[root / "bench"], device="cpu"))
print(json.dumps({{"rcs": rcs, "forbidden": guard.forbidden_loaded()}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"rcs": [0, 0], "forbidden": []}


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "mamba2-1.3b.train-4k", "--seed", "2147483659",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_reader_that_loads_jax_leaves_the_run_without_a_result(tmp_path):
    """A per-layer metric's reader that imports ``jax`` (a stub here) is
    caught by the guard that runs just before the result line."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    code = f"""
import json, pathlib, sys, time
sys.path[:0] = [{str(tmp_path / 'stub')!r}, {str(BENCH)!r},
                {str(ROOT / 'src')!r}, {str(BENCH / 'tests')!r}]
from conftest import write_smoke_layout
from harness.cli import main
root = pathlib.Path({str(tmp_path / 'root')!r})
names = write_smoke_layout(root)
cell = names["mamba2-1.3b.prefill-4k"]
(root / "bench" / "metrics").mkdir()
(root / "bench" / "metrics" / "loads_jax.serve.py").write_text(
    "import jax  # noqa: F401\\n\\n\\ndef read(t):\\n    return 1.0\\n")
spec = json.loads((root / "BENCHMARK.json").read_text())
spec["per_layer"].append({{"name": "loads_jax.serve", "unit": "launches",
                          "better": "lower", "source": "device_trace",
                          "layer": "serving front end",
                          "moves": "serve_p95_ms", "workloads": [cell]}})
(root / "BENCHMARK.json").write_text(json.dumps(spec))
sys.exit(main(["--workload", cell, "--seed", "3", "--seconds", "0.3",
               "--trace", "0"], t0=time.perf_counter(), root=root,
              dirs=[root / "bench"], device="cpu"))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 3, p.stderr[-3000:]
    assert p.stdout.strip() == ""
    assert "import guard (before the result): forbidden modules loaded: jax" \
        in p.stderr
