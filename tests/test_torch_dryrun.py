"""The port's dry run (``launch/dryrun.py``) against the reference's
(``src/repro/launch/dryrun.py``, ``tests/test_distribution.py:127``): cells
traced on the meta device for one rank of a fake 256-rank process group,
in subprocesses (each dry run starts its own group)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.configs.registry import lm_arch_ids  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
H100_HBM_BYTES = 80e9
CELLS = ("prefill_32k", "decode_32k")


def _python(*parts: str, env=None) -> subprocess.CompletedProcess:
    """Runs the code of ``parts`` (each dedented on its own) in a fresh
    interpreter."""
    code = "".join(textwrap.dedent(p) for p in parts)
    return subprocess.run(
        [sys.executable, "-c", code],
        env=dict(os.environ, PYTHONPATH=SRC, **(env or {})),
        capture_output=True, text=True, timeout=600, cwd=ROOT)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """``main()`` for llama3.2-3b's prefill and decode cells at 16x16, as
    the CLI runs it: its printed lines and each cell's record."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    res = _python(f"""
        import sys
        from repro_torch.launch import dryrun
        rcs = [dryrun.main(["--arch", "llama3.2-3b", "--shape", s,
                            "--out", {str(out)!r}]) for s in {CELLS!r}]
        print("RCS", rcs)
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    recs = {s: json.loads((out / f"llama3_2_3b__{s}__16_16.json").read_text())
            for s in CELLS}
    return res.stdout, recs


@pytest.mark.parametrize("shape", CELLS)
def test_run_cell_passes_and_records_are_sane(records, shape):
    stdout, recs = records
    assert "RCS [0, 0]" in stdout
    assert f"PASS  llama3_2_3b x {shape} x 16x16" in stdout
    rec = recs[shape]
    assert rec["ok"] and (rec["arch"], rec["shape"], rec["mesh"]) == (
        "llama3_2_3b", shape, "16x16")
    assert rec["plan"] == {"tp": 8, "sp": 2, "kv_dup": 1, "fsdp": False}
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes_accessed"] > 0
    mem = rec["memory"]
    # The H100's 80 GB: what the rank holds must fit.
    assert 0 < mem["argument_bytes"] < H100_HBM_BYTES
    assert mem["argument_bytes"] + mem["temp_bytes"] < H100_HBM_BYTES
    counts = rec["collective_op_counts"]
    assert set(counts) == {"all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"}
    # tp = 8: every layer's two row-parallel products are all-reduced.
    assert counts["all-reduce"] >= 2 * 28
    # Decode: the cache's sequence splits over sp, so each layer runs K2p
    # on the rank's block and combines the partials.
    kernel = {"prefill_32k": "flash_attention",
              "decode_32k": "decode_attention_partial"}[shape]
    assert rec["kernels"][kernel]["calls"] == 28
    assert rec["seconds"]["trace"] <= rec["seconds"]["total"]


def test_decode_cell_reads_the_whole_cache(records):
    """The decode cell decodes the last token of a full 32k cache: each
    layer's K2p reads every row of the rank's block of it (half the
    sequence, sp = 2), and no cache block is all-gathered: the ranks
    combine their partials with two all-reduces per layer, of m and of the
    packed (o, l)."""
    rec = records[1]["decode_32k"]
    b_local = 128 // 16  # batch over data (16)
    rows = b_local * 32768 // 2
    per_call = rec["kernels"]["decode_attention_partial"]["flops"] // 28
    # 4 d flops per (row, query head): 3 of the 24 heads on each tp rank.
    assert per_call == 4 * rows * 3 * 128
    assert "decode_attention" not in rec["kernels"]
    # What the combine moves per layer: m, then (o, l), f32, for the
    # rank's 8 sequences x 3 heads; far under one layer's cache block
    # (8 x 16384 rows x 1 kv head x 128 x 2 bytes x 2 = 67 MB).
    combine = 28 * 4 * b_local * 3 * (1 + 128 + 1)
    assert rec["collective_bytes"]["all-gather"] < 1e6
    assert rec["collective_bytes"]["all-reduce"] >= combine


def test_cell_supported_equals_the_reference():
    res = _python("""
        import json
        from repro.configs.base import SHAPES
        from repro.configs.registry import lm_arch_ids
        from repro.launch import dryrun
        print(json.dumps({a: {s: dryrun.cell_supported(a, s)[0]
                              for s in SHAPES} for a in lm_arch_ids()}))
    """, env={"JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    got = {a: {s: dryrun.cell_supported(a, s)[0] for s in SHAPES}
           for a in lm_arch_ids()}
    assert got == want
    assert dryrun.SKIPPED_LONG and all(
        not got[a]["long_500k"] for a in dryrun.SKIPPED_LONG)


_TINY = """
    import dataclasses, json, sys
    sys.path.insert(0, {tests!r})
    from test_roofline import TINY, SHAPE
""".format(tests=os.path.join(ROOT, "tests"))


def test_argument_bytes_match_the_reference():
    """TINY at the (2, 4) plan (tp 4, kv_dup 2, FSDP): the port's
    ``argument_bytes`` (rank 0's blocks of the placed meta inputs) against
    the reference's ``memory_analysis().argument_size_in_bytes`` on 8 host
    devices.  Train and prefill are equal; the decode step's differ by the
    reference cache's position, an int32 per layer (the port's is a host
    int)."""
    ref = _python(_TINY, """
        import jax
        from repro.configs.base import ShapeConfig, choose_mesh_plan
        from repro.distribution.sharding import derive_logical_mesh
        from repro.distribution import steps
        lmesh = derive_logical_mesh(jax.make_mesh((2, 4), ("data", "model")),
                                    choose_mesh_plan(TINY, model_axis=4))
        out = {}
        for kind, build, shape in (
                ("train", steps.build_train_step, SHAPE),
                ("prefill", steps.build_prefill_step,
                 ShapeConfig("p", 64, 8, "prefill")),
                ("decode", steps.build_serve_step,
                 ShapeConfig("d", 64, 8, "decode"))):
            fn, in_sh, out_sh, specs = build(TINY, lmesh, shape)
            with lmesh.mesh:
                c = jax.jit(fn, in_shardings=in_sh,
                            out_shardings=out_sh).lower(*specs).compile()
            out[kind] = c.memory_analysis().argument_size_in_bytes
        print(json.dumps(out))
    """, env={"JAX_PLATFORMS": "cpu",
              "XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    assert ref.returncode == 0, ref.stderr[-3000:]
    port = _python(_TINY, """
        from repro_torch.configs.base import ModelConfig, ShapeConfig
        from repro_torch.configs.base import choose_mesh_plan
        from repro_torch.distribution.sharding import derive_logical_mesh
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        cfg = ModelConfig(**{f.name: getattr(TINY, f.name)
                             for f in dataclasses.fields(TINY)})
        dryrun.start_world(8)
        lmesh = derive_logical_mesh(make_host_mesh(2, 4, device="cpu"),
                                    choose_mesh_plan(cfg, model_axis=4))
        out = {}
        for kind, shape in (
                ("train", ShapeConfig("calib", 64, 4, "train",
                                      microbatches=2)),
                ("prefill", ShapeConfig("p", 64, 8, "prefill")),
                ("decode", ShapeConfig("d", 64, 8, "decode"))):
            fn, inputs = dryrun.cell_program(cfg, lmesh, shape)
            out[kind] = dryrun._local_bytes(inputs)
        dryrun.stop_world()
        print(json.dumps(out))
    """)
    assert port.returncode == 0, port.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got = json.loads(port.stdout.strip().splitlines()[-1])
    assert got["train"] == want["train"]
    assert got["prefill"] == want["prefill"]
    layers = 6
    assert want["decode"] - got["decode"] == 4 * layers


def test_import_starts_no_process_group():
    res = _python("""
        import sys
        import torch.distributed as dist
        import repro_torch.launch.dryrun
        import repro_torch.analysis.lint, repro_torch.roofline.op_analysis
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
        print("INIT", dist.is_initialized(), "BAD", bad)
    """)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "INIT False BAD []" in res.stdout
