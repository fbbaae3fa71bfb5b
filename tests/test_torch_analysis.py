"""The port's simcheck lint and sanitizers against the reference's
(``tests/test_analysis.py``): the same findings on the reference's fixture
corpus rule by rule, torch's host syncs under R003, a clean tree, the
CLI's exit codes, and use-after-recycle poisoning of recycled rounds."""
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint as ref_lint  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.analysis import lint, sanitizers  # noqa: E402
from repro_torch.core.devicemodel import GRADES, DeviceFleet  # noqa: E402
from repro_torch.core.simulation import (  # noqa: E402
    DeviceTier,
    HybridSimulation,
    LogicalTier,
)
from repro_torch.data.synthetic_ctr import make_federated_ctr  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.models import ctr as tctr  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "lint_fixtures"
SRC = str(REPO / "src")

# The reference's fixtures of the rules the port keeps.
PORT_FIXTURES = [
    (os.path.join("core", "bad_r002.py"), "R002"),
    ("bad_r003.py", "R003"),
    ("bad_r004.py", "R004"),
    ("bad_r005.py", "R005"),
]


# --------------------------------------------------------------------------
# lint: the reference's findings, rule by rule


@pytest.mark.parametrize("rel,rule", PORT_FIXTURES,
                         ids=[rule for _, rule in PORT_FIXTURES])
def test_fixture_findings_equal_the_reference_lint(rel, rule):
    path = FIXTURES / rel
    got = lint.lint_file(path)
    want = ref_lint.lint_file(path)
    assert got and [(f.rule, f.line) for f in got] == [
        (f.rule, f.line) for f in want]
    assert {f.rule for f in got} == {rule}
    for f in got:
        assert str(f).startswith(f"{path}:{f.line}: {rule} ")


@pytest.mark.parametrize("rel", ["bad_r001.py", "bad_r006.py"])
def test_jax_only_rules_are_left_out(rel):
    """R001 (jit donation) and R006 (cohort-jit reshapes) are about
    ``jax.jit``, which the port does not have: the reference fires, the
    port does not know the rule."""
    assert ref_lint.lint_file(FIXTURES / rel)
    assert lint.lint_file(FIXTURES / rel) == []
    assert set(lint.RULES) == {"R002", "R003", "R004", "R005"}


def _hot(body: str) -> str:
    return ("import torch\n"
            "from repro_torch.analysis.sanitizers import hot_path\n"
            "@hot_path\n"
            "def step(x):\n" + textwrap.indent(body, "    "))


TORCH_SYNCS = ["v = x.item()", "v = x.tolist()", "v = x.cpu()",
               "v = x.numpy()", "torch.cuda.synchronize()", "v = int(x[0])",
               "v = float(x.sum())", "v = bool((x > 0).any())",
               "v = np.asarray(x)"]


@pytest.mark.parametrize("stmt", TORCH_SYNCS)
def test_torch_host_syncs_fire_r003(stmt):
    findings = lint.lint_source(_hot(stmt + "\nreturn x\n"))
    assert [(f.rule, f.line) for f in findings] == [("R003", 5)]
    assert "in @hot_path step()" in findings[0].message


def test_shape_math_and_nested_defs_are_exempt_from_r003():
    src = _hot("n = int(x.shape[0]) + int(x.size(1)) + len(x)\n"
               "b = bool(x.ndim)\n"
               "def emit(row):\n"
               "    return float(row.sum()), row.tolist(), row.cpu()\n"
               "return n, b\n")
    assert lint.lint_source(src) == []


def test_suppression_comments():
    src = _hot("return x.tolist()")
    assert [f.rule for f in lint.lint_source(src)] == ["R003"]
    assert lint.lint_source(src + "  # simcheck: ok") == []
    assert lint.lint_source(src + "  # simcheck: ok[R003]") == []
    # A suppression naming a different rule does not apply.
    assert [f.rule for f in
            lint.lint_source(src + "  # simcheck: ok[R002]")] == ["R003"]


def test_port_lint_over_src_and_tests_is_clean():
    findings = lint.lint_paths([REPO / "src", REPO / "tests"])
    assert findings == [], "\n".join(str(f) for f in findings)
    assert not any("lint_fixtures" in f.path
                   for f in lint.lint_paths([REPO / "tests"]))


def test_cli_exit_codes_match_the_reference(capsys):
    for mod in (lint, ref_lint):
        assert mod.main([str(REPO / "src"), str(REPO / "tests")]) == 0
        assert "simcheck: clean" in capsys.readouterr().out
        assert mod.main([str(FIXTURES / "bad_r003.py")]) == 1
        out = capsys.readouterr().out
        assert "R003" in out and "2 finding(s) (R003=2)" in out
        # The R003 fixture has no R005 problem: that subset lints clean.
        assert mod.main(["--rules", "R005",
                         str(FIXTURES / "bad_r003.py")]) == 0
        capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        lint.main(["--rules", "R001", str(FIXTURES / "bad_r001.py")])
    assert e.value.code == 2


def test_lint_cli_imports_no_torch():
    """``python -m repro_torch.analysis.lint`` stays stdlib-only: the
    package re-exports ``hot_path`` and ``sanitizers`` lazily."""
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["lint", %r]
        try:
            runpy.run_module("repro_torch.analysis.lint", run_name="__main__")
        except SystemExit as e:
            print("EXIT", e.code)
        print("TORCH", "torch" in sys.modules)
    """ % os.path.join(SRC, "repro_torch", "analysis"))
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, check=True).stdout
    assert "EXIT 0" in out and "TORCH False" in out, out


# --------------------------------------------------------------------------
# sanitizers: use-after-recycle poisoning


def _small_buffer():
    return T.UpdateBuffer.from_stacked({"w": torch.ones((3, 2, 2))})


def test_poison_recycled_raises_on_leaf_access():
    buf = _small_buffer()
    handle = buf.handle(1)
    sanitizers.poison_recycled(buf)
    assert type(buf).__simdc_recycled__
    assert isinstance(buf, T.UpdateBuffer)  # still the same nominal type
    with pytest.raises(sanitizers.UseAfterRecycleError):
        buf.leaves2d
    with pytest.raises(sanitizers.UseAfterRecycleError):
        buf.materialize_row(0)
    with pytest.raises(sanitizers.UseAfterRecycleError):
        handle.materialize()
    # Layout metadata stays readable — only the reused leaves are fenced.
    assert buf.num_rows == 3
    assert buf.row_nbytes == 16


def test_poison_recycled_is_idempotent_and_caches_classes():
    a, b = _small_buffer(), _small_buffer()
    sanitizers.poison_recycled(a)
    cls = type(a)
    sanitizers.poison_recycled(a)
    sanitizers.poison_recycled(b)
    assert type(a) is cls and type(b) is cls
    assert issubclass(cls, sanitizers.SanitizerError) is False
    assert issubclass(sanitizers.UseAfterRecycleError,
                      sanitizers.SanitizerError)


def _recycled_rounds(armed: bool, rounds: int = 3):
    """The quickstart's two-grade plan at 16 records x dim 64, recycled f32
    rounds; a handle of a round-0 device-tier buffer is taken before round
    1 and read after it."""
    specs = quickstart._specs()
    cal = T.RuntimeCalibrator()
    for g in ("High", "Low"):
        fleet = DeviceFleet(GRADES[g], 64, seed=7)
        for r in range(3):
            cal.observe_fleet(fleet.run_round(r))
    plan = T.RoundPlan.from_allocation(
        T.solve_allocation(specs, cal.runtimes_for(specs)), specs)
    batches, counts = {}, {}
    for i, spec in enumerate(specs):
        data = make_federated_ctr(num_devices=spec.num_devices,
                                  records_per_device=16, dim=64, seed=i)
        X, Y, c = data.stacked_shards(np.arange(spec.num_devices), 16)
        mask = (np.arange(16)[None] < c[:, None]).astype(np.float32)
        batches[spec.grade] = {"x": X, "y": Y, "mask": mask}
        counts[spec.grade] = c
    local = tctr.make_local_train_fn(lr=1e-3, epochs=10)
    svc = T.AggregationService(tctr.lr_init(64, device="cpu"),
                               trigger=T.SampleThresholdTrigger(24 * 16 // 2))
    flow = T.DeviceFlow(svc)
    flow.register_task(0, T.AccumulatedStrategy(thresholds=(1,)))
    sim = HybridSimulation(
        LogicalTier(local, cohort_size=16, device="cpu"),
        tiers={g: DeviceTier(local, GRADES[g], device="cpu")
               for g in ("High", "Low")},
        deviceflow=flow, recycle_buffers=True)
    params, stale = [], {}
    with sanitizers.override(armed):
        for rnd in range(rounds):
            if rnd == 1:
                buf = next(b for bufs in sim._retired.values() for b in bufs)
                stale["handle"] = buf.handle(0)
                stale["row"] = buf.materialize_row(0)
            sim.run_plan_round(
                task_id=0, round_idx=rnd, global_params=svc.global_params,
                plan=plan, grade_batches=batches, grade_num_samples=counts,
                rng=torch.Generator().manual_seed(rnd), calibrator=cal)
            params.append({k: v.clone() for k, v in svc.global_params.items()})
            if rnd == 1:
                try:
                    stale["late"] = stale["handle"].materialize()
                except sanitizers.UseAfterRecycleError:
                    stale["late"] = "raised"
    return params, stale, flow.shelf(0).total_bytes_dispatched


def test_armed_recycled_rounds_equal_unarmed_and_a_stale_handle_raises():
    armed, stale_a, bytes_a = _recycled_rounds(True)
    unarmed, stale_u, bytes_u = _recycled_rounds(False)
    assert bytes_a == bytes_u
    for pa, pu in zip(armed, unarmed):
        for k in pa:
            assert torch.equal(pa[k], pu[k]), k
    assert stale_a["late"] == "raised"
    # Unarmed, the stale handle silently reads round 1's rows.
    assert stale_u["late"] != "raised"
    assert not torch.equal(stale_u["late"]["w"], stale_u["row"]["w"])
