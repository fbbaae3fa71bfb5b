"""The port's spans on the card: inside the benchmark harness's profiled
window (``bench/harness/trace.py`` ``profiled``) tracing is on and a
smoke-size mamba2 step records its spans, the recomputed blocks on the
autograd engine's thread under ``train.backward``; the spans add no device
event to the window; and the syncs counted under ``train.step`` are the
synchronizing operations ``torch.cuda.set_sync_debug_mode("warn")`` reports
for one step.  They skip where CUDA is not available.  This file imports no
JAX:

    python -m pytest -m cuda tests/test_torch_tracing_cuda.py
"""
import importlib.util
import pathlib
import sys
import types
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.distribution.steps import init_train_state  # noqa: E402
from repro_torch.launch.train import make_cloud_step  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402

pytestmark = pytest.mark.cuda

TRACE = pathlib.Path(__file__).resolve().parents[1] / "bench" / "harness" / \
    "trace.py"


def _harness_trace():
    """The benchmark harness's ``trace.py``, loaded from its file (and
    registered, as its dataclass needs)."""
    name = "bench_harness_trace"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, TRACE)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@pytest.fixture
def stepper():
    """A smoke-size mamba2 training step on the card, warmed up once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    cfg = get_config("mamba2_1_3b", smoke=True)
    shape = ShapeConfig("t", 64, 4, "train", microbatches=2)
    pipe = TokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch,
                         seed=0)
    step = make_cloud_step(cfg, shape, pipe, device="cuda")
    holder = {"state": init_train_state(cfg, 0, device="cuda")}

    def run():
        holder["state"], m = step(holder["state"])
        return m
    run()
    torch.cuda.synchronize()
    tracing.reset()
    yield cfg, shape, run
    tracing.reset()


def _step_spans(records):
    """The last ``train.step`` (the profiler's last try) and its spans."""
    unit = max((r for r in records if r.name == "train.step"),
               key=lambda r: r.start)
    under, todo = [unit], [unit.id]
    while todo:
        pid = todo.pop()
        for r in records:
            if r.parent == pid:
                under.append(r)
                todo.append(r.id)
    return unit, under


def test_the_harness_window_turns_tracing_on(stepper):
    cfg, shape, run = stepper
    seen = []

    def fn():
        seen.append(torch.autograd.profiler._is_profiler_enabled)
        run()
    win = _harness_trace().profiled(fn)
    assert seen and all(seen) and win.kernels
    unit, under = _step_spans(tracing.records())
    by_id = {r.id: r for r in under}
    backward = [r for r in under if r.name == "model.block"
                and by_id[r.parent].name == "train.backward"]
    assert len(backward) == cfg.num_layers * shape.microbatches
    # On the card the backward, and the recomputation in it, runs on the
    # autograd engine's device thread.
    assert all(r.thread != unit.thread for r in backward)


def test_tracing_adds_no_device_event(stepper, monkeypatch):
    _, _, run = stepper
    trace = _harness_trace()
    with monkeypatch.context() as m:
        m.setattr(tracing, "_profiler",
                  types.SimpleNamespace(_is_profiler_enabled=False))
        stubbed = trace.profiled(run)
    assert tracing.records() == []
    traced = trace.profiled(run)
    assert tracing.records()
    assert len(traced.kernels) == len(stubbed.kernels)
    assert sorted(k[0] for k in traced.kernels) == \
        sorted(k[0] for k in stubbed.kernels)


def test_host_syncs_per_step_counts_what_warn_mode_reports(stepper):
    _, _, run = stepper
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reported = sum(str(w.message).startswith(tracing.SYNC_MESSAGE)
                   for w in caught)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        run()
    assert torch.cuda.get_sync_debug_mode() == 0
    _, under = _step_spans(tracing.records())
    counted = sum(r.syncs for r in under)
    assert reported > 0 and counted == reported, (reported, [
        (r.name, r.syncs) for r in under if r.syncs])
