"""``harness/spans.py``: the port's spans anchored on a synthetic window, idle
time put down to the deepest open span across threads, the split printed
to standard error, and the cases in which a reader reports nothing."""
import sys

import pytest
from conftest import BENCH, ROOT

from harness import spans
from harness.cli import TraceData, per_layer
from harness.layout import Layout
from harness.trace import Window
from repro_torch.runtime.tracing import Span

MAIN, ENGINE = 1, 2  # the launching thread and the autograd engine's


def _window(kernels):
    return Window(kernels=[("k", s, e) for s, e in kernels], wall_s=1.0,
                  samples=[], start_s=100.0, end_s=101.0)


# Busy 100.0-100.1, 100.3-100.35, 100.6-100.9: idle 0.2 + 0.25 + 0.1 s.
TRAIN_KERNELS = [(100.0, 100.05), (100.05, 100.1), (100.3, 100.35),
                 (100.6, 100.9)]


def _train_spans(h):
    """An earlier try's step, then the window's: host clock from ``h``; the
    recomputed block on the engine's thread under the waiting backward."""
    return [
        Span(1, "train.step", h - 4.0, h - 3.1, MAIN, None, {}, 9),
        Span(2, "train.forward", h - 3.9, h - 3.5, MAIN, 1, {}, 0),
        Span(12, "train.batch", h + 0.001, h + 0.004, MAIN, 11, {}, 3),
        Span(14, "model.block", h + 0.12, h + 0.2, MAIN, 13,
             {"microbatch": 0}, 0),
        Span(13, "train.forward", h + 0.05, h + 0.25, MAIN, 11,
             {"microbatch": 0}, 0),
        Span(16, "model.block", h + 0.4, h + 0.5, ENGINE, 15, {}, 0),
        Span(15, "train.backward", h + 0.3, h + 0.8, MAIN, 11,
             {"microbatch": 0}, 1),
        Span(17, "train.optimizer", h + 0.85, h + 0.93, MAIN, 11, {}, 0),
        Span(11, "train.step", h, h + 0.95, MAIN, None, {"tokens": 8}, 0),
    ]


def _data(window, units=1):
    return TraceData(window=window, units=units, unit_wall_s=1.0,
                     model_flops_per_unit=1.0, shapes={}, counters={},
                     peaks=None)


@pytest.mark.parametrize("h", [5.0, 12345.678])
def test_spans_anchor_on_the_window_and_idle_goes_to_the_deepest(h):
    got = spans.attribute(_window(TRAIN_KERNELS), 1, "train.step",
                          _train_spans(h))
    step = ("train.step",)
    want = {step + ("train.forward",): 0.07,
            step + ("train.forward", "model.block"): 0.08,
            step + ("train.backward",): 0.15,
            step + ("train.backward", "model.block"): 0.10,
            step + ("train.optimizer",): 0.03,
            step: 0.07,
            spans.OUTSIDE: 0.05}
    assert set(got.idle) == set(want)
    for k, v in want.items():
        assert got.idle[k] == pytest.approx(v, abs=1e-6), k
    assert got.syncs == 4 and got.units == 1


def test_the_split_on_stderr_adds_up_to_the_windows_idle(capsys):
    win = _window(TRAIN_KERNELS)
    got = spans.attribute(win, 1, "train.step", _train_spans(5.0))
    spans.report(got, "train.step")
    lines = capsys.readouterr().err.splitlines()
    parts = [float(x.split()[1]) for x in lines if x.startswith("spans:   ")]
    idle = sum(e - s for s, e in spans.idle_gaps(win))
    assert idle == pytest.approx(0.55, abs=1e-9)
    assert abs(sum(parts) / 1e3 - idle) < 1e-6
    assert any("(outside any port span)" in x for x in lines)


def test_the_metrics_read_their_spans(monkeypatch):
    monkeypatch.setattr(spans, "port_records", lambda: _train_spans(5.0))
    cell = Layout(ROOT, [BENCH]).cell("mamba2-1.3b.train-4k")
    got = per_layer(cell, _data(_window(TRAIN_KERNELS)))
    want = {"forward_idle_ms.train": 150.0, "recompute_idle_ms.train": 100.0,
            "backward_idle_ms.train": 150.0, "optimizer_idle_ms.train": 30.0,
            "host_syncs_per_step.train": 4.0}
    for k, v in want.items():
        assert got[k]["value"] == pytest.approx(v, abs=1e-3), k


def test_the_serving_metrics_split_a_batch(monkeypatch):
    h = 7.0
    records = [
        Span(2, "serve.gather", h + 0.0, h + 0.02, MAIN, 1, {}, 1),
        Span(4, "model.block", h + 0.1, h + 0.2, MAIN, 3, {}, 0),
        Span(3, "serve.prefill", h + 0.05, h + 0.3, MAIN, 1, {}, 0),
        Span(5, "serve.decode", h + 0.35, h + 0.5, MAIN, 1, {"j": 0}, 0),
        Span(6, "serve.decode", h + 0.5, h + 0.7, MAIN, 1, {"j": 1}, 0),
        Span(7, "serve.readback", h + 0.7, h + 0.75, MAIN, 1, {}, 2),
        Span(1, "serve.batch", h, h + 0.8, MAIN, None,
             {"size": 2, "requests": [3, 4]}, 0),
    ]
    monkeypatch.setattr(spans, "port_records", lambda: records)
    cell = Layout(ROOT, [BENCH]).cell("mamba2-1.3b.prefill-4k")
    # Busy 100.0-100.1 and 100.6-100.9: idle 100.1-100.6 and 100.9-101.0.
    got = per_layer(cell, _data(_window([(100.0, 100.1), (100.6, 100.9)])))
    want = {"prefill_idle_ms.serve": 200.0,   # 100.1-100.3
            "decode_idle_ms.serve": 250.0,    # 100.35-100.6
            "frontend_idle_ms.serve": 50.0,   # 100.3-100.35
            "host_syncs_per_batch.serve": 3.0}
    for k, v in want.items():
        assert got[k]["value"] == pytest.approx(v, abs=1e-3), k


@pytest.mark.parametrize("case", ["past_the_end", "too_few_units",
                                  "units_of_two_tries"])
def test_a_window_that_the_spans_do_not_fit_reads_nothing(case, capsys):
    records = _train_spans(5.0)
    units = 1
    if case == "past_the_end":
        records[-2] = Span(17, "train.optimizer", 5.85, 6.1, MAIN, 11, {}, 0)
    elif case == "too_few_units":
        records = [r for r in records if r.name != "train.step"]
    else:  # two units asked for: the earlier try's step anchors, the later
        units = 2  # one maps seconds past the end
    assert spans.attribute(_window(TRAIN_KERNELS), units, "train.step",
                           records) is None
    assert "spans: " in capsys.readouterr().err


def test_a_port_without_spans_leaves_the_metrics_out(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    assert spans.port_records() is None
    cell = Layout(ROOT, [BENCH]).cell("mamba2-1.3b.train-4k")
    got = per_layer(cell, _data(_window(TRAIN_KERNELS)))
    assert "forward_idle_ms.train" not in got
    assert "launches_per_step.train" in got
