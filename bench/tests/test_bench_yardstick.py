"""The frozen yardstick tied to the port's analyzer as it stands, and the
readers' arithmetic on made-up traces."""
import dataclasses
import json

import pytest
import torch
from conftest import BENCH, smoke_config

from harness import program, readers, weights
from harness.cli import TraceData
from harness.trace import Window
from yardstick import flops, work

CELL_SHAPES = [  # (b, l, h, p, g, n, q) of the cells' scan calls
    (1, 4096, 64, 64, 1, 128, 128), (8, 4096, 64, 64, 1, 128, 128),
]


@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_scan_formulas_equal_the_analyzers(shape):
    from repro_torch.roofline import op_analysis as oa

    assert work.ssd_scan_work(*shape, 2) == tuple(oa.ssd_scan_work(*shape, 2))
    for dstate in (True, False):
        assert work.ssd_scan_bwd_work(*shape, 2, dstate) == tuple(
            oa.ssd_scan_bwd_work(*shape, 2, dstate))
    w = work.Work(10**12, 10**9)
    assert work.bound_s(w, 989e12, 3.35e12) == pytest.approx(
        oa.bound(oa.Work(*w))["bound_ms"] / 1e3)


def test_model_flops_equal_the_analyzers_count_of_one_forward():
    """One non-rematerialized forward at smoke size, through the kernels'
    wrappers: the analyzer counts the dot products and each kernel's
    formula; the model-flop formula adds the depthwise conv (not a dot
    product) and counts the head over the published vocabulary only."""
    from repro_torch.models.registry import get_model
    from repro_torch.roofline import op_analysis as oa

    c = smoke_config("mamba2-1.3b")
    cfg = dataclasses.replace(program.model_config(c), dtype="float32")
    spec = weights.leaves(c)
    params = weights.nest(spec, [t.float() for t in
                                 weights.make_all(spec, 1, "cpu")])
    b, l = 2, 64
    tok = torch.randint(0, c["vocab_size"], (b, l))
    with torch.no_grad():
        _, counts = oa.analyze(get_model(cfg).apply, params, tok, cfg)
    di = c["expand"] * c["d_model"]
    conv = (2 * b * l * c["d_conv"] * (di + 2 * c["ngroups"] * c["d_state"])
            * c["num_hidden_layers"])
    pad_head = 2 * b * l * c["d_model"] * (weights.padded_vocab(c)
                                           - c["vocab_size"])
    assert counts["flops"] == flops.model_flops(c, b, l, "forward") - conv \
        + pad_head


def test_cells_model_flops_are_the_formulas():
    c = json.loads((BENCH / "configs" / "mamba2-1.3b.json").read_text())
    assert flops.model_flops(c, 8, 4096, "train") == pytest.approx(
        2.83e14, rel=2e-3)
    assert sum(leaf.numel for leaf in weights.leaves(c)) == 1450482688


def _trace(kernels, counters, shapes, units=1):
    win = Window(kernels=kernels, wall_s=1.0, samples=[(0.5, "x:y")],
                 start_s=0.0, end_s=1.0)
    return TraceData(window=win, units=units, unit_wall_s=0.5,
                     model_flops_per_unit=989e12 * 0.05, shapes=shapes,
                     counters=counters,
                     peaks={"bf16_flops_per_s": 989e12,
                            "hbm_bytes_per_s": 3.35e12})


SCAN = dict(b=1, l=4096, h=64, p=64, g=1, n=128, q=128, itemsize=2)


def _scan_reader():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "r", BENCH / "metrics" / "ssd_scan_roofline.serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_reader_divides_the_calls_bound_by_their_kernels_time():
    bound = work.bound_s(work.ssd_scan_work(**SCAN), 989e12, 3.35e12)
    ks = [("void ssd_scan_tc_kernel<128>", 0.1 * i, 0.1 * i + 2 * bound)
          for i in range(3)] + [("other", 0.5, 0.6)]
    t = _trace(ks, {"ssd_scan": 3, "ssd_scan_tc": 3}, {"ssd_scan": SCAN})
    assert _scan_reader().read(t) == pytest.approx(50.0)
    assert readers.mfu_percent(t) == pytest.approx(10.0)
    assert readers.launches_per_unit(t) == 4
    assert readers.idle_percent(t) == pytest.approx(
        100 * (1 - t.window.busy_s / 0.5))


@pytest.mark.parametrize("counters", [
    {"ssd_scan": 4, "ssd_scan_tc": 4},   # a launch the trace lacks
    {"ssd_scan": 3, "ssd_scan_tc": 2},   # a call off the route
    {"ssd_scan": 0, "ssd_scan_tc": 0},   # nothing to read
])
def test_roofline_reader_reports_nothing_when_names_and_calls_differ(
        counters, capsys):
    ks = [("ssd_scan_tc_kernel", 0.1 * i, 0.1 * i + 0.01) for i in range(3)]
    t = _trace(ks, counters, {"ssd_scan": SCAN})
    assert _scan_reader().read(t) is None
    assert "roofline" in capsys.readouterr().err


def test_idle_gaps_are_named_by_the_host_samples():
    win = Window(kernels=[("k", 0.0, 0.2), ("k", 0.5, 0.6)], wall_s=1.0,
                 samples=[(0.3, "a:f"), (0.35, "a:f"), (0.8, "b:g")],
                 start_s=0.0, end_s=1.0)
    assert win.busy_s == pytest.approx(0.3)
    gaps = dict(win.idle_by_host())
    assert gaps["b:g"] == pytest.approx(0.4)
    assert gaps["a:f"] == pytest.approx(0.3)


def test_a_gap_with_no_sample_takes_the_nearest_samples_name():
    win = Window(kernels=[("k", 0.0, 0.1), ("k", 0.1002, 0.2)], wall_s=0.2,
                 samples=[(0.0999, "a:f"), (0.15, "b:g")], start_s=0.0,
                 end_s=0.2)
    assert dict(win.idle_by_host()) == {"a:f": pytest.approx(0.0002)}
