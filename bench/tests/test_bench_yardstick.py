"""The frozen yardstick tied to the port's analyzer as it stands, the
architectures' numbers pinned to the harness's before they became modules,
and the readers' arithmetic on made-up traces."""
import dataclasses
import hashlib
import importlib.util
import json
import re

import pytest
import torch
from conftest import BENCH, FIXTURES, HYBRID, smoke_config

from harness import program, readers, weights
from harness.cli import TraceData
from harness.trace import Window
from models import mamba2 as arch
from yardstick import flops, work

CELL_SHAPES = [  # (b, l, h, p, g, n, q) of the cells' scan calls
    (1, 4096, 64, 64, 1, 128, 128), (8, 4096, 64, 64, 1, 128, 128),
]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("channels", [4096, 256])
def test_conv_formulas_equal_the_analyzers(b, channels):
    """At the cells' conv calls: x (4096 channels) and B,C (256), width 4,
    a training microbatch (b = 1) and a prefill batch (b = 8) of 4096."""
    from repro_torch.roofline import op_analysis as oa

    shape = (b, 4096, channels, 4, 2)
    assert work.causal_conv_work(*shape) == tuple(oa.causal_conv_work(*shape))
    assert work.causal_conv_bwd_work(*shape) == tuple(
        oa.causal_conv_bwd_work(*shape))


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
    formula (the conv's, a kernel since the conv got its own, among them);
    the model-flop formula counts the head over the published vocabulary
    only."""
    from repro_torch.models.registry import get_model
    from repro_torch.roofline import op_analysis as oa

    c = smoke_config("mamba2-1.3b")
    cfg = dataclasses.replace(program.model_config(c, arch.FIELDS),
                              dtype="float32")
    spec = arch.leaves(c)
    params = weights.nest(spec, [t.float() for t in
                                 weights.make_all(spec, 1, "cpu")])
    b, l = 2, 64
    tok = torch.randint(0, c["vocab_size"], (b, l))
    with torch.no_grad():
        _, counts = oa.analyze(get_model(cfg).apply, params, tok, cfg)
    pad_head = 2 * b * l * c["d_model"] * (weights.padded_vocab(c)
                                           - c["vocab_size"])
    assert counts["flops"] == flops.model_flops(arch, c, b, l, "forward") \
        + pad_head


def _cell_config():
    return json.loads((BENCH / "configs" / "mamba2-1.3b.json").read_text())


def test_cells_model_flops_are_the_formulas():
    c = _cell_config()
    assert flops.model_flops(arch, c, 8, 4096, "train") == pytest.approx(
        2.83e14, rel=2e-3)
    assert sum(leaf.numel for leaf in arch.leaves(c)) == 1450482688


def test_cells_model_flops_are_the_parents():
    """The model flops of a training step (8 x 4096) and of a prefill batch
    with its 4 decode steps, as the harness counted them before the
    architecture became a module."""
    c = _cell_config()
    assert flops.model_flops(arch, c, 8, 4096, "train") == 283139477864448.0
    assert flops.model_flops(arch, c, 8, 4096, "forward") == \
        93821413097472.0
    assert [flops.decode_flops(arch, c, 8, 4096 + j) for j in range(4)] == \
        [22296920064.0] * 4
    serve = importlib.util.spec_from_file_location(
        "serve_driver", BENCH / "drivers" / "serve.py")
    mod = importlib.util.module_from_spec(serve)
    serve.loader.exec_module(mod)
    tr = json.loads((BENCH / "traffic" / "prefill-4k.json").read_text())
    assert mod.batch_flops(arch, c, tr) == 93910600777728.0


def test_cells_leaves_and_their_values_are_the_parents():
    """mamba2-1.3b's leaves (path, shape, dtype, rule, scale, in order), the
    chunk plan and chunk 0's values for one seed, digested, as the harness
    made them before the architecture became a module."""
    c = _cell_config()
    spec = arch.leaves(c)
    rows = [[list(lf.path), list(lf.shape), lf.dtype, lf.rule, lf.scale]
            for lf in spec]
    assert len(rows) == 675
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest() == \
        "f08668abf751f3f6f62e42b9dbb1e0ccfdd23ff4423016b5bff2b05309fbf240"
    plan = weights.chunks(spec)
    assert hashlib.sha256(json.dumps(plan).encode()).hexdigest() == \
        "be60683ce75005c775626db5a1d124c481ba72d47d652166c461f1dd24f10583"
    chunk = weights.chunk_leaves(spec, plan, 0, 2147483659, "cpu")
    assert list(chunk) == [0]
    got = hashlib.sha256(chunk[0].view(torch.int16).numpy().tobytes())
    assert got.hexdigest() == \
        "f93e66f69745cd08662dc7b5d409d577e3b7433de73698f9e08deeebd16a8d1b"


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hybrid():
    return (_load(FIXTURES / "zamba2.py", "bench_models_zamba2"),
            json.loads((FIXTURES / f"{HYBRID}.json").read_text()))


@pytest.mark.parametrize("which", ["mamba2", "hybrid"])
@pytest.mark.parametrize("kind", ["train", "forward"])
def test_kernel_shapes_are_the_analyzers_kernel_calls(which, kind):
    """An architecture's kernel shapes, calls and work equal what the
    port's analyzer records of its kernels' wrappers at smoke size: a
    microbatch's rematerialized forward and backward (``train``), a prefill
    (``forward``)."""
    from repro_torch.models.registry import get_model
    from repro_torch.roofline import op_analysis as oa

    mod, c = ((arch, smoke_config("mamba2-1.3b")) if which == "mamba2"
              else _hybrid())
    # "pallas": the attention goes through its kernel's wrapper on the CPU.
    cfg = dataclasses.replace(program.model_config(c, mod.FIELDS),
                              attention_impl="pallas")
    spec = mod.leaves(c)
    params = weights.nest(spec, [t.requires_grad_(True) for t in
                                 weights.make_all(spec, 1, "cpu")])
    b, l = 2, 48
    tok = torch.randint(0, c["vocab_size"], (b, l + 1))
    api = get_model(cfg)

    def train():
        batch = {"tokens": tok[:, :-1].int(), "targets": tok[:, 1:].int(),
                 "mask": torch.ones(b, l)}
        api.loss_fn(params, batch, cfg, remat=True)[0].backward()

    def prefill():
        with torch.no_grad():
            return api.prefill(params, tok[:, :-1], cfg, l)

    _, counts = oa.analyze(train if kind == "train" else prefill)
    shapes = mod.kernel_shapes(c, b, l, kind)
    assert set(shapes) == set(counts["kernels"])
    for key, calls in shapes.items():
        formula = getattr(oa, f"{key}_work")
        want = counts["kernels"][key]
        assert sum(n for _, n in calls) == want["calls"], key
        assert sum(n * formula(**s).flops for s, n in calls) == \
            want["flops"], key
        assert sum(n * formula(**s).bytes for s, n in calls) == \
            want["bytes"], key


def test_the_harness_reads_no_architectures_keys():
    """No file of the harness, the drivers or the model-flop sums reads a
    Mamba2 width or the Mamba2 reference: they come from models/."""
    words = re.compile(r"expand|headdim|d_state|ngroups|d_conv|"
                       r"reference\.model|reference import model")
    files = [*sorted((BENCH / "harness").glob("*.py")),
             *sorted((BENCH / "drivers").glob("*.py")),
             BENCH / "yardstick" / "flops.py"]
    for f in files:
        assert not words.search(f.read_text()), f


def test_counters_are_every_kernel_wrappers_found_by_name():
    got = program.counters()
    assert {"ssd_scan.launches", "ssd_scan.tc_launches",
            "ssd_scan.bwd_launches", "ssd_scan.tc_bwd_launches",
            "causal_conv.launches", "causal_conv.bwd_launches",
            "flash_attention.launches", "flash_attention.bwd_launches",
            "decode_attention.launches", "fed_reduce.launches"} <= set(got)
    assert all(type(v) is int for v in got.values())
    from repro_torch.kernels.causal_conv.ops import causal_conv
    causal_conv.bwd_launches += 2
    try:
        after = program.counters()
    finally:
        causal_conv.bwd_launches -= 2
    assert program.counter_delta(got, after) == dict(
        dict.fromkeys(got, 0), **{"causal_conv.bwd_launches": 2})


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
    return _load(BENCH / "metrics" / "ssd_scan_roofline.serve.py", "r")


def test_roofline_reader_divides_the_calls_bound_by_their_kernels_time():
    bound = work.bound_s(work.ssd_scan_work(**SCAN), 989e12, 3.35e12)
    ks = [("void ssd_scan_tc_kernel<128>", 0.1 * i, 0.1 * i + 2 * bound)
          for i in range(3)] + [("other", 0.5, 0.6)]
    t = _trace(ks, {"ssd_scan.launches": 3, "ssd_scan.tc_launches": 3},
               {"ssd_scan": [(SCAN, 3)]})
    assert _scan_reader().read(t) == pytest.approx(50.0)
    assert readers.mfu_percent(t) == pytest.approx(10.0)
    assert readers.launches_per_unit(t) == 4
    assert readers.idle_percent(t) == pytest.approx(
        100 * (1 - t.window.busy_s / 0.5))


@pytest.mark.parametrize("counters", [
    {"ssd_scan.launches": 4, "ssd_scan.tc_launches": 4},  # a launch the
    #                                                       trace lacks
    {"ssd_scan.launches": 3, "ssd_scan.tc_launches": 2},  # a call off the
    #                                                       route
    {"ssd_scan.launches": 0, "ssd_scan.tc_launches": 0},  # nothing to read
])
def test_roofline_reader_reports_nothing_when_names_and_calls_differ(
        counters, capsys):
    ks = [("ssd_scan_tc_kernel", 0.1 * i, 0.1 * i + 0.01) for i in range(3)]
    t = _trace(ks, counters,
               {"ssd_scan": [(SCAN, counters["ssd_scan.launches"])]})
    assert _scan_reader().read(t) is None
    assert "roofline" in capsys.readouterr().err


CONV_X = dict(b=1, l=4096, c=4096, width=4, itemsize=2)
CONV_BC = dict(CONV_X, c=256)


def _conv_trace(fwd, bwd, wsum, counted, due, units=1):
    """A made-up window of conv launches: ``fwd``, ``bwd`` and ``wsum``
    launches of 1, 2 and 0.5 ms; ``counted`` forward and backward calls by
    the counters; ``due`` of each shape per unit by the cell's shapes."""
    ks = ([("void causal_conv_fwd_kernel<bf16>", i, i + 1e-3)
           for i in range(fwd)]
          + [("void causal_conv_bwd_kernel<bf16>", i, i + 2e-3)
             for i in range(bwd)]
          + [("void causal_conv_wsum_kernel", i, i + 5e-4)
             for i in range(wsum)])
    return _trace(ks, {"causal_conv.launches": counted[0],
                       "causal_conv.bwd_launches": counted[1]},
                  {"causal_conv": [(CONV_X, due[0]), (CONV_BC, due[0])],
                   "causal_conv_bwd": [(CONV_X, due[1]), (CONV_BC, due[1])]},
                  units)


def test_conv_roofline_sums_each_shapes_bound_times_its_calls():
    reader = _load(BENCH / "metrics" / "causal_conv_roofline.train.py", "r")
    t = _conv_trace(8, 4, 4, (8, 4), (2, 1), units=2)

    def b(f, s):
        return work.bound_s(f(**s), 989e12, 3.35e12)
    bound = 4 * (b(work.causal_conv_work, CONV_X)
                 + b(work.causal_conv_work, CONV_BC)) \
        + 2 * (b(work.causal_conv_bwd_work, CONV_X)
               + b(work.causal_conv_bwd_work, CONV_BC))
    assert reader.read(t) == pytest.approx(100 * bound / (8e-3 + 4 * 2.5e-3))
    serve = _load(BENCH / "metrics" / "causal_conv_roofline.serve.py", "s")
    assert serve.read(t) == pytest.approx(
        100 * 4 * (b(work.causal_conv_work, CONV_X)
                   + b(work.causal_conv_work, CONV_BC)) / 8e-3)


@pytest.mark.parametrize("fwd,bwd,wsum,counted,due", [
    (6, 4, 4, (6, 4), (2, 1)),  # two calls ran the plain chain, uncounted
    (8, 4, 3, (8, 4), (2, 1)),  # a backward call's second launch missing
    (8, 5, 4, (8, 4), (2, 1)),  # a launch of the name the counters lack
])
def test_conv_roofline_reports_nothing_when_a_call_leaves_the_kernels(
        fwd, bwd, wsum, counted, due, capsys):
    reader = _load(BENCH / "metrics" / "causal_conv_roofline.train.py", "r")
    assert reader.read(_conv_trace(fwd, bwd, wsum, counted, due,
                                   units=2)) is None
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
