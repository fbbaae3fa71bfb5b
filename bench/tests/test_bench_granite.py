"""granite-4.0-h-small (``models/granite_hybrid.py``,
``reference/granite_hybrid.py``) and its cell
``granite-4.0-h-small.train-4k-ep8``: its leaves against the port's tree,
its flop terms pinned, its kernel shapes against the port's analyzer, and
the cell at smoke size (its configuration the smoke twin
``fixtures/granite-4.0-h-small-smoke.json``, the port's ``SMOKE_CONFIG``;
its mix ``train-4k-ep8`` cut to ``SMOKE_MIX``) rehearsed ``correct`` as
files alone and false under every fault.

``conftest.write_smoke_layout`` knows the smoke sizes of the mamba2 cells'
two mixes only, and gives every configuration mamba2's smoke keys, so it
cannot lay out this cell; ``_layout`` here lays out every cell of
``BENCHMARK.json`` as it does, with this cell's configuration and mix at
their own smoke sizes."""
import dataclasses
import importlib.util
import json
import subprocess
import sys

import pytest
import torch

import conftest
from conftest import BENCH, FIXTURES, ROOT, rehearse

from harness import program, weights
from harness.cli import Run, per_layer
from harness.layout import Layout
from yardstick import flops

CONFIG = "granite-4.0-h-small"
CELL = "granite-4.0-h-small.train-4k-ep8"
TWIN = FIXTURES / f"{CONFIG}-smoke.json"
# The cell's mix at smoke size: one microbatch, as the cell has.
SMOKE_MIX = {"train-4k-ep8": dict(seq_len=64, microbatches=1,
                                  microbatch_size=4)}


def _smoke_config(name: str) -> dict:
    if name == CONFIG:
        return json.loads(TWIN.read_text())
    return conftest.smoke_config(name)


def _layout(root, mix=None) -> dict:
    """``conftest.write_smoke_layout``'s layout under ``root``, with this
    cell's configuration as the smoke twin and its mix at ``SMOKE_MIX``
    (or ``mix``); returns ``{cell: its smoke name}``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = root / "bench"
    for d in ("configs", "traffic", "cells"):
        (b / d).mkdir(parents=True, exist_ok=True)
    sizes = {**conftest.SMOKE_TRAFFIC, **SMOKE_MIX}
    if mix is not None:
        sizes["train-4k-ep8"] = mix
    names, configs, workloads = {}, [], []
    for c in spec["configs"]:
        sc = _smoke_config(c["name"])
        (b / "configs" / f"{sc['name']}.json").write_text(json.dumps(sc))
        configs.append(dict(c, name=sc["name"],
                            file=f"bench/configs/{sc['name']}.json"))
    for t in {w["traffic"] for w in spec["workloads"]}:
        tr = json.loads((BENCH / "traffic" / f"{t}.json").read_text())
        (b / "traffic" / f"{t}-smoke.json").write_text(
            json.dumps(dict(tr, **sizes[t])))
    for w in spec["workloads"]:
        cfg = _smoke_config(w["config"])["name"]
        name = f"{cfg}.{w['traffic']}-smoke"
        cell = json.loads((BENCH / "cells" / f"{w['name']}.json").read_text())
        if "rate_per_s" in cell:
            cell["rate_per_s"] = 200.0
        (b / "cells" / f"{name}.json").write_text(json.dumps(cell))
        workloads.append(dict(w, name=name, config=cfg,
                              traffic=f"{w['traffic']}-smoke"))
        names[w["name"]] = name

    def rename(m):
        if "workloads" in m:
            m = dict(m, workloads=[names[x] for x in m["workloads"]])
        return m

    out = dict(spec, configs=configs, workloads=workloads,
               end_to_end=[rename(m) for m in spec["end_to_end"]],
               per_layer=[rename(m) for m in spec["per_layer"]])
    (root / "BENCHMARK.json").write_text(json.dumps(out))
    return names


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ARCH = _load(BENCH / "models" / "granite_hybrid.py",
             "bench_models_granite_hybrid")


def _config():
    return json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())


def _meta_tree(spec):
    return weights.nest(spec, [torch.empty(leaf.shape, device="meta",
                                           dtype=weights.torch_dtype(
                                               leaf.dtype))
                               for leaf in spec])


@pytest.mark.parametrize("which", ["cell", "twin"])
def test_leaves_are_the_ports_tree_and_fields(which):
    """The configuration file's fields are the port's config's, and its
    leaves the port's param tree (paths, shapes, dtypes) on the meta
    device: at the cell's size and at the twin's."""
    c = _config() if which == "cell" else json.loads(TWIN.read_text())
    cfg = program.model_config(c, ARCH.FIELDS)
    assert cfg.layer_types == tuple(c["layer_types"])
    program.check_tree(_meta_tree(ARCH.leaves(c)), cfg)


def test_a_pattern_other_than_the_ports_is_refused():
    c = _config()
    c["layer_types"] = c["layer_types"][1:] + c["layer_types"][:1]
    cfg = program.model_config(_config(), ARCH.FIELDS)
    with pytest.raises(ValueError, match="weights tree"):
        program.check_tree(_meta_tree(ARCH.leaves(c)), cfg)


def test_the_configurations_parameters_and_model_flops_are_pinned():
    """2 062 371 456 parameters (9 Mamba2 layers of 206.4 M, one attention
    layer of 146.0 M, the tied embedding's 14 336 padded rows); the model
    flops of a step of 8 x 4096 tokens by term."""
    c = _config()
    spec = ARCH.leaves(c)
    assert sum(leaf.numel for leaf in spec) == 2062371456
    assert weights.padded_vocab(c) == 14336
    reps = ARCH.repeats(c)
    assert reps == {"mamba2_block": 9, "attention_layer": 1, "moe_ffn": 10}
    terms = {t: getattr(ARCH, t)(c, 8, 4096, "train") * reps.get(t, 1)
             for t in c["model_flop_terms"]}
    total = flops.model_flops(ARCH, c, 8, 4096, "train")
    assert total == sum(terms.values()) == 270631497105408.0
    share = {t: round(v / total, 3) for t, v in terms.items()}
    assert share == {"mamba2_block": 0.695, "attention_layer": 0.043,
                     "moe_ffn": 0.225, "lm_head": 0.037}
    # the held experts at their expected pairs: 8 x 4096 x 10 x 9 / 72
    pairs = 8 * 4096 * 10 * 9 / 72
    assert pairs == 40960.0


@pytest.mark.parametrize("kind", ["train", "forward"])
def test_kernel_shapes_are_the_analyzers_kernel_calls(kind):
    """At smoke size, through the kernels' wrappers: the Mamba2 layers'
    scan and conv calls and the attention layer's flash calls, each
    shape's calls and work, as the port's analyzer records them."""
    from repro_torch.models.registry import get_model
    from repro_torch.roofline import op_analysis as oa

    c = json.loads(TWIN.read_text())
    cfg = dataclasses.replace(program.model_config(c, ARCH.FIELDS),
                              attention_impl="pallas")
    spec = ARCH.leaves(c)
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
    shapes = ARCH.kernel_shapes(c, b, l, kind)
    assert set(shapes) == set(counts["kernels"])
    for key, calls in shapes.items():
        formula = getattr(oa, f"{key}_work")
        want = counts["kernels"][key]
        assert sum(n for _, n in calls) == want["calls"], key
        assert sum(n * formula(**s).flops for s, n in calls) == \
            want["flops"], key
        assert sum(n * formula(**s).bytes for s, n in calls) == \
            want["bytes"], key


def test_the_expert_products_counter_is_found_by_name():
    assert type(program.counters()["moe_experts.launches"]) is int


def test_the_configurations_kernel_shapes_are_the_wide_scan_and_convs():
    c = _config()
    s = ARCH.kernel_shapes(c, 8, 4096, "train")
    (scan, n), = s["ssd_scan"]
    assert (scan["h"], scan["q"], scan["b"], n) == (128, 128, 8, 18)
    assert sorted(x["c"] for x, _ in s["causal_conv"]) == [256, 8192]
    assert s["ssd_scan_bwd"][0][1] == 9


def _digest():
    import hashlib
    return {str(p.relative_to(BENCH)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(BENCH.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_the_cell_is_correct_as_files_alone(tmp_path, capsys):
    before = _digest()
    name = _layout(tmp_path)[CELL]
    rc, line, _, err = rehearse(tmp_path, name, capsys=capsys)
    assert rc == 0 and line["correct"] is True, err[-3000:]
    assert line["failed"] == 0 and set(line["checks"]) == {
        "grad_gap", "change_gap", "work_change_gap"}
    cell = Layout(tmp_path, [tmp_path / "bench", BENCH]).cell(name)
    assert cell.model.__file__ == str(BENCH / "models" / "granite_hybrid.py")
    assert _digest() == before


@pytest.mark.parametrize("fault", ["unchanged", "stale_params"])
def test_a_broken_timed_path_of_the_cell_comes_out_not_correct(
        fault, tmp_path, capsys):
    name = _layout(tmp_path)[CELL]
    rc, line, _, err = rehearse(tmp_path, name, fault=fault, capsys=capsys)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


def test_half_of_each_batch_left_out_comes_out_not_correct(tmp_path,
                                                           capsys):
    """The half-batch fault halves the microbatches, so it needs two: the
    cell's mix at smoke size with two microbatches of two."""
    name = _layout(tmp_path, mix=dict(seq_len=64, microbatches=2,
                                      microbatch_size=2))[CELL]
    rc, line, _, err = rehearse(tmp_path, name, fault="half_batch",
                                capsys=capsys)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


def test_the_float8_control_reads_above_the_program(tmp_path):
    from harness import checks
    from reference.lowp import fp8_matmul
    from reference.matmul import plain_matmul

    name = _layout(tmp_path)[CELL]
    layout = Layout(tmp_path, [tmp_path / "bench", BENCH])
    c = layout.cell(name)
    train = layout.load_module("drivers", "train")
    dev = torch.device("cpu")
    r = Run(cell=c, seed=11, seconds=0, trace=False, t0=0.0, device=dev,
            rehearsal=True)
    _, _, prog, spec = train.prepare(r)
    ref = train.reference(c, 11, dev, spec, plain_matmul)
    ctl = train.reference(c, 11, dev, spec, fp8_matmul)
    names_ = train.leaf_names(spec)
    p = checks.training(prog, ref, names_)
    q = checks.training(ctl, ref, names_)
    assert q["grad_gap"] > 3 * p["grad_gap"], (p, q)


def test_moe_idle_reads_the_idle_under_every_moe_span(monkeypatch):
    """``moe_idle_ms.train`` takes the idle under ``model.moe`` in the
    forward's block and in the block the backward recomputes (50 ms each
    here).  The forward's reading keeps the idle under its block's MoE; the
    recomputed blocks' reading loses it to the deeper span."""
    from harness import spans
    from repro_torch.runtime.tracing import Span
    from test_bench_spans import ENGINE, MAIN, TRAIN_KERNELS, _data, \
        _train_spans, _window

    h = 5.0
    records = _train_spans(h) + [
        Span(18, "model.moe", h + 0.15, h + 0.2, MAIN, 14, {}, 0),
        Span(19, "model.moe", h + 0.45, h + 0.5, ENGINE, 16, {}, 0)]
    monkeypatch.setattr(spans, "port_records", lambda: records)
    cell = Layout(ROOT, [BENCH]).cell(CELL)
    got = per_layer(cell, _data(_window(TRAIN_KERNELS)))
    want = {"moe_idle_ms.train": 100.0, "forward_idle_ms.train": 150.0,
            "recompute_idle_ms.train": 50.0}
    for k, v in want.items():
        assert got[k]["value"] == pytest.approx(v, abs=1e-3), k


def test_a_rehearsed_run_of_the_cell_loads_neither_jax_nor_the_jax_package(
        tmp_path):
    """A fresh interpreter rehearses the cell at smoke size and then lists
    what the guard forbids."""
    code = f"""
import io, json, pathlib, sys, time, contextlib
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r},
                {str(BENCH / 'tests')!r}]
from test_bench_granite import CELL, _layout
from harness import guard
from harness.cli import main
root = pathlib.Path({str(tmp_path)!r})
names = _layout(root)
with contextlib.redirect_stdout(io.StringIO()), \\
        contextlib.redirect_stderr(io.StringIO()):
    rc = main(["--workload", names[CELL], "--seed", "3", "--seconds", "0.3",
               "--trace", "0"], t0=time.perf_counter(), root=root,
              dirs=[root / "bench"], device="cpu")
print(json.dumps({{"rc": rc, "forbidden": guard.forbidden_loaded()}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "forbidden": []}
