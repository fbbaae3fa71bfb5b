"""The comparison that decides ``correct`` fails where it must.

Each fault breaks the timed path underneath a rehearsed run (the harness's
look for a card skipped) and must turn ``correct`` false under the cells'
own limits; the control, the reference in float8, must read above the
program at the same size.
"""
import pytest
import torch
from conftest import (BENCH, add_hybrid, rehearse, smoke_config,
                      write_smoke_layout)

from harness.cli import Run
from harness.layout import Layout


FAULTS = [("mamba2-1.3b.train-4k", "unchanged"),
          ("mamba2-1.3b.train-4k", "stale_params"),
          ("mamba2-1.3b.train-4k", "half_batch"),
          ("mamba2-1.3b.prefill-4k", "altered_token")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_comes_out_not_correct(cell, fault, tmp_path,
                                                   capsys):
    names = write_smoke_layout(tmp_path)
    rc, line, _, err = rehearse(tmp_path, names[cell], fault=fault,
                                capsys=capsys)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_of_a_second_architecture_comes_out_not_correct(
        cell, fault, tmp_path, capsys):
    """The same faults in the cells of the port's hybrid, added as files
    alone."""
    hybrid = add_hybrid(tmp_path, write_smoke_layout(tmp_path))
    rc, line, _, err = rehearse(tmp_path, hybrid[cell], fault=fault,
                                capsys=capsys)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


def test_the_float8_control_reads_above_the_program(tmp_path):
    from harness import checks
    from reference.lowp import fp8_matmul
    from reference.matmul import plain_matmul

    names = write_smoke_layout(tmp_path)
    layout = Layout(tmp_path, [tmp_path / "bench", BENCH])
    c = layout.cell(names["mamba2-1.3b.train-4k"])
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


def test_the_float8_control_misses_served_tokens_the_program_gets(tmp_path):
    """At smoke width the program's served tokens lie at most rounding
    below the reference's best, the control's further."""
    from reference.lowp import fp8_matmul
    from reference.matmul import plain_matmul

    names = write_smoke_layout(tmp_path)
    layout = Layout(tmp_path, [tmp_path / "bench", BENCH])
    c = layout.cell(names["mamba2-1.3b.prefill-4k"])
    serve = layout.load_module("drivers", "serve")
    dev = torch.device("cpu")
    r = Run(cell=c, seed=5, seconds=0, trace=False, t0=0.0, device=dev,
            rehearsal=True)
    srv = serve.Server(r, 16)
    for _ in range(8):
        srv.batch()
    rows = list(range(len(srv.server.records)))
    g = serve.served_gaps(c, 5, dev, srv.spec, srv.prompts,
                          srv.server.records, rows, plain_matmul, fp8_matmul)
    assert g["control_gap"] > 3 * g["served_gap"], g


def test_the_smoke_config_is_the_ports_smoke_config():
    from harness import program
    from models import mamba2
    program.model_config(smoke_config("mamba2-1.3b"), mamba2.FIELDS)


@pytest.mark.cuda
def test_a_smoke_cell_runs_on_the_card(tmp_path, capsys):
    """On the card: the kernels' path at smoke size, one training and one
    serving cell, correct under the cells' limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import time

    from harness.cli import main

    names = write_smoke_layout(tmp_path)
    for w in ("mamba2-1.3b.train-4k", "mamba2-1.3b.prefill-4k"):
        rc = main(["--workload", names[w], "--seed", "7", "--seconds", "1",
                   "--trace", "1"], t0=time.perf_counter(), root=tmp_path,
                  dirs=[tmp_path / "bench"])
        assert rc == 0
