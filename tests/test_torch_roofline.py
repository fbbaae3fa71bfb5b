"""The port's op-level roofline analyzer (``roofline/op_analysis.py``)
against the reference's HLO analyzer (``tests/test_roofline.py``), the
routes against each other, the per-kernel work formulas against the
figures they gave on the card, and the collectives on a fake process
group."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_roofline import SHAPE, TINY, _compile  # noqa: E402

from repro.roofline.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.distribution.steps import (  # noqa: E402
    build_train_step,
    init_train_state,
    train_batch_specs,
)
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.roofline import op_analysis as oa  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

# The reference test's TINY config, field for field, in the port's class.
T_TINY = ModelConfig(**{f.name: getattr(TINY, f.name)
                        for f in dataclasses.fields(TINY)})
T_SHAPE = ShapeConfig(SHAPE.name, seq_len=SHAPE.seq_len,
                      global_batch=SHAPE.global_batch, kind=SHAPE.kind,
                      microbatches=SHAPE.microbatches)


def _batch(cfg, shape, device):
    gen = torch.Generator().manual_seed(0)
    out = {}
    for k, (sh, dt) in train_batch_specs(cfg, shape).items():
        if device == "meta":
            out[k] = torch.empty(sh, dtype=dt, device="meta")
        elif dt == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, sh, generator=gen,
                                   dtype=dt)
        else:
            out[k] = torch.rand(sh, generator=gen).to(dt)
    return out


_TRAIN_COUNTS: dict = {}


def _train_analysis(cfg, shape, device):
    """One train step's counts (each config's once per module: the tests
    below share them)."""
    key = (cfg, shape, device)
    if key not in _TRAIN_COUNTS:
        step, _, _ = build_train_step(cfg, None, shape)
        state = init_train_state(cfg, device=device)
        _TRAIN_COUNTS[key] = oa.analyze(step, state,
                                        _batch(cfg, shape, device))[1]
    return _TRAIN_COUNTS[key]


@pytest.fixture(scope="module")
def reference_flops():
    return analyze_hlo(_compile(TINY).as_text())["flops"]


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_flops_against_the_reference_analyzer(reference_flops, impl):
    """The TINY train step's dot flops against ``analyze_hlo`` of the
    reference's scanned module, in the reference test's own band: with the
    plain attention the port counts the whole score matrices as the HLO
    does; through the kernel's wrapper the causal triangle."""
    cfg = dataclasses.replace(T_TINY, attention_impl=impl)
    ratio = _train_analysis(cfg, T_SHAPE, "cpu")["flops"] / reference_flops
    assert 0.80 <= ratio <= 1.15, ratio


def test_scan_layers_on_and_off_count_the_same():
    on = _train_analysis(T_TINY, T_SHAPE, "cpu")
    off = _train_analysis(dataclasses.replace(T_TINY, scan_layers=False),
                          T_SHAPE, "cpu")
    assert on == off


_ROUTE_KEYS = ("flops", "bytes", "kernels", "collective_bytes",
               "collective_count", "temp_bytes", "output_bytes")


def _serve_analysis(cfg, kind, device):
    api = get_model(cfg)
    params = api.init(0, cfg, device=device)
    b, s = 2, 16
    tokens = (torch.empty((b, s), dtype=torch.int32, device="meta")
              if device == "meta" else
              torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        if kind == "prefill":
            return oa.analyze(api.prefill, params, tokens, cfg, 2 * s)[1]
        _, cache = api.prefill(params, tokens, cfg, 2 * s)
        return oa.analyze(api.decode_step, params, tokens[:, 0], cfg,
                          cache)[1]


@pytest.mark.parametrize("arch,kind", [
    ("tiny", "train"), ("tiny", "prefill"), ("tiny", "decode"),
    ("mamba2_1_3b", "train"), ("mamba2_1_3b", "decode")])
def test_cpu_and_meta_routes_count_the_same(arch, kind):
    """Through the kernels' wrappers (``attention_impl="pallas"``: their
    plain versions on the CPU, their shapes-only routes on meta) a step
    counts exactly the same flops, bytes, kernel work, collectives and
    memory on either device."""
    if arch == "tiny":
        cfg = dataclasses.replace(T_TINY, attention_impl="pallas")
        shape = T_SHAPE
    else:
        cfg = get_config(arch, smoke=True)
        shape = ShapeConfig("t", seq_len=64, global_batch=2, kind="train",
                            microbatches=2)
    got = {}
    for device in ("cpu", "meta"):
        an = (_train_analysis(cfg, shape, device) if kind == "train"
              else _serve_analysis(cfg, kind, device))
        got[device] = {k: an[k] for k in _ROUTE_KEYS}
    assert got["cpu"] == got["meta"]
    assert got["meta"]["flops"] > 0
    # mamba2's one-token decode step has no kernel (``ssd_decode_step``).
    assert bool(got["meta"]["kernels"]) == (arch == "tiny" or kind != "decode")
    if kind == "train":
        assert {k: v["calls"] for k, v in got["meta"]["kernels"].items()} \
            == ({"ssd_scan": 2 * 2 * cfg.num_layers,
                 "ssd_scan_bwd": 2 * cfg.num_layers,
                 # the block's two convs (x and B,C), as the scan
                 "causal_conv": 2 * 2 * 2 * cfg.num_layers,
                 "causal_conv_bwd": 2 * 2 * cfg.num_layers}
                if arch != "tiny" else
                {"flash_attention": 2 * 2 * cfg.num_layers,
                 "flash_attention_bwd": 2 * cfg.num_layers})


def test_causal_pairs_closed_form_equals_the_count():
    for sq, sk, causal, off in [(4096, 4096, True, 0), (96, 200, True, 104),
                                (7, 3, True, 0), (5, 9, True, 20),
                                (16, 577, False, 0), (1, 1, True, 0)]:
        want = (sq * sk if not causal else
                sum(min(sk, off + i + 1) for i in range(sq)))
        assert oa.causal_pairs(sq, sk, causal, off) == want


def _smoke_decode_lengths():
    """The lengths ``chip_smoke.py``'s timed decode case draws (its bf16
    llama3.2-3b serving row: generator seed 1, f32 then bf16 inputs)."""
    gen = torch.Generator().manual_seed(1)
    b, s, h, kv, d = 16, 577, 24, 8, 128
    for _ in range(2):
        torch.randn((b, h, d), generator=gen)
        torch.randn((b, s, kv, d), generator=gen)
        torch.randn((b, s, kv, d), generator=gen)
        lens = torch.randint(1, s + 1, (b,), generator=gen,
                             dtype=torch.int32)
    lens[0], lens[-1] = 0, s
    return lens


def test_kernel_formulas_give_the_card_rows_figures():
    """Each kernel's work at the shapes of its row in PERF.md's kernel
    table gives that row's flops and bound (H100 SXM: 3.35 TB/s, 989
    TFLOP/s bf16, 67 f32)."""
    def ms(work, rate=oa.PEAK_FLOPS):
        return round(oa.bound(work, rate)["bound_ms"], 6)

    fwd = oa.flash_attention_work(1, 4096, 4096, 24, 8, 128, 2, True, 0)
    bwd = oa.flash_attention_bwd_work(1, 4096, 4096, 24, 8, 128, 2, True, 0)
    k4b = oa.ssd_scan_bwd_work(1, 4096, 64, 64, 1, 128, 128, 2, False)
    assert round(fwd.flops / 1e9, 1) == 103.1
    assert round(bwd.flops / 1e9, 1) == 257.8
    assert round(k4b.flops / 1e9, 1) == 34.5
    assert ms(oa.fed_reduce_work(8192, 256, 4, False), oa.F32_FLOPS) \
        == 0.002514
    lens = _smoke_decode_lengths()
    dec = oa.decode_attention_work(16, 24, 8, 128, 2,
                                   oa.decode_rows(lens, 577))
    assert ms(dec) == 0.005436 and round(dec.bytes / 1e6, 1) == 18.2
    assert ms(oa.flash_attention_work(16, 512, 512, 24, 8, 128, 2, True, 0)
              ) == 0.040065
    assert ms(bwd) == 0.260628
    ssd = oa.ssd_scan_work(16, 512, 64, 64, 1, 128, 128, 2)
    assert ms(ssd) == 0.051959 and round(ssd.bytes / 1e6, 1) == 174.1
    assert round(oa.bound(k4b)["bound_ms"], 4) == 0.0349
    assert oa.bound(k4b)["bound_by"] == "operations"


def test_decode_partial_work_writes_its_f32_state():
    """K2p's work: the decode kernel's flops and reads, its output the f32
    o (b, h, d) with m and l (b, h) in place of the output in q's dtype."""
    lens = _smoke_decode_lengths()
    rows = oa.decode_rows(lens, 577)
    whole = oa.decode_attention_work(16, 24, 8, 128, 2, rows)
    part = oa.decode_attention_work(16, 24, 8, 128, 2, rows, partial=True)
    assert part.flops == whole.flops
    assert part.bytes - whole.bytes == 16 * 24 * (130 * 4 - 128 * 2)


def test_hand_counted_bytes_and_flops():
    m, k, n = 8, 16, 4
    a, b = torch.ones(m, k), torch.ones(k, n)

    def f(a, b):
        c = a @ b.t().t()  # two views: nothing moved
        c.relu_()  # in place: read and written
        d = c + 1.0
        e = torch.empty(m, n)  # an allocation without a fill
        e.copy_(d)  # the source read, the target written
        return e

    _, an = oa.analyze(f, a, b)
    mm = 4 * (m * k + k * n + m * n)
    mn = 4 * m * n
    assert an["flops"] == 2 * m * k * n
    assert an["bytes"] == mm + 2 * mn + 2 * mn + 2 * mn
    assert an["kernels"] == {} and an["collective_count"] == {}
    assert an["output_bytes"] == mn
    assert an["temp_bytes"] == 3 * mn  # c, d and e live at once


def test_roofline_terms_use_the_h100_rates():
    terms = oa.roofline_terms({"flops": 989e12, "bytes": 3.35e12 / 2,
                               "collective_bytes": {"all-reduce": 450e9,
                                                    "all-gather": 450e9}})
    assert terms == {"compute_s": 1.0, "memory_s": 0.5, "collective_s": 3.0}
    assert oa.dominant_term(terms) == "collective"


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sharded_step_collectives_on_a_fake_group():
    """A TINY sharded train step on an 8-rank fake process group ((2, 4):
    tp 4, FSDP over data) counts its all-gathers (the FSDP weights, the
    rank's heads) and reduce-scatters (the gradients back to their
    blocks), and a reduce-scatter on a non-gloo group is one
    ``reduce-scatter``, not gloo's all-reduce."""
    res = _run("""
        import json, torch
        from repro_torch.configs.base import ModelConfig, ShapeConfig
        from repro_torch.configs.base import choose_mesh_plan
        from repro_torch.distribution import collectives as cc
        from repro_torch.distribution.sharding import derive_logical_mesh
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.roofline.op_analysis import analyze
        cfg = ModelConfig(name="tiny-calib", family="dense", num_layers=6,
                          d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=512)
        shape = ShapeConfig("calib", 64, 4, "train", microbatches=2)
        dryrun.start_world(8)
        lmesh = derive_logical_mesh(make_host_mesh(2, 4, device="cpu"),
                                    choose_mesh_plan(cfg, model_axis=4))
        fn, inputs = dryrun.cell_program(cfg, lmesh, shape)
        _, an = analyze(fn, *inputs)
        x = torch.empty(8, 3, device="meta")
        _, rs = analyze(cc.reduce_scatter, x, lmesh.group("tp"), 0)
        dryrun.stop_world()
        print(json.dumps({"step": an["collective_count"],
                          "bytes": an["collective_bytes"],
                          "rs": rs["collective_count"],
                          "rs_bytes": rs["collective_bytes"]}))
    """)
    assert res["step"]["all-gather"] > 0 and res["bytes"]["all-gather"] > 0
    assert res["step"]["reduce-scatter"] > 0
    assert res["rs"] == {"reduce-scatter": 1}
    assert res["rs_bytes"] == {"reduce-scatter": 8 * 3 * 4}


def test_gloo_reduce_scatter_keeps_its_all_reduce(tmp_path):
    """On gloo (no reduce-scatter) the repaired ``reduce_scatter`` still
    all-reduces and keeps the rank's chunk: the same numbers on 2 ranks."""
    script = tmp_path / "ranks.py"
    script.write_text(textwrap.dedent("""
        import json, sys
        import torch, torch.distributed as dist
        import torch.multiprocessing as mp

        def rank(r, path, q):
            dist.init_process_group("gloo", init_method="file://" + path,
                                    rank=r, world_size=2)
            from repro_torch.distribution import collectives as cc
            from repro_torch.roofline.op_analysis import analyze
            x = torch.arange(12.0).reshape(4, 3) * (r + 1)
            out, an = analyze(cc.reduce_scatter, x, dist.group.WORLD, 0)
            q.put((r, out.tolist(), an["collective_count"]))
            dist.destroy_process_group()

        if __name__ == "__main__":
            ctx = mp.get_context("spawn")
            q = ctx.Queue()
            ps = [ctx.Process(target=rank, args=(r, sys.argv[1], q))
                  for r in range(2)]
            for p in ps:
                p.start()
            got = {r: (o, c) for r, o, c in (q.get() for _ in ps)}
            for p in ps:
                p.join()
            print(json.dumps(got))
    """))
    out = subprocess.run([sys.executable, str(script),
                          str(tmp_path / "store")],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    full = np.arange(12.0).reshape(4, 3) * 3
    for r in range(2):
        got, counts = res[str(r)]
        np.testing.assert_array_equal(got, full[2 * r:2 * r + 2])
        assert counts == {"all-reduce": 1}
