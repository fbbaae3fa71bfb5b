"""Parity of the port's serving path with the JAX package on the CPU: the
continuous-batching engine's tokens, host report and per-iteration stats
equal the reference engine's on the same prompts and params (f32 smoke
config, exact), and the reference's own serving checks hold on the port —
continuous == fixed-batch tokens, the fused decode loop == the per-token
loop, the partial-batch drain, the >= 2x p99 cut on a diurnal trace, and
the same DeviceFlow byte accounting."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.deviceflow import VirtualClock as JClock  # noqa: E402
from repro.core.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.core.serving import ContinuousServer as JServer  # noqa: E402
from repro.core.traffic_curves import diurnal as jdiurnal  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.analysis import sanitizers  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.deviceflow import VirtualClock  # noqa: E402
from repro_torch.core.serving import (  # noqa: E402
    ContinuousBatchingEngine,
    ContinuousServer,
    IterationStats,
    RequestRecord,
    ServeCostModel,
    ServingReport,
    arena_decode,
    arena_prefill,
    init_arena,
)
from repro_torch.core.traffic_curves import diurnal  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "llama3_2_3b"


@pytest.fixture(scope="module")
def model():
    """f32 smoke config on both packages and the reference's params."""
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    jp = jtf.init(jax.random.PRNGKey(0), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


class _FakeMsg:
    def __init__(self, device_id, prompt):
        self.device_id = device_id
        self.payload = {"tokens": np.asarray(prompt, np.int32)}


def _drive(eng, prompts, arrivals):
    """Submit each prompt at its arrival time and step the engine on the
    iteration boundaries; returns the final virtual time."""
    order = sorted(range(len(prompts)), key=lambda i: arrivals[i])
    t, k = 0.0, 0
    while k < len(order) or eng.has_work:
        while k < len(order) and arrivals[order[k]] <= t:
            eng.submit(order[k], prompts[order[k]], arrivals[order[k]])
            k += 1
        if eng.has_work:
            t += eng.step(t)
        else:
            t = arrivals[order[k]]
    return t


def test_engine_matches_reference_engine_exactly(model):
    """Tokens, the host report and every IterationStats equal the JAX
    engine's: 9 staggered requests through 3 slots (slot reuse, queueing,
    partial admissions)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, tcfg.vocab_size, size=(9, 8))
    arrivals = [0.0, 0.0, 0.001, 0.004, 0.004, 0.02, 0.021, 0.05, 0.2]
    kw = dict(slots=3, prompt_len=8, decode_tokens=5, max_len=14)
    jeng = JEngine(jcfg, params=jp, **kw)
    teng = ContinuousBatchingEngine(tcfg, params=tp, device="cpu", **kw)
    assert _drive(jeng, prompts, arrivals) == _drive(teng, prompts, arrivals)
    jrep, trep = jeng.report(), teng.report()
    assert trep.summary(0.05) == jrep.summary(0.05)
    assert [dataclasses.astuple(i) for i in teng.iterations] == [
        dataclasses.astuple(i) for i in jeng.iterations]
    assert isinstance(teng.iterations[0], IterationStats)
    for a, b in zip(trep.records, jrep.records):
        assert (a.request_id, a.arrival_t, a.start_t, a.first_token_t,
                a.finish_t, a.slot, a.decoded) == (
            b.request_id, b.arrival_t, b.start_t, b.first_token_t,
            b.finish_t, b.slot, b.decoded)
        assert a.tokens == b.tokens, f"request {a.request_id}"
        assert len(a.tokens) == 6


def test_arena_ops_write_slots_in_place(model):
    """arena_prefill fills the admitted slots' rows and lengths and drops
    the padding rows; arena_decode advances only active slots."""
    _, tcfg, _, tp = model
    arena = init_arena(tcfg, 3, 12, device="cpu")
    k_before = arena["kv"]["k"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, 512, (3, 6)).astype(np.int32))
    first, arena = arena_prefill(tp, toks, torch.tensor([2, 3, 3],
                                                        dtype=torch.int32),
                                 arena, tcfg)
    assert arena["kv"]["k"] is k_before  # in place
    assert arena["lengths"].tolist() == [0, 0, 6]
    assert arena["kv"]["k"][:, 2, :6].abs().sum() > 0
    assert arena["kv"]["k"][:, :2].abs().sum() == 0
    tok = torch.zeros(3, dtype=torch.int32)
    tok[2] = first[0]
    nxt, arena = arena_decode(tp, tok, torch.tensor([False, False, True]),
                              arena, tcfg)
    assert arena["lengths"].tolist() == [0, 0, 7]
    assert nxt[:2].tolist() == [0, 0]
    assert arena["kv"]["k"][:, :2].abs().sum() == 0


def test_continuous_tokens_identical_to_fixed_batch(model):
    """7 requests through 3 slots decode the token sequences the
    fixed-batch server produces serving each prompt alone."""
    _, tcfg, _, tp = model
    n, slots, prompt_len, decode_tokens = 7, 3, 8, 5
    max_len = prompt_len + decode_tokens + 1
    prompts = np.random.default_rng(2).integers(1, tcfg.vocab_size,
                                                size=(n, prompt_len))
    eng = ContinuousBatchingEngine(
        tcfg, slots=slots, prompt_len=prompt_len,
        decode_tokens=decode_tokens, max_len=max_len, params=tp,
        device="cpu")
    for i in range(n):
        eng.submit(i, prompts[i], t=0.0)
    t = 0.0
    while eng.has_work:
        t += eng.step(t)
    cont = {r.request_id: r.tokens for r in eng.report().records}
    ref = serve.BatchedServer(tcfg, batch_size=1, prompt_len=prompt_len,
                              decode_tokens=decode_tokens, max_len=max_len,
                              params=tp, device="cpu")
    for i in range(n):
        ref.queue.append((_FakeMsg(i, prompts[i]), 0.0))
        ref._serve_batch(0.0, size=1)
    fixed = {r.request_id: r.tokens for r in ref.records}
    assert set(cont) == set(fixed) == set(range(n))
    for i in range(n):
        assert len(cont[i]) == decode_tokens + 1
        assert cont[i] == fixed[i], f"request {i} diverged"
    assert max(it.n_active for it in eng.iterations) == slots


def test_fused_decode_matches_token_loop(model):
    _, tcfg, _, tp = model
    prompts = np.random.default_rng(3).integers(1, tcfg.vocab_size,
                                                size=(4, 8))

    def run(fused):
        server = serve.BatchedServer(tcfg, batch_size=4, prompt_len=8,
                                     decode_tokens=6, max_len=16, params=tp,
                                     fused=fused, device="cpu")
        for i in range(4):
            server.queue.append((_FakeMsg(i, prompts[i]), 0.0))
        server._serve_batch(0.0)
        return {r.request_id: r.tokens for r in server.records}

    assert run(True) == run(False)


def test_batched_server_matches_reference_tokens(model):
    jcfg, tcfg, jp, tp = model
    prompts = np.random.default_rng(4).integers(1, tcfg.vocab_size,
                                                size=(3, 8))
    out = []
    for mod, cfg, kw in ((jserve, jcfg, {}),
                         (serve, tcfg, dict(params=tp, device="cpu"))):
        server = mod.BatchedServer(cfg, batch_size=3, prompt_len=8,
                                   decode_tokens=4, max_len=13, seed=0, **kw)
        for i in range(3):
            server.queue.append((_FakeMsg(i, prompts[i]), 0.0))
        server._serve_batch(0.0)
        out.append([(r.request_id, r.tokens, r.finish_t)
                    for r in server.records])
    assert out[0] == out[1]


def test_drain_flushes_partial_batch(model):
    _, tcfg, _, tp = model
    server = serve.BatchedServer(tcfg, batch_size=4, prompt_len=8,
                                 decode_tokens=2, max_len=11, params=tp,
                                 device="cpu")
    prompts = np.random.default_rng(5).integers(1, tcfg.vocab_size,
                                                size=(5, 8))
    for i in range(5):
        server.queue.append((_FakeMsg(i, prompts[i]), float(i)))
    server.drain(10.0)
    assert not server.queue
    assert sorted(r.request_id for r in server.records) == list(range(5))
    assert all(r.finish_t is not None for r in server.records)
    assert [m.batch_size for m in server.metrics] == [4, 1]


def test_trace_cuts_p99_and_matches_reference_report(model):
    """Same diurnal trace and cost model: continuous p99 >= 2x better than
    fixed batching, tokens equal across modes, and both reports, the
    shelf's byte counters and the engine's iterations equal the JAX
    package's."""
    jcfg, tcfg, jp, tp = model
    kw = dict(prompt_len=8, decode_tokens=4, max_len=13, seed=0,
              cost_model=ServeCostModel())
    trace = dict(requests=24, prompt_len=8, vocab_size=tcfg.vocab_size,
                 interval=60.0, seed=0)

    fixed = serve.BatchedServer(tcfg, batch_size=4, params=tp, device="cpu",
                                **kw)
    f_flow = serve.run_trace(fixed, curve=diurnal(), **trace)
    engine = ContinuousBatchingEngine(tcfg, slots=4, params=tp,
                                      device="cpu", **kw)
    clock = VirtualClock()
    c_flow = serve.run_trace(ContinuousServer(engine, clock), clock=clock,
                             curve=diurnal(), **trace)
    rep_f, rep_c = fixed.report(), engine.report()
    assert len(rep_f.finished()) == len(rep_c.finished()) == 24
    assert rep_c.p99_latency_s > 0
    assert rep_f.p99_latency_s >= 2.0 * rep_c.p99_latency_s
    assert rep_c.p99_ttft_s <= rep_f.p99_ttft_s
    assert ({r.request_id: r.tokens for r in rep_f.records}
            == {r.request_id: r.tokens for r in rep_c.records})

    jfixed = jserve.BatchedServer(jcfg, batch_size=4, **kw)
    jf_flow = jserve.run_trace(jfixed, curve=jdiurnal(), **trace)
    jengine = JEngine(jcfg, slots=4, params=jp, **kw)
    jclock = JClock()
    jc_flow = jserve.run_trace(JServer(jengine, jclock), clock=jclock,
                               curve=jdiurnal(), **trace)
    assert rep_f.summary(1.0) == jfixed.report().summary(1.0)
    assert rep_c.summary(1.0) == jengine.report().summary(1.0)
    assert [dataclasses.astuple(i) for i in engine.iterations] == [
        dataclasses.astuple(i) for i in jengine.iterations]
    for a, b in ((f_flow, jf_flow), (c_flow, jc_flow)):
        sa, sb = a.shelf(0), b.shelf(0)
        assert (sa.total_bytes_dispatched, sa.total_dispatched) == (
            sb.total_bytes_dispatched, sb.total_dispatched)
        assert sa.total_bytes_dispatched == 24 * 8 * 4


def test_engine_step_is_a_marked_hot_path():
    assert ContinuousBatchingEngine.step.__simdc_hot_path__
    # Armed on the CPU the sanitizer has nothing to check; the step runs.
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    eng = ContinuousBatchingEngine(cfg, slots=2, prompt_len=4,
                                   decode_tokens=2, device="cpu")
    eng.submit(0, np.arange(1, 5), 0.0)
    with sanitizers.override(True):
        while eng.has_work:
            eng.step(0.0)
    assert len(eng.report().records[0].tokens) == 3


def test_simulate_only_engine_needs_no_model():
    eng = ContinuousBatchingEngine(slots=2, prompt_len=4, decode_tokens=3,
                                   simulate_only=True)
    for i in range(3):
        eng.submit(i, None, 0.0)
    t = 0.0
    while eng.has_work:
        t += eng.step(t)
    rep = eng.report()
    assert len(rep.finished()) == 3 and eng.device is None
    assert [it.n_active for it in eng.iterations] == [2, 2, 2, 1, 1, 1]


def test_serving_report_stats_and_goodput():
    def rec(i, arrival, first, finish):
        r = RequestRecord(request_id=i, arrival_t=arrival)
        r.first_token_t, r.finish_t = first, finish
        return r

    recs = [rec(0, 0.0, 0.5, 1.0), rec(1, 0.0, 1.0, 3.0),
            rec(2, 1.0, 2.0, 11.0),
            RequestRecord(request_id=3, arrival_t=5.0)]
    rep = ServingReport(records=recs, horizon_s=10.0)
    assert len(rep.finished()) == 3
    assert rep.p50_latency_s == pytest.approx(3.0)
    assert rep.p99_latency_s == pytest.approx(
        float(np.percentile([1.0, 3.0, 10.0], 99)))
    assert rep.p50_ttft_s == pytest.approx(1.0)
    assert rep.goodput_rps(5.0) == pytest.approx(0.2)
    s = rep.summary(5.0)
    assert s["requests"] == 4 and s["finished"] == 3
    assert s["slo_attainment"] == pytest.approx(2 / 3)


def test_main_runs_on_cpu_when_asked(capsys):
    assert serve.main(["--device", "cpu", "--requests", "6",
                       "--prompt-len", "4", "--decode-tokens", "2"]) == 0
    out = capsys.readouterr().out
    assert "fixed-batch: 2 batches" in out and "p99 latency cut" in out


def test_main_co_train_names_the_missing_scheduler(capsys):
    """``--co-train`` runs the serve-over-train schedule (it used to exit
    naming the missing scheduler): the burst preempts training once."""
    assert serve.main(["--device", "cpu", "--co-train", "--requests", "6",
                       "--prompt-len", "4", "--decode-tokens", "2"]) == 0
    out = capsys.readouterr().out
    assert "co-training: serving burst at t=" in out
    assert "training preempted 1x" in out and "'preempted': True" in out


def _cli(module, *args):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                          env=env, capture_output=True, text=True,
                          check=True).stdout.splitlines()


def test_co_train_cli_prints_the_reference_lines():
    """``python -m repro_torch.launch.serve --co-train --device cpu`` and
    ``python -m repro.launch.serve --co-train``, each in a fresh process:
    the same lines, the co-training decision log included."""
    got = _cli("repro_torch.launch.serve", "--co-train", "--device", "cpu")
    want = _cli("repro.launch.serve", "--co-train")
    assert got == want
    assert any(line.startswith("co-training: serving burst") for line in got)


def test_co_serving_schedule_matches_reference():
    for kw in ({"peak_t": 30.0}, {"peak_t": 500.0, "cost_model_gate": False},
               {"peak_t": 30.0, "train_rounds": 2}):
        got, want = serve.co_serving_schedule(**kw), jserve.co_serving_schedule(
            **kw)
        rows = [[(ex.task.priority, ex.started_t, ex.finished_t,
                  ex.preemptions, ex.queueing_delay_s,
                  [{k: v for k, v in d.items() if k != "preemptor"}
                   for d in ex.preemption_decisions])
                 for ex in sorted(e.completed, key=lambda x: x.task.task_id)]
                for e in (got, want)]
        assert rows[0] == rows[1]
        assert got.makespan == want.makespan
