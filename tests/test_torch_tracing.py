"""The port's spans (``repro_torch.runtime.tracing``) on the CPU: a smoke-size
mamba2 training step and served batch traced under ``torch.profiler``, the
spans each opens and their parents, nothing recorded with the profiler off,
the same numbers with tracing on and off, the bounded buffer, the parent of
a span opened on another thread, and host syncs charged where they
happen."""
import collections
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.distribution.steps import init_train_state  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import make_cloud_step  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402

CFG = get_config("mamba2_1_3b", smoke=True)
L = CFG.num_layers
N_MICRO, DECODE = 2, 3


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.reset()
    yield
    tracing.reset()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _train(steps: int, traced: bool):
    """``steps`` smoke-size steps from one seeded state: (losses, params)."""
    shape = ShapeConfig("t", 32, 4, "train", microbatches=N_MICRO)
    pipe = TokenPipeline(CFG.vocab_size, shape.seq_len, shape.global_batch,
                         seed=0)
    step = make_cloud_step(CFG, shape, pipe, device="cpu")
    state = init_train_state(CFG, 0, device="cpu")

    def run():
        nonlocal state
        losses = []
        for _ in range(steps):
            state, m = step(state)
            losses.append(m["loss"])
        return losses
    losses = _profiled(run) if traced else run()
    return losses, state["params"]


class _Msg:
    def __init__(self, device_id, prompt):
        self.device_id = device_id
        self.payload = {"tokens": np.asarray(prompt, np.int32)}


def _serve(traced: bool, fused: bool = True):
    """One batch of two requests (ids 7 and 9): their served tokens."""
    prompts = np.random.default_rng(3).integers(1, CFG.vocab_size, (2, 8))
    server = serve.BatchedServer(CFG, batch_size=2, prompt_len=8,
                                 decode_tokens=DECODE, max_len=8 + DECODE,
                                 fused=fused, device="cpu")
    for rid, p in zip((7, 9), prompts):
        server.queue.append((_Msg(rid, p), 0.0))
    (_profiled if traced else lambda f: f())(lambda: server._serve_batch(0.0))
    return {r.request_id: r.tokens for r in server.records}


def _tree(records):
    """(span by id, child spans by parent id)."""
    by_id = {r.id: r for r in records}
    kids = collections.defaultdict(list)
    for r in records:
        kids[r.parent].append(r)
    return by_id, kids


def test_a_traced_training_step_opens_its_spans():
    _train(2, traced=True)
    records = tracing.records()
    by_id, kids = _tree(records)
    steps = [r for r in records if r.name == "train.step"]
    assert len(steps) == 2
    for s in steps:
        assert s.parent is None and s.attrs["tokens"] == 4 * 32
        names = collections.Counter(k.name for k in kids[s.id])
        assert names == {"train.batch": 1, "train.forward": N_MICRO,
                         "train.backward": N_MICRO, "train.optimizer": 1}
        for part in ("train.forward", "train.backward"):
            spans = [k for k in kids[s.id] if k.name == part]
            assert sorted(k.attrs["microbatch"] for k in spans) == \
                list(range(N_MICRO))
            blocks = [b for k in spans for b in kids[k.id]]
            # The forward's blocks, then each recomputed once in the backward.
            assert len(blocks) == L * N_MICRO
            assert {b.name for b in blocks} == {"model.block"}
        for k in kids[s.id]:
            assert s.start <= k.start <= k.end <= s.end
    assert all(r.parent is None or r.parent in by_id for r in records)


@pytest.mark.parametrize("fused", [True, False])
def test_a_traced_batch_opens_its_spans(fused):
    _serve(traced=True, fused=fused)
    records = tracing.records()
    _, kids = _tree(records)
    (batch,) = [r for r in records if r.name == "serve.batch"]
    assert batch.attrs["size"] == 2 and batch.attrs["requests"] == [7, 9]
    names = collections.Counter(k.name for k in kids[batch.id])
    assert names == {"serve.gather": 1, "serve.prefill": 1,
                     "serve.decode": DECODE, "serve.readback": 1}
    decodes = [k for k in kids[batch.id] if k.name == "serve.decode"]
    assert [k.attrs["j"] for k in decodes] == list(range(DECODE))
    for k in kids[batch.id]:
        blocks = kids[k.id]
        want = L if k.name in ("serve.prefill", "serve.decode") else 0
        assert len(blocks) == want
        assert all(b.name == "model.block" for b in blocks)
    # Every span of the batch carries its requests' ids.
    assert all(r.attrs["requests"] == [7, 9] for r in records)


@pytest.mark.parametrize("path", ["train", "serve"])
def test_tracing_records_nothing_off_and_changes_no_number(path):
    if path == "train":
        off_losses, off_params = _train(2, traced=False)
        assert tracing.records() == []
        on_losses, on_params = _train(2, traced=True)
        assert tracing.records()
        for a, b in zip(off_losses, on_losses):
            assert torch.equal(a, b)
        pairs = list(zip(tree_leaves(off_params), tree_leaves(on_params)))
        assert len(pairs) > 3 * L
        assert all(torch.equal(a, b) for a, b in pairs)
    else:
        off = _serve(traced=False)
        assert tracing.records() == []
        assert _serve(traced=True) == off
        assert tracing.records()


def test_the_buffer_holds_the_capacity_of_spans():
    assert tracing._records.maxlen == tracing.CAPACITY == 65536


def test_off_a_span_is_one_shared_no_op():
    assert tracing.span("a") is tracing.span("b", unit=True, x=1)

    @tracing.spanned("f")
    def f(x):
        return x + 1
    assert f(1) == 2 and tracing.records() == []


def test_the_buffer_keeps_only_the_last_spans(monkeypatch):
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=8))

    def many():
        for i in range(20):
            with tracing.span("s", i=i):
                pass
    _profiled(many)
    got = tracing.records()
    assert [r.attrs["i"] for r in got] == list(range(12, 20))


@pytest.mark.parametrize("waits", [True, False])
def test_a_span_on_a_thread_with_none_open_takes_the_waiting_span(waits):
    def engine():
        with tracing.span("model.block"):
            pass

    def run():
        with tracing.span("train.backward", waits=waits) as w:
            t = threading.Thread(target=engine)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            return w
    w = _profiled(run)
    (block,) = [r for r in tracing.records() if r.name == "model.block"]
    assert block.thread != threading.get_ident()
    assert block.parent == (w.id if waits else None)


@pytest.fixture
def sync_mode(monkeypatch):
    """CUDA sync debugging's mode, faked: a card's mode without one."""
    mode = {"now": 0, "set": []}

    def set_mode(m):
        mode["now"] = m
        mode["set"].append(m)
    monkeypatch.setattr(tracing, "_get_sync_mode", lambda: mode["now"])
    monkeypatch.setattr(tracing, "_set_sync_mode", set_mode)
    return mode


def _sync():
    warnings.warn(tracing.SYNC_MESSAGE + " (raised as torch raises it)")


def test_syncs_are_counted_in_the_innermost_span_and_swallowed(sync_mode):
    def run():
        with tracing.span("serve.batch", unit=True):
            assert sync_mode["now"] == 1
            _sync()
            with tracing.span("serve.readback"):
                _sync()
                _sync()
                with pytest.warns(UserWarning, match="other"):
                    warnings.warn("other")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a sync warning that escaped raises
        _profiled(run)
    got = {r.name: r.syncs for r in tracing.records()}
    assert got == {"serve.batch": 1, "serve.readback": 2}
    assert sync_mode["set"] == [1, 0] and sync_mode["now"] == 0


@pytest.mark.parametrize("mode", [2, None])
def test_a_mode_set_on_entry_is_left_alone(sync_mode, mode):
    sync_mode["now"] = mode  # 2: the sanitizer's "error"; None: no card

    def run():
        with tracing.span("train.step", unit=True):
            with pytest.warns(UserWarning, match="synchronizing"):
                _sync()
    _profiled(run)
    assert sync_mode["set"] == [] and sync_mode["now"] == mode
    assert [r.syncs for r in tracing.records()] == [0]
