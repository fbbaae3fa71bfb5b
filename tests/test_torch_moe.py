"""Parity of the port's mixture-of-experts block and MoE transformer with the
JAX package on the CPU: ``moe_apply`` output and auxiliary loss at the
smoke configs of granite-moe-3b and phi3.5-moe (1e-5 relative in f32, 2e-2
in bf16; one case at a capacity that drops tokens), the routing itself
(experts, positions, gates) exact, full-model logits and greedy tokens,
the continuous engine and the serving CLI's report.  The reference's
params are carried across through numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.serving import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ["granite_moe_3b_a800m", "phi3_5_moe_42b_a6_6b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                                **kw))


def _moe_params(jcfg, tcfg, dtype):
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    tp = {k: ttf._to_tensor(np.asarray(v), torch.device("cpu"))
          for k, v in jp.items()}
    return jp, tp


def _x(cfg, dtype, b=2, s=12, seed=0):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _moe_params(jcfg, tcfg, dtype)
    jx, tx = _x(tcfg, dtype)
    jo, jaux = jmoe.moe_apply(jp, jx, jcfg)
    to, taux = tmoe.moe_apply(tp, tx, tcfg)
    assert to.dtype == tx.dtype and to.shape == tx.shape
    assert _rel(to, jo) <= TOL[dtype]
    assert abs(float(taux) - float(jaux)) <= TOL[dtype] * abs(float(jaux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference_when_capacity_drops_tokens(dtype):
    """A capacity factor of 0.25 leaves room for a quarter of the pairs:
    most tokens lose experts, and the dropped ones must be the
    reference's (the later pairs of each expert in token-major order)."""
    jcfg, tcfg = _cfgs(ARCHS[0], dtype, capacity_factor=0.25)
    jp, tp = _moe_params(jcfg, tcfg, dtype)
    jx, tx = _x(tcfg, dtype, b=3, s=16, seed=1)
    r = tmoe.route(tp["router"], tx.reshape(-1, tcfg.d_model), tcfg)
    dropped = int((r.slot == r.capacity).sum())
    assert r.capacity == tmoe.capacity(48, tcfg) == 6
    assert dropped > 48  # more than one pair per token on average
    jo, jaux = jmoe.moe_apply(jp, jx, jcfg)
    to, taux = tmoe.moe_apply(tp, tx, tcfg)
    assert _rel(to, jo) <= TOL[dtype]
    assert abs(float(taux) - float(jaux)) <= TOL[dtype] * abs(float(jaux))


def test_routing_matches_the_reference_one_hots():
    """Experts, positions, kept gates and capacity equal what the
    reference's one-hot dispatch encodes (rebuilt here from its formulas
    on the same f32 inputs)."""
    jcfg, tcfg = _cfgs(ARCHS[0], "float32", capacity_factor=0.5)
    jp, tp = _moe_params(jcfg, tcfg, "float32")
    jx, tx = _x(tcfg, "float32", b=2, s=20, seed=2)
    T, E, K = 40, tcfg.num_experts, tcfg.experts_per_token
    xt = jx.reshape(T, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    gv, ei = jax.lax.top_k(probs, K)
    gv = gv / jnp.maximum(gv.sum(-1, keepdims=True), 1e-9)
    flat = ei.reshape(-1)
    oh = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = ((jnp.cumsum(oh, axis=0) - 1) * oh).max(axis=-1)
    C = jmoe._capacity(T, jcfg)
    keep = pos < C
    r = tmoe.route(tp["router"], tx.reshape(T, -1), tcfg)
    assert r.capacity == C
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(flat))
    np.testing.assert_array_equal(r.slot.numpy(),
                                  np.asarray(jnp.where(keep, pos, C)))
    np.testing.assert_allclose(
        r.gate.numpy(), np.asarray(gv.reshape(-1) * keep), rtol=1e-6)
    assert int((~keep).sum()) > 0


def test_dispatch_never_builds_a_tokens_by_k_by_experts_by_capacity_tensor():
    """No op inside ``moe_apply`` returns a tensor as large as the
    reference's ``(T, K, E, C)`` dispatch one-hot (here 768 x 2 x 4 x 480
    elements); the biggest are the ``(E, C + 1, d)`` expert inputs and the
    ``(T * K, d)`` gathered rows."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tcfg = _cfgs(ARCHS[0], "float32")
    _, tp = _moe_params(*_cfgs(ARCHS[0], "float32"), "float32")
    _, tx = _x(tcfg, "float32", b=8, s=96)
    T, K, E = 768, tcfg.experts_per_token, tcfg.num_experts
    C = tmoe.capacity(T, tcfg)
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    sizes.append(t.numel())
            return out

    with Sizes():
        tmoe.moe_apply(tp, tx, tcfg)
    assert max(sizes) < T * K * E * C // 8
    assert max(sizes) <= max(E * (C + 1) * tcfg.d_model,
                             T * K * tcfg.d_model, T * K * E)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    jcfg, tcfg = _cfgs(ARCHS[0], dtype)
    jp = jtf.init(jax.random.PRNGKey(0), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return dtype, jcfg, tcfg, jp, tp


def test_params_carry_router_and_expert_weights(model):
    dtype, jcfg, tcfg, jp, tp = model
    lp = tp["layers"][0]
    assert "mlp" not in lp
    assert lp["moe"]["router"].dtype == torch.float32
    assert lp["moe"]["w_up"].dtype == getattr(torch, dtype)
    assert tuple(lp["moe"]["w_down"].shape) == (
        tcfg.num_experts, tcfg.d_ff, tcfg.d_model)
    back = ttf.params_to_numpy(tp, tcfg)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    fresh = ttf.init(0, tcfg, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == \
        jax.tree.structure(ttf.params_to_numpy(fresh, tcfg))


def test_full_model_logits_and_aux_match_reference(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(3).integers(1, tcfg.vocab_size, (2, 16))
    jl, jaux = jtf.apply(jp, jnp.asarray(toks, jnp.int32), jcfg)
    tl, taux = ttf.apply(tp, torch.as_tensor(toks, dtype=torch.int32), tcfg)
    assert _rel(tl, jl) <= TOL[dtype]
    assert abs(float(taux) - float(jaux)) <= TOL[dtype] * abs(float(jaux))
    assert float(taux) > 0


def test_prefill_and_greedy_decode_match_reference(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks = np.random.default_rng(4).integers(1, tcfg.vocab_size, (2, 12))
    jlog, jcache = jtf.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, 24)
    tlog, tcache = ttf.prefill(tp, torch.as_tensor(toks, dtype=torch.int32),
                               tcfg, 24)
    assert _rel(tlog, jlog) <= TOL[dtype]
    jt = jnp.argmax(jlog[:, :jcfg.vocab_size], -1).astype(jnp.int32)
    tt = torch.argmax(tlog[:, :tcfg.vocab_size], -1).to(torch.int32)
    for _ in range(6):
        if dtype == "float32":
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jlog, jcache = jtf.decode_step(jp, jt, jcfg, jcache)
        tlog, tcache = ttf.decode_step(tp, tt, tcfg, tcache)
        assert _rel(tlog, jlog) <= TOL[dtype]
        jt = jnp.argmax(jlog[:, :jcfg.vocab_size], -1).astype(jnp.int32)
        tt = torch.argmax(tlog[:, :tcfg.vocab_size], -1).to(torch.int32)


def test_prefill_decode_matches_full_forward():
    """The reference's consistency check (``test_models.py``) on the port:
    prefill and one decode step reproduce the full forward's logits."""
    tcfg = dataclasses.replace(get_config(ARCHS[0], smoke=True),
                               attention_impl="einsum")
    tp = ttf.init(0, tcfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, tcfg.vocab_size, (2, 17)), dtype=torch.int32)
    full, _ = ttf.apply(tp, toks, tcfg)
    pre, cache = ttf.prefill(tp, toks[:, :16], tcfg, 24)
    v = tcfg.vocab_size
    np.testing.assert_allclose(pre[:, :v].numpy(), full[:, 15, :v].numpy(),
                               atol=0.1, rtol=0.1)
    dec, _ = ttf.decode_step(tp, toks[:, 16], tcfg, cache)
    np.testing.assert_allclose(dec[:, :v].numpy(), full[:, 16, :v].numpy(),
                               atol=0.1, rtol=0.1)


def test_continuous_engine_matches_reference_engine():
    """Tokens and the report of the continuous engine equal the JAX
    engine's in f32: every row of a decode step (idle slots included)
    counts toward the experts' capacity in both."""
    jcfg, tcfg = _cfgs(ARCHS[0], "float32")
    jp = jtf.init(jax.random.PRNGKey(0), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    prompts = np.random.default_rng(0).integers(1, tcfg.vocab_size, (7, 8))
    arrivals = [0.0, 0.0, 0.001, 0.004, 0.02, 0.05, 0.2]
    kw = dict(slots=3, prompt_len=8, decode_tokens=5, max_len=14)
    jeng = JEngine(jcfg, params=jp, **kw)
    teng = ContinuousBatchingEngine(tcfg, params=tp, device="cpu", **kw)
    for eng in (jeng, teng):
        t, k = 0.0, 0
        while k < len(prompts) or eng.has_work:
            while k < len(prompts) and arrivals[k] <= t:
                eng.submit(k, prompts[k], arrivals[k])
                k += 1
            t = t + eng.step(t) if eng.has_work else arrivals[k]
    jrep, trep = jeng.report(), teng.report()
    assert trep.summary(0.05) == jrep.summary(0.05)
    assert [r.tokens for r in trep.records] == [r.tokens
                                               for r in jrep.records]


def test_serve_cli_report_matches_reference(capsys):
    argv = ["--arch", ARCHS[0], "--requests", "24"]
    assert jserve.main(argv) in (0, None)
    want = capsys.readouterr().out
    assert serve.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "p99 latency cut:" in got


def _routing_flips(run) -> tuple[int, int]:
    """(token, k) expert choices that differ between the chunked and the
    einsum attention path, and the pairs in all: ``run(impl)`` returns
    each layer's (T, K) expert indices."""
    a, b = run("chunked"), run("einsum")
    assert len(a) == len(b) == 2
    return (sum(int((x != y).sum()) for x, y in zip(a, b)),
            sum(x.size for x in a))


def test_bf16_routing_flips_between_any_two_attention_paths():
    """In bf16, near-ties between the K-th and the next expert flip some
    choices between two correct attention paths.  The reference's own two
    paths (chunked and einsum) flip about as many as the port's two CPU
    paths, at granite-moe-3b's published width (2 layers of 32; a 4096-token
    vocabulary, which routing never reads) on 2 prompts of 128 tokens.  So
    the bf16 flips the card's cross-check reports between the kernel path
    and the plain path are no sign of a fault in the port."""
    jcfg = dataclasses.replace(jget_config(ARCHS[0]), num_layers=2,
                               vocab_size=4096, dtype="bfloat16")
    tcfg = dataclasses.replace(get_config(ARCHS[0]), num_layers=2,
                               vocab_size=4096, dtype="bfloat16")
    jp = jtf.init(jax.random.PRNGKey(0), jcfg)
    tp = ttf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(0).integers(1, jcfg.vocab_size, (2, 128))
    K = jcfg.experts_per_token

    def jrun(impl):
        got, real = [], jmoe.moe_apply

        def spy(p, x, cfg):
            xt = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
            _, idx = jax.lax.top_k(jax.nn.softmax(xt @ p["router"], -1), K)
            jax.debug.callback(lambda i: got.append(np.asarray(i)), idx,
                               ordered=True)
            return real(p, x, cfg)
        jmoe.moe_apply = spy
        try:
            c = dataclasses.replace(jcfg, attention_impl=impl)
            jax.block_until_ready(jtf.prefill(
                jp, jnp.asarray(toks, jnp.int32), c, 129)[0])
        finally:
            jmoe.moe_apply = real
        return got

    def trun(impl):
        got, real = [], tmoe.route

        def spy(router, xt, cfg):
            r = real(router, xt, cfg)
            got.append(r.expert.view(-1, K).numpy())
            return r
        tmoe.route = spy
        try:
            c = dataclasses.replace(tcfg, attention_impl=impl)
            ttf.prefill(tp, torch.as_tensor(toks, dtype=torch.int32), c, 129)
        finally:
            tmoe.route = real
        return got

    (jflips, pairs), (tflips, tpairs) = _routing_flips(jrun), \
        _routing_flips(trun)
    print(f"bf16 routing flips, chunked vs einsum attention: reference "
          f"{jflips}/{pairs}, port {tflips}/{tpairs}")
    assert pairs == tpairs == 2 * 2 * 128 * K
    assert jflips > 0 and tflips > 0
    assert tflips <= 2 * jflips and jflips <= 2 * tflips
