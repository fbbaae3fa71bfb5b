"""Parity of the port's encoder-decoder model (seamless-m4t-medium backbone)
with the JAX package on the CPU at the smoke config: ``encode``,
``decode_train``, and ``prefill`` + ``decode_step`` with greedy tokens —
1e-5 relative in f32 with equal tokens, 2e-2 in bf16 — the reference's
prefill/decode consistency check for the ``audio`` family, the params
round trip, and the refusal of the serving entry points (the reference has
no serving path for this family either)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro_torch.configs.base import padded_vocab  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCH = "seamless_m4t_medium"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    jp = jed.init(jax.random.PRNGKey(0), jcfg)
    tp = ted.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    src = (rng.standard_normal((2, 20, tcfg.d_model)) * 0.01).astype(
        np.float32)
    toks = rng.integers(1, tcfg.vocab_size, (2, 9)).astype(np.int32)
    return dtype, jcfg, tcfg, jp, tp, src, toks


def test_params_round_trip_through_numpy(model):
    dtype, jcfg, tcfg, jp, tp, _, _ = model
    assert len(tp["encoder"]) == tcfg.num_encoder_layers
    assert len(tp["decoder"]) == tcfg.num_layers
    assert set(tp["decoder"][0]) == {"ln1", "attn", "ln2", "mlp", "ln_x",
                                     "cross"}
    back = ted.params_to_numpy(tp, tcfg)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    fresh = ted.params_to_numpy(ted.init(0, tcfg, device="cpu"), tcfg)
    assert (jax.tree.structure(jax.tree.map(np.asarray, jp))
            == jax.tree.structure(fresh))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(fresh)):
        assert a.shape == b.shape


def test_encode_and_decode_train_match_reference(model):
    dtype, jcfg, tcfg, jp, tp, src, toks = model
    jm = jed.encode(jp, jnp.asarray(src), jcfg)
    tm = ted.encode(tp, torch.from_numpy(src), tcfg)
    assert tm.dtype == getattr(torch, dtype)
    assert _rel(tm, jm) <= TOL[dtype]
    jl = jed.decode_train(jp, jnp.asarray(toks), jm, jcfg)
    tl = ted.decode_train(tp, torch.from_numpy(toks), tm, tcfg)
    assert tl.shape == (2, 9, padded_vocab(tcfg.vocab_size))
    assert _rel(tl, jl) <= TOL[dtype]


def test_prefill_and_greedy_decode_match_reference(model):
    dtype, jcfg, tcfg, jp, tp, src, toks = model
    max_len = 16
    jlog, jc = jed.prefill(jp, jnp.asarray(src), jnp.asarray(toks[:, :8]),
                           jcfg, max_len)
    tlog, tc = ted.prefill(tp, torch.from_numpy(src),
                           torch.from_numpy(toks[:, :8]), tcfg, max_len)
    assert tc["pos"] == 8 and tc["k"].shape == (
        tcfg.num_layers, 2, max_len, tcfg.num_kv_heads, tcfg.head_dim)
    assert tc["xk"].shape == (tcfg.num_layers, 2, 20, tcfg.num_kv_heads,
                              tcfg.head_dim)
    assert _rel(tc["xk"], jc["xk"]) <= TOL[dtype]  # scanned: stacked
    assert _rel(tlog, jlog) <= TOL[dtype]
    v = tcfg.vocab_size
    jt = jnp.argmax(jlog[:, :v], -1).astype(jnp.int32)
    tt = torch.argmax(tlog[:, :v], -1).to(torch.int32)
    for _ in range(6):
        if dtype == "float32":
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jlog, jc = jed.decode_step(jp, jt, jcfg, jc)
        tlog, tc = ted.decode_step(tp, tt, tcfg, tc)
        assert _rel(tlog, jlog) <= TOL[dtype]
        jt = jnp.argmax(jlog[:, :v], -1).astype(jnp.int32)
        tt = torch.argmax(tlog[:, :v], -1).to(torch.int32)
    assert tc["pos"] == 14


def test_prefill_decode_matches_full_forward():
    """``test_models.py``'s consistency check for the ``audio`` family:
    prefill and one decode step reproduce ``decode_train``'s logits."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              attention_impl="einsum")
    api = get_model(cfg)
    assert api.apply is None and api.prefill is ted.prefill
    params = api.init(0, cfg, device="cpu")
    rng = np.random.default_rng(1)
    src = torch.from_numpy((rng.standard_normal((2, 12, cfg.d_model))
                            * 0.01).astype(np.float32)).to(torch.bfloat16)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 17)),
                           dtype=torch.int32)
    memory = ted.encode(params, src, cfg)
    full = ted.decode_train(params, toks, memory, cfg)
    v = cfg.vocab_size
    pre, cache = api.prefill(params, src, toks[:, :16], cfg, 24)
    np.testing.assert_allclose(pre[:, :v].numpy(), full[:, 15, :v].numpy(),
                               atol=0.1, rtol=0.1)
    dec, _ = api.decode_step(params, toks[:, 16], cfg, cache)
    np.testing.assert_allclose(dec[:, :v].numpy(), full[:, 16, :v].numpy(),
                               atol=0.1, rtol=0.1)


def test_decode_refuses_a_full_cache():
    cfg = get_config(ARCH, smoke=True)
    params = ted.init(0, cfg, device="cpu")
    src = torch.zeros((1, 4, cfg.d_model))
    _, cache = ted.prefill(params, src, torch.ones((1, 3), dtype=torch.int32),
                           cfg, 3)
    with pytest.raises(ValueError, match="full"):
        ted.decode_step(params, torch.ones(1, dtype=torch.int32), cfg, cache)
    with pytest.raises(ValueError, match="max_len"):
        ted.prefill(params, src, torch.ones((1, 5), dtype=torch.int32), cfg,
                    4)


def test_serving_entry_points_refuse_the_family(capsys):
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(ValueError, match="no serving path"):
        serve.BatchedServer(cfg, batch_size=2, prompt_len=4,
                            decode_tokens=2, max_len=7, device="cpu")
    with pytest.raises(ValueError, match="no serving path"):
        ContinuousBatchingEngine(cfg, slots=2, prompt_len=4,
                                 decode_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="no serving path"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
