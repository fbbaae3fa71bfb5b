"""Parity of the port's LM layers and decoder-only transformer with the JAX
package on the CPU, at the llama3.2-3b smoke config: the reference's
initialized params are carried across through numpy
(``transformer.params_from_numpy``), the same tokens go through both, and
logits, caches and greedy tokens are compared — 1e-5 relative in f32,
2e-2 in bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCH = "llama3_2_3b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                                **kw))


def _params(jcfg, tcfg, seed=0):
    jp = jtf.init(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jp, ttf.params_from_numpy(tree, tcfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_configs_match_the_reference():
    for arch in ARCH_IDS:
        assert get_config(arch).__dict__ == jget_config(arch).__dict__
        assert (get_config(arch, smoke=True).__dict__
                == jget_config(arch, smoke=True).__dict__)


def test_params_round_trip_through_numpy():
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    assert len(tp["layers"]) == tcfg.num_layers
    assert tp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    back = ttf.params_to_numpy(tp, tcfg)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    b, s, D = 2, 12, tcfg.d_model
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"])
    lp_t = tp["layers"][0]
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    tol = TOL[dtype]
    assert _rel(tlayers.rmsnorm(tx, lp_t["ln1"]),
                jlayers.rmsnorm(jx, lp_j["ln1"])) <= tol
    q = rng.standard_normal((b, s, 6, 16)).astype(np.float32)
    assert _rel(tlayers.rope(torch.from_numpy(q), torch.from_numpy(pos),
                             tcfg.rope_theta),
                jlayers.rope(jnp.asarray(q), jnp.asarray(pos),
                             jcfg.rope_theta)) <= 1e-5
    z = rng.standard_normal((b, s, D)).astype(np.float32)
    assert _rel(tlayers.rmsnorm_gated(tx, torch.from_numpy(z).to(tx.dtype),
                                      lp_t["ln2"]),
                jlayers.rmsnorm_gated(jx, jnp.asarray(z, jx.dtype),
                                      lp_j["ln2"])) <= tol
    assert _rel(tlayers.mlp_apply(lp_t["mlp"], tx, tcfg),
                jlayers.mlp_apply(lp_j["mlp"], jx, jcfg)) <= tol
    assert _rel(tlayers.attention_apply(lp_t["attn"], tx, tcfg,
                                        torch.from_numpy(pos)),
                jlayers.attention_apply(lp_j["attn"], jx, jcfg,
                                        jnp.asarray(pos))) <= tol


@pytest.mark.parametrize("act", ["gelu", "sq_relu"])
def test_other_mlp_activations(act):
    jcfg, tcfg = _cfgs("float32", mlp_activation=act)
    jp, tp = _params(jcfg, tcfg)
    x = np.random.default_rng(1).standard_normal((2, 5, 96)).astype(
        np.float32)
    assert _rel(tlayers.mlp_apply(tp["layers"][1]["mlp"],
                                  torch.from_numpy(x), tcfg),
                jlayers.mlp_apply(jax.tree.map(lambda a: a[1],
                                               jp["layers"])["mlp"],
                                  jnp.asarray(x), jcfg)) <= 1e-5


def test_cross_entropy_masks_the_padded_vocab():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 520)).astype(np.float32)
    tg = rng.integers(0, 500, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    a = tlayers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(tg),
                              torch.from_numpy(mask), 500)
    b = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(tg),
                              jnp.asarray(mask), 500)
    assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["auto", "chunked"])
def test_apply_matches_reference(dtype, impl):
    jcfg, tcfg = _cfgs(dtype, attention_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 20)).astype(np.int32)
    jl, _ = jtf.apply(jp, jnp.asarray(tokens), jcfg)
    tl, aux = ttf.apply(tp, torch.from_numpy(tokens), tcfg)
    assert tl.dtype == torch.float32 and tl.shape == tuple(jl.shape)
    assert float(aux) == 0.0
    assert _rel(tl, jl) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_match_reference(dtype):
    """Prefill, then four greedy decode steps on both packages: logits and
    caches agree, and in f32 every greedy token is identical."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.default_rng(4).integers(
        1, tcfg.vocab_size, (3, 9)).astype(np.int32)
    max_len = 14
    tol = TOL[dtype]
    jlog, jcache = jtf.prefill(jp, jnp.asarray(tokens), jcfg, max_len)
    tlog, tcache = ttf.prefill(tp, torch.from_numpy(tokens), tcfg, max_len)
    assert tcache["pos"] == 9 and tcache["k"].shape == (2, 3, max_len, 2, 16)
    assert _rel(tlog, jlog) <= tol
    assert _rel(tcache["k"], jcache["k"]) <= tol
    assert _rel(tcache["v"], jcache["v"]) <= tol
    for step in range(4):
        tok = np.array(jnp.argmax(jlog[:, : jcfg.vocab_size], -1),
                         np.int32)
        ttok = torch.argmax(tlog[:, : tcfg.vocab_size], -1).numpy()
        if dtype == "float32":
            np.testing.assert_array_equal(ttok, tok)
        jlog, jcache = jtf.decode_step(jp, jnp.asarray(tok), jcfg, jcache)
        tlog, tcache = ttf.decode_step(tp, torch.from_numpy(tok), tcfg,
                                       tcache)
        assert tcache["pos"] == 10 + step
        assert _rel(tlog, jlog) <= tol, f"step {step}"
    assert _rel(tcache["k"], jcache["k"]) <= tol


def test_prefill_decode_matches_full_forward():
    """Greedy continuation through prefill + decode equals the full-sequence
    forward at every position (the reference's own model check)."""
    _, tcfg = _cfgs("float32", attention_impl="einsum")
    tp = ttf.init(0, tcfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (2, 16)).astype(np.int32))
    full, _ = ttf.apply(tp, tokens, tcfg)
    logits, cache = ttf.prefill(tp, tokens[:, :10], tcfg, 16)
    torch.testing.assert_close(logits, full[:, 9], atol=1e-4, rtol=1e-4)
    for i in range(10, 16):
        logits, cache = ttf.decode_step(tp, tokens[:, i], tcfg, cache)
        torch.testing.assert_close(logits, full[:, i], atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="full"):
        ttf.decode_step(tp, tokens[:, 0], tcfg, cache)


def test_init_draws_the_reference_recipe():
    _, tcfg = _cfgs("float32")
    tp = ttf.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    wq = tp["layers"][0]["attn"]["wq"]
    assert wq.shape == (96, 96) and wq.abs().max() <= 0.04
    assert abs(float(wq.std()) - 0.02 * 0.88) < 2e-3  # truncated at 2 sigma
    assert (tp["embed"]["embedding"].shape
            == (2048, 96))  # padded_vocab(512)
    assert torch.equal(ttf.init(0, tcfg, device="cpu")["ln_f"],
                       torch.ones(96))


@pytest.mark.parametrize("arch,exc", [
    ("mamba2_1_3b", "P11"), ("zamba2_1_2b", "P11"),
    ("seamless_m4t_medium", "P11")])
def test_unported_families_raise(arch, exc):
    """ROADMAP P11 ported the ssm and hybrid families, which now serve (their
    parity with the reference is in test_torch_mamba2.py); the audio family
    (models/encdec.py) still raises naming P11."""
    cfg = get_config(arch, smoke=True)
    if cfg.family == "audio":
        with pytest.raises(NotImplementedError, match=exc):
            get_model(cfg)
        return
    api = get_model(cfg)
    params = api.init(0, cfg, device="cpu")
    tokens = torch.ones((2, 5), dtype=torch.int32)
    logits, cache = api.prefill(params, tokens, cfg, 7)
    logits, _ = api.decode_step(params, tokens[:, 0], cfg, cache)
    assert logits.shape == (2, 2048) and torch.isfinite(logits).all()


def test_experts_raise_naming_p9():
    cfg = get_config("granite_moe_3b_a800m", smoke=True)
    api = get_model(cfg)
    with pytest.raises(NotImplementedError, match="P9"):
        api.init(0, cfg, device="cpu")
