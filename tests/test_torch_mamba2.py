"""Parity of the port's Mamba2 and Zamba2-style hybrid models with the JAX
package on the CPU, at the mamba2-1.3b and zamba2-1.2b smoke configs: the
reference's initialized params are carried across through numpy
(``params_from_numpy``), the same tokens go through both, and logits,
caches (conv tails, f32 SSM states, K/V) and greedy tokens are compared —
1e-5 relative in f32, 2e-2 in bf16.  Also the serving front end: the
fixed-batch server prints the reference CLI's lines for both families, and
the continuous engine (attention arena only) refuses them up front."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import hybrid as jhybrid  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import hybrid as thybrid  # noqa: E402
from repro_torch.models import mamba2 as tmamba2  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

MODELS = {"mamba2_1_3b": (jmamba2, tmamba2),
          "zamba2_1_2b": (jhybrid, thybrid)}
ARCHS = sorted(MODELS)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jget_config(arch, smoke=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                                **kw))


F32_LEAVES = ("A_log", "dt_bias", "D_skip")  # f32 in every config


@functools.lru_cache(maxsize=None)
def _reference_tree(arch):
    """The reference's f32 params as numpy, initialized once per model (its
    bf16 init is this, cast: it draws in f32 and casts)."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               dtype="float32")
    return jax.tree.map(np.asarray,
                        MODELS[arch][0].init(jax.random.PRNGKey(0), jcfg))


def _params(arch, jcfg, tcfg):
    tree = _reference_tree(arch)
    if jcfg.dtype != "float32":
        dt = jnp.dtype(jcfg.dtype)
        tree = jax.tree_util.tree_map_with_path(
            lambda path, a: a if path[-1].key in F32_LEAVES else a.astype(dt),
            tree)
    jp = jax.tree.map(jnp.asarray, tree)
    return jp, MODELS[arch][1].params_from_numpy(tree, tcfg, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _mamba_caches(arch, jcache, jcfg):
    """The reference's Mamba2 caches as a list of per-layer dicts (it stacks
    them when the model scans its layers)."""
    layers = jcache if arch == "mamba2_1_3b" else jcache["mamba"]
    if arch == "mamba2_1_3b" and jcfg.scan_layers:
        return [jax.tree.map(lambda a, i=i: a[i], layers)
                for i in range(jcfg.num_layers)]
    return layers


def _check_caches(arch, tcache, jcache, jcfg, tol):
    tm = tcache if arch == "mamba2_1_3b" else tcache["mamba"]
    jm = _mamba_caches(arch, jcache, jcfg)
    assert len(tm) == len(jm) == jcfg.num_layers
    for t, j in zip(tm, jm):
        assert t["ssm"].dtype == torch.float32
        for k in ("conv_x", "conv_BC", "ssm"):
            assert tuple(t[k].shape) == tuple(j[k].shape), k
            assert _rel(t[k], j[k]) <= tol, k
    if arch == "zamba2_1_2b":
        assert len(tcache["attn"]) == len(jcache["attn"]) == 2
        for t, j in zip(tcache["attn"], jcache["attn"]):
            assert t["pos"] == int(j["pos"])
            assert _rel(t["k"], j["k"]) <= tol
            assert _rel(t["v"], j["v"]) <= tol


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_through_numpy(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = _params(arch, jcfg, tcfg)
    layers = tp["layers"] if arch == "mamba2_1_3b" else tp["mamba_layers"]
    assert len(layers) == tcfg.num_layers
    assert layers[0]["in_x"].dtype == torch.bfloat16
    for k in ("A_log", "dt_bias", "D_skip"):
        assert layers[0][k].dtype == torch.float32
    back = MODELS[arch][1].params_to_numpy(tp, tcfg)
    ja = jax.tree.leaves(jax.tree.map(np.asarray, jp))
    tb = jax.tree.leaves(back)
    assert len(ja) == len(tb)
    for a, b in zip(ja, tb):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_matches_reference(dtype):
    """One Mamba2 block, full-sequence and prefill (with its cache), on a
    length that pads to the chunk (20 = 16 + 4)."""
    jcfg, tcfg = _cfgs("mamba2_1_3b", dtype)
    jp, tp = _params("mamba2_1_3b", jcfg, tcfg)
    x = np.random.default_rng(0).standard_normal(
        (2, 20, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    lp_j = jax.tree.map(lambda a: a[1], jp["layers"])
    lp_t = tp["layers"][1]
    tol = TOL[dtype]
    assert _rel(tmamba2.block_apply(lp_t, tx, tcfg),
                jmamba2.block_apply(lp_j, jx, jcfg)) <= tol
    ty, tc = tmamba2.block_prefill(lp_t, tx, tcfg, impl="ref")
    jy, jc = jmamba2.block_prefill(lp_j, jx, jcfg, impl="ref")
    assert _rel(ty, jy) <= tol
    for k in ("conv_x", "conv_BC", "ssm"):
        assert _rel(tc[k], jc[k]) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(arch, jcfg, tcfg)
    jmod, tmod = MODELS[arch]
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _ = jmod.apply(jp, jnp.asarray(tokens), jcfg)
    tl, aux = tmod.apply(tp, torch.from_numpy(tokens), tcfg)
    assert tl.dtype == torch.float32 and tl.shape == tuple(jl.shape)
    assert float(aux) == 0.0
    assert _rel(tl, jl) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_reference(arch, dtype):
    """Prefill, then four greedy decode steps on both packages: logits and
    caches agree, and in f32 every greedy token is identical."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _params(arch, jcfg, tcfg)
    jmod, tmod = MODELS[arch]
    tokens = np.random.default_rng(2).integers(
        1, tcfg.vocab_size, (3, 20)).astype(np.int32)
    max_len = 25
    tol = TOL[dtype]
    jlog, jcache = jmod.prefill(jp, jnp.asarray(tokens), jcfg, max_len)
    tlog, tcache = tmod.prefill(tp, torch.from_numpy(tokens), tcfg, max_len)
    assert _rel(tlog, jlog) <= tol
    _check_caches(arch, tcache, jcache, jcfg, tol)
    for step in range(4):
        tok = np.array(jnp.argmax(jlog[:, : jcfg.vocab_size], -1), np.int32)
        ttok = torch.argmax(tlog[:, : tcfg.vocab_size], -1).numpy()
        if dtype == "float32":
            np.testing.assert_array_equal(ttok, tok)
        jlog, jcache = jmod.decode_step(jp, jnp.asarray(tok), jcfg, jcache)
        tlog, tcache = tmod.decode_step(tp, torch.from_numpy(tok), tcfg,
                                        tcache)
        assert _rel(tlog, jlog) <= tol, f"step {step}"
    _check_caches(arch, tcache, jcache, jcfg, tol)
    if arch == "zamba2_1_2b":
        assert [c["pos"] for c in tcache["attn"]] == [24, 24]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Greedy continuation through prefill + decode equals the full-sequence
    forward at every position (the reference's own model check)."""
    _, tcfg = _cfgs(arch, "float32")
    tmod = MODELS[arch][1]
    tp = tmod.init(0, tcfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 22)).astype(np.int32))
    full, _ = tmod.apply(tp, tokens, tcfg)
    logits, cache = tmod.prefill(tp, tokens[:, :17], tcfg, 22)
    torch.testing.assert_close(logits, full[:, 16], atol=1e-4, rtol=1e-4)
    for i in range(17, 22):
        logits, cache = tmod.decode_step(tp, tokens[:, i], tcfg, cache)
        torch.testing.assert_close(logits, full[:, i], atol=1e-4, rtol=1e-4)


def test_init_draws_the_reference_recipe():
    _, tcfg = _cfgs("mamba2_1_3b", "float32")
    tp = tmamba2.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    lp = tp["layers"][0]
    h = tcfg.ssm_heads
    assert lp["in_x"].shape == (64, 128) and lp["in_BC"].shape == (64, 32)
    assert lp["conv_x_w"].abs().max() <= 2 * 0.5 / 4
    torch.testing.assert_close(lp["A_log"], torch.log(torch.arange(1., h + 1)))
    dt = torch.nn.functional.softplus(lp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    hy = thybrid.init(0, _cfgs("zamba2_1_2b", "float32")[1], device="cpu")
    assert set(hy) == {"embed", "mamba_layers", "shared_attn", "ln_f"}
    assert len(hy["mamba_layers"]) == 4 and "wq" in hy["shared_attn"]["attn"]


@pytest.mark.parametrize("arch", ARCHS)
def test_registry_serves_the_family(arch):
    cfg = get_config(arch, smoke=True)
    api = get_model(cfg)
    tmod = MODELS[arch][1]
    assert (api.init, api.prefill, api.decode_step, api.init_cache) == (
        tmod.init, tmod.prefill, tmod.decode_step, tmod.init_cache)
    cache = api.init_cache(cfg, 2, 9, device="cpu")
    mc = cache if arch == "mamba2_1_3b" else cache["mamba"]
    assert len(mc) == cfg.num_layers
    assert mc[0]["ssm"].shape == (2, cfg.ssm_heads, cfg.ssm_head_dim,
                                  cfg.ssm_state)


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_refuses_the_family(arch):
    cfg = get_config(arch, smoke=True)
    with pytest.raises(ValueError, match=cfg.family):
        ContinuousBatchingEngine(cfg, slots=2, prompt_len=4,
                                 decode_tokens=2, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_prints_the_reference_lines(arch, capsys):
    """``--mode fixed`` on both CLIs: the port's lines equal the reference's
    (whose report is pinned by the cost model and the trace: one model's
    run of the reference CLI shows it)."""
    argv = ["--arch", arch, "--mode", "fixed"]
    assert tserve.main(argv + ["--device", "cpu"]) == 0
    port = capsys.readouterr().out
    assert ("fixed-batch: 16 batches, 512 tokens; request traffic 4.0 KiB"
            in port)
    assert "p99= 10687.4ms" in port
    if arch == "mamba2_1_3b":  # the report is the trace's, not the model's
        jserve.main(argv)
        assert port == capsys.readouterr().out
