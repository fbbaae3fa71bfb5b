"""Parity of the port's AdamW and SGD (``repro_torch.optim.optimizers``) with
the JAX package's on the CPU: the learning-rate schedule, three AdamW steps
on a bf16 tree with global-norm clipping active (f32 master, m and v within
1e-6 relative; the bf16 params equal wherever the two masters round alike),
the global norm, SGD, and the AdamW state carried across through numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and these small ops slow down many-fold when every worker's thread
    pool spins on all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CFG = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
           grad_clip=1.0)
SHAPES = {"a": (8, 5), "b": (7,), "layers": [{"w": (4, 3)}, {"w": (4, 3)}]}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(v, fn) for v in shapes]
    return fn(shapes)


def _np_tree(rng, scale=1.0):
    return _tree(SHAPES, lambda s: (rng.standard_normal(s) * scale)
                 .astype(np.float32))


def _bf16_pair(x):
    """The same bf16 values in both packages (rounded once, in JAX)."""
    j = jnp.asarray(x, jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _jleaves(tree):
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in
            jax.tree.leaves(tree)]


def _tleaves(tree):
    return [x.float().numpy() for x in topt.tree_leaves(tree)]


def test_lr_schedule_matches_reference():
    jc, tc = jopt.AdamWConfig(**CFG), topt.AdamWConfig(**CFG)
    for cfg in ((jc, tc), (jopt.AdamWConfig(), topt.AdamWConfig())):
        steps = np.arange(0, 201, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jopt.lr_schedule(cfg[0], s))(
            jnp.asarray(steps)))
        got = topt.lr_schedule(cfg[1], torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_three_steps_with_clipping_match_reference():
    rng = np.random.default_rng(0)
    p_np = _np_tree(rng, 0.5)
    jp = jax.tree.map(lambda x: _bf16_pair(x)[0], p_np)
    tp = topt.tree_map(lambda x: _bf16_pair(x)[1], p_np)
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    jc, tc = jopt.AdamWConfig(**CFG), topt.AdamWConfig(**CFG)
    for step in range(3):
        g_np = _np_tree(rng, 3.0)  # global norm ~20: clipping active
        jg = jax.tree.map(jnp.asarray, g_np)
        tg = topt.tree_map(lambda x: torch.from_numpy(x.copy()), g_np)
        assert float(jopt.global_norm(jg)) > 10 * CFG["grad_clip"]
        np.testing.assert_allclose(float(topt.global_norm(tg)),
                                   float(jopt.global_norm(jg)), rtol=1e-6)
        jp, jstate, jm = jopt.adamw_update(jc, jg, jstate, jp)
        tp, tstate, tm = topt.adamw_update(tc, tg, tstate, tp)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for key in ("master", "m", "v"):
            for a, b in zip(_tleaves(tstate[key]), _jleaves(jstate[key])):
                np.testing.assert_allclose(a, b, rtol=1e-6,
                                           atol=1e-6 * np.abs(b).max())
        # The bf16 params are the masters rounded: equal wherever the two
        # masters round to the same bf16 value (a master one f32 ulp off
        # may sit on the other side of a rounding tie).
        for pt, pj, mt, mj in zip(_tleaves(tp), _jleaves(jp),
                                  _tleaves(tstate["master"]),
                                  _jleaves(jstate["master"])):
            same = (torch.from_numpy(mt).bfloat16().float().numpy()
                    == np.asarray(jnp.asarray(mj, jnp.bfloat16)
                                  .astype(jnp.float32)))
            np.testing.assert_array_equal(pt[same], pj[same])
            assert same.mean() > 0.99


def test_adamw_updates_in_place_and_consumes_grads():
    tp = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = topt.adamw_init(tp)
    g = {"w": torch.full((4,), 0.5)}
    p_out, s_out, _ = topt.adamw_update(topt.AdamWConfig(), g, state, tp)
    assert p_out is tp and s_out is state
    assert not torch.equal(state["m"]["w"], torch.zeros(4))
    with pytest.raises(TypeError, match="f32 grads"):
        topt.adamw_update(topt.AdamWConfig(), {"w": g["w"].bfloat16()},
                          state, tp)


def test_adamw_init_and_sgd_match_reference():
    rng = np.random.default_rng(1)
    p_np = _np_tree(rng)
    jp = jax.tree.map(lambda x: _bf16_pair(x)[0], p_np)
    tp = topt.tree_map(lambda x: _bf16_pair(x)[1], p_np)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for key in ("master", "m", "v"):
        for a, b in zip(_tleaves(ts[key]), _jleaves(js[key])):
            np.testing.assert_array_equal(a, b)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    g_np = _np_tree(rng)
    jn = jopt.sgd_update(jax.tree.map(jnp.asarray, g_np), jp, 0.05)
    tn = topt.sgd_update(topt.tree_map(torch.from_numpy, g_np), tp, 0.05)
    for a, b in zip(_tleaves(tn), _jleaves(jn)):
        np.testing.assert_array_equal(a, b)


def test_opt_state_from_numpy_carries_the_reference_state():
    rng = np.random.default_rng(2)
    jp = jax.tree.map(jnp.asarray, _np_tree(rng))
    js = jopt.adamw_init(jp)
    js["step"] = jnp.asarray(7, jnp.int32)
    tree = jax.tree.map(np.asarray, js)

    def convert(t, device):
        return topt.tree_map(lambda a: torch.as_tensor(a.copy(),
                                                       device=device), t)

    ts = topt.opt_state_from_numpy(tree, convert, device="cpu")
    assert int(ts["step"]) == 7 and ts["step"].dtype == torch.int32
    for key in ("master", "m", "v"):
        for a, b in zip(_tleaves(ts[key]), _jleaves(js[key])):
            np.testing.assert_array_equal(a, b)
