"""Client-local training in the port against the reference: one device and a
cohort, from zero params and from random params, on the f32 logical tier and
the bf16 device tier."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.devicemodel import GRADES as J_GRADES  # noqa: E402
from repro.core.simulation import DeviceTier as JDeviceTier  # noqa: E402
from repro.core.simulation import LogicalTier as JLogicalTier  # noqa: E402
from repro.models import ctr as jctr  # noqa: E402
from repro_torch.core.devicemodel import GRADES as T_GRADES  # noqa: E402
from repro_torch.core.simulation import DeviceTier, LogicalTier  # noqa: E402
from repro_torch.models import ctr as tctr  # noqa: E402

DIM, RECORDS = 24, 10


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, RECORDS, DIM)) < 0.2).astype(np.float32) / 3.0
    y = (rng.random((n, RECORDS)) < 0.4).astype(np.float32)
    counts = rng.integers(1, RECORDS + 1, n)
    mask = (np.arange(RECORDS)[None] < counts[:, None]).astype(np.float32)
    return {"x": x, "y": y, "mask": mask}


def _params(init, seed=0):
    if init == "zero":
        return {"w": np.zeros(DIM, np.float32), "b": np.zeros((), np.float32)}
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(DIM).astype(np.float32),
            "b": np.float32(rng.standard_normal())}


def _cpu(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("init", ["zero", "random"])
def test_single_device_local_train(init):
    p, batch = _params(init), _data(1, 1)
    b0 = {k: v[0] for k, v in batch.items()}
    jp, jm = jctr.make_local_train_fn(lr=0.1, epochs=10)(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in b0.items()}, jax.random.PRNGKey(0))
    tp, tm = tctr.make_local_train_fn(lr=0.1, epochs=10)(
        tctr.params_from_numpy(p, "cpu"), _cpu(b0), torch.tensor(0))
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-5, rtol=1e-5)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5)


def test_first_step_from_zero_follows_the_reference_tie_rule():
    """Every logit is exactly 0 on the first step from zero params; the
    reference's gradient of max(logits, 0) there is 0, so the step is -y*x.
    A tie rule of 0.5 (torch.maximum) or 1 (clamp) differs by ~5e-4*|x|."""
    batch = {k: v[0] for k, v in _data(2, 1).items()}
    p = _params("zero")
    jg = jax.grad(jctr.bce_loss)({k: jnp.asarray(v) for k, v in p.items()},
                                 batch["x"], batch["y"], batch["mask"])
    tg = torch.func.grad(tctr.bce_loss)(tctr.params_from_numpy(p, "cpu"),
                                        *_cpu(batch).values())
    for k in p:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   atol=1e-7)
    jp, _ = jctr.make_local_train_fn(lr=1e-3, epochs=1)(
        {k: jnp.asarray(v) for k, v in p.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, None)
    tp, _ = tctr.make_local_train_fn(lr=1e-3, epochs=1)(
        tctr.params_from_numpy(p, "cpu"), _cpu(batch), None)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-9, rtol=1e-6)


@pytest.mark.parametrize("init", ["zero", "random"])
def test_logical_tier_cohort_f32(init):
    p, batch = _params(init, 3), _data(4, 9)
    fn_j = jctr.make_local_train_fn(lr=0.05, epochs=10)
    fn_t = tctr.make_local_train_fn(lr=0.05, epochs=10)
    jt = JLogicalTier(fn_j, cohort_size=9)
    res = jt.run_cohort({k: jnp.asarray(v) for k, v in p.items()},
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0), np.ones(9))
    tt = LogicalTier(fn_t, cohort_size=9, device="cpu")
    got = tt.run_cohort(tctr.params_from_numpy(p, "cpu"), _cpu(batch),
                        torch.Generator().manual_seed(0), np.ones(9))
    for k in p:
        np.testing.assert_allclose(got.params[k].numpy(),
                                   np.asarray(res.params[k]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.metrics["loss"].numpy(),
                               np.asarray(res.metrics["loss"]), atol=1e-5)
    buf, _ = tt.run_cohort_zero_copy(tctr.params_from_numpy(p, "cpu"),
                                     _cpu(batch), torch.zeros(9, dtype=torch.int64))
    assert buf.keys == ("b", "w") and buf.shapes == [(), (DIM,)]
    np.testing.assert_allclose(buf.leaves2d[1].numpy(),
                               np.asarray(res.params["w"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("init", ["zero", "random"])
def test_device_tier_cohort_bf16(init):
    p, batch = _params(init, 5), _data(6, 7)
    fn_j = jctr.make_local_train_fn(lr=0.05, epochs=10)
    fn_t = tctr.make_local_train_fn(lr=0.05, epochs=10)
    jt = JDeviceTier(fn_j, J_GRADES["High"])
    want, _ = jt.run_cohort({k: jnp.asarray(v) for k, v in p.items()},
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.split(jax.random.PRNGKey(0), 7))
    tt = DeviceTier(fn_t, T_GRADES["High"], device="cpu")
    got, metrics = tt.run_cohort(tctr.params_from_numpy(p, "cpu"),
                                 _cpu(batch),
                                 torch.zeros(7, dtype=torch.int64))
    for k in p:
        assert got[k].dtype == torch.float32  # cast back to the params dtype
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-2, rtol=2e-2)
    single, _, rep = tt.run_device(3, tctr.params_from_numpy(p, "cpu"),
                                   {k: v[3] for k, v in _cpu(batch).items()},
                                   torch.Generator().manual_seed(1), 0,
                                   benchmark=True)
    np.testing.assert_allclose(single["w"].numpy(), got["w"][3].numpy(),
                               atol=2e-2, rtol=2e-2)
    assert rep.device_id == 3 and len(tt.reports) == 1


def test_accuracy_and_mlp():
    p, batch = _params("random", 7), _data(8, 1)
    x, y = batch["x"][0], batch["y"][0]
    np.testing.assert_allclose(
        float(tctr.accuracy(tctr.params_from_numpy(p, "cpu"),
                            torch.from_numpy(x), torch.from_numpy(y))),
        float(jctr.accuracy({k: jnp.asarray(v) for k, v in p.items()}, x, y)),
        atol=1e-7)
    mp = tctr.mlp_init(DIM, 8, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    assert tctr.mlp_logits(mp, torch.from_numpy(x)).shape == (RECORDS,)
