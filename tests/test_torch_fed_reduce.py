"""``fed_reduce`` in the port: its plain version against the reference's
Pallas kernel (interpret mode) and jnp reference, its launch plan, the fused
aggregation built on it.  The CUDA kernel itself is held against the plain
version on the card by ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.federation as j_fed  # noqa: E402
import repro.core.updates as j_upd  # noqa: E402
from repro.kernels.fed_reduce.ops import fed_reduce as j_fed_reduce  # noqa: E402
import repro_torch.core.federation as t_fed  # noqa: E402
import repro_torch.core.updates as t_upd  # noqa: E402
from repro_torch.kernels.fed_reduce.ops import (  # noqa: E402
    UNROLL,
    fed_reduce as t_fed_reduce,
    plan,
)


def _inputs(seed, n, d, dtype, zero_frac=0.25):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        stack = rng.integers(-127, 128, (n, d)).astype(np.int8)
    else:
        stack = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.random(n) * 20).astype(np.float32)
    w[rng.random(n) < zero_frac] = 0.0
    scales = (rng.random(n) * 1e-2 + 1e-4).astype(np.float32)
    return stack, w, scales


def _j(stack, dtype):
    return jnp.asarray(stack, jnp.bfloat16 if dtype == "bf16" else None)


def _t(stack, dtype):
    t = torch.from_numpy(stack)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


CASES = [(1, 1), (3, 1), (9, 17), (64, 256), (70, 300), (33, 128)]


@pytest.mark.parametrize("n,d", CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("jax_impl", ["pallas_interpret", "ref"])
def test_plain_version_matches_reference(n, d, dtype, jax_impl):
    stack, w, s = _inputs(n * 1000 + d, n, d, dtype)
    scales = s if dtype == "int8" else None
    want = j_fed_reduce(_j(stack, dtype), jnp.asarray(w),
                        scales=None if scales is None else jnp.asarray(scales),
                        impl=jax_impl)
    got = t_fed_reduce(_t(stack, dtype), torch.from_numpy(w),
                       scales=None if scales is None
                       else torch.from_numpy(scales))
    assert got.dtype == torch.float32 and tuple(got.shape) == (d,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def test_zero_weights_and_trailing_shape():
    stack, w, _ = _inputs(0, 12, 24, "f32")
    w[:] = 0.0
    out = t_fed_reduce(torch.from_numpy(stack.reshape(12, 4, 6)),
                       torch.from_numpy(w))
    assert tuple(out.shape) == (4, 6) and not out.any()
    bias = t_fed_reduce(torch.arange(5.0), torch.ones(5))
    assert bias.shape == () and float(bias) == 10.0


def test_rejects_bad_operands():
    with pytest.raises(ValueError, match="weights"):
        t_fed_reduce(torch.ones(4, 3), torch.ones(3))
    with pytest.raises(ValueError, match="scales"):
        t_fed_reduce(torch.zeros(4, 8, dtype=torch.int8), torch.ones(4),
                     scales=torch.ones(3))
    with pytest.raises(ValueError, match="impl"):
        t_fed_reduce(torch.ones(4, 3), torch.ones(4), impl="pallas")


@pytest.mark.parametrize("n,d,itemsize", [
    (8192, 256, 4), (8192, 256, 2), (8192, 256, 1), (8192, 1, 4),
    (8192, 1, 1), (1696, 256, 4), (1, 1, 4), (100000, 300, 4), (5, 7, 2),
    (5616, 4096, 2)])
@pytest.mark.parametrize("aligned", [True, False])
def test_launch_plan_covers_every_row_and_column(n, d, itemsize, aligned):
    p = plan(n, d, itemsize, aligned, sm_count=132)
    vec, tx, ty, splits, rps, tiles = p
    assert (p.vec, p.tiles) == (vec, tiles)
    assert tx * ty == 256 and ty & (ty - 1) == 0
    assert vec in (1, 16 // itemsize)
    if vec > 1:
        assert aligned and d % vec == 0
    assert splits * rps >= n and (splits - 1) * rps < n  # no empty split
    assert 1 <= splits <= 65535
    groups = -(-d // vec)
    # One launch: grid (tiles, splits), one ticket per column tile.
    assert tiles == -(-groups // tx)
    assert tiles * tx * vec >= d and (tiles - 1) * tx * vec < d
    assert plan(n, d, itemsize, aligned, sm_count=132) == p


@pytest.mark.parametrize("sm_count", [1, 78, 114, 132])
def test_launch_plan_scales_splits_with_the_card(sm_count):
    """The split count follows the card's multiprocessors (about four
    blocks per SM) until each thread is down to one unrolled batch of
    eight row loads."""
    vec, tx, ty, splits, rps, tiles = plan(8192, 256, 4, True,
                                           sm_count=sm_count)
    assert (vec, tx, ty, tiles) == (4, 32, 8, 2)
    assert splits == min(-(-sm_count * 4 // 2),
                         -(-8192 // (ty * UNROLL)))
    assert splits * rps >= 8192 and (splits - 1) * rps < 8192
    assert UNROLL >= 4 and -(-rps // ty) >= UNROLL


def _stacked(rng, n):
    return {"w": rng.standard_normal((n, 4, 8)).astype(np.float32),
            "b": rng.standard_normal((n, 3)).astype(np.float32)}


@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_fedavg_delta_matches_reference(wire, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    stacked = _stacked(rng, n)
    g = {"w": rng.standard_normal((4, 8)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    weights = (rng.random(n) * 30 + 1e-3).tolist()
    mk_j = (j_upd.UpdateBuffer.from_stacked if wire == "f32"
            else j_upd.UpdateBuffer.quantized_from_stacked)
    mk_t = (t_upd.UpdateBuffer.from_stacked if wire == "f32"
            else t_upd.UpdateBuffer.quantized_from_stacked)
    jb = mk_j({k: jnp.asarray(v) for k, v in stacked.items()})
    tb = mk_t({k: torch.from_numpy(v) for k, v in stacked.items()})
    want = j_fed.fused_fedavg_delta({k: jnp.asarray(v) for k, v in g.items()},
                                    jb.handles(), weights, server_lr=0.7,
                                    impl="pallas_interpret")
    got = t_fed.fused_fedavg_delta({k: torch.from_numpy(v.copy())
                                    for k, v in g.items()},
                                   tb.handles(), weights, server_lr=0.7)
    host = t_fed.fedavg_delta({k: torch.from_numpy(v.copy())
                               for k, v in g.items()},
                              [tb.materialize_row(i) for i in range(n)],
                              weights, server_lr=0.7)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(host[k].numpy(), got[k].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_donate_params_updates_in_place():
    stacked = {"w": torch.tensor([[2.0], [4.0]])}
    buf = t_upd.UpdateBuffer.from_stacked(stacked)
    g = {"w": torch.zeros(1)}
    out = t_fed.fused_fedavg_delta(g, buf.handles(), [1.0, 3.0], donate=True)
    assert out["w"] is g["w"] and float(g["w"]) == pytest.approx(3.5)


def test_zero_staleness_weights_fall_back_to_uniform():
    buf = t_upd.UpdateBuffer.from_stacked({"w": torch.tensor([[2.0], [4.0]])})
    for streaming in (False, True):
        svc = t_fed.AggregationService(
            {"w": torch.zeros(1)}, trigger=t_fed.ClientCountTrigger(2),
            staleness_discount=lambda s: 0.0, streaming=streaming)
        for i, h in enumerate(buf.handles()):
            svc(t_fed.Delivery(t=0.0, message=t_fed.Message(
                0, i, 0, h, num_samples=i + 1)))
        assert len(svc.history) == 1
        np.testing.assert_allclose(svc.global_params["w"].numpy(), [3.0])


def test_fused_rejects_misaligned_handles():
    buf = t_upd.UpdateBuffer.from_stacked({"other": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="align"):
        t_fed.fused_fedavg_delta({"w": torch.zeros(3)}, buf.handles(),
                                 [1.0, 1.0])
