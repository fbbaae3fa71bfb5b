"""The int8 wire of the port against the reference: quantizer bits, the
error-feedback identity, buffer layout and byte accounting."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.updates as j_upd  # noqa: E402
import repro_torch.core.updates as t_upd  # noqa: E402


def _x(seed, shape, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0] = 0.0  # an all-zero row takes the 1e-12 floor
    return x


@pytest.mark.parametrize("shape", [(5, 33), (64, 256), (7, 1), (1, 300)])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bit_identical(shape, seed):
    x = _x(seed, shape)
    (jq,), (js,), (jr,) = j_upd.quantize_rows([jnp.asarray(x)],
                                              compute_residual=True)
    (tq,), (ts,), (tr,) = t_upd.quantize_rows([torch.from_numpy(x)],
                                              compute_residual=True)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    jd = j_upd.dequantize_rows([jq], [js])[0]
    td = t_upd.dequantize_rows([tq], [ts])[0]
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_error_feedback_residual_identity():
    """residual = x - dequantize(quantize(x)) exactly, so deq + res == x."""
    x = torch.from_numpy(_x(0, (5, 33)))
    (q,), (s,), (res,) = t_upd.quantize_rows([x], compute_residual=True)
    deq = t_upd.dequantize_rows([q], [s])[0]
    assert torch.equal(deq + res, x)
    bound = s[:, None] * 0.5 + 1e-7
    assert bool((res.abs() < bound).all())


def _stacked(rng, n):
    return {"w": rng.standard_normal((n, 4, 8)).astype(np.float32),
            "b": rng.standard_normal((n,)).astype(np.float32)}


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_update_buffer_layout_and_bytes_match(wire):
    stacked = _stacked(np.random.default_rng(3), 6)
    make_j = (j_upd.UpdateBuffer.from_stacked if wire == "f32"
              else j_upd.UpdateBuffer.quantized_from_stacked)
    make_t = (t_upd.UpdateBuffer.from_stacked if wire == "f32"
              else t_upd.UpdateBuffer.quantized_from_stacked)
    jb = make_j({k: jnp.asarray(v) for k, v in stacked.items()})
    tb = make_t({k: torch.from_numpy(v) for k, v in stacked.items()})
    # JAX flattens a dict in sorted key order; the port keeps that order.
    assert tb.keys == ("b", "w")
    assert tb.shapes == jb.shapes and tb.dtypes == jb.dtypes
    assert tb.row_nbytes == jb.row_nbytes and tb.num_rows == jb.num_rows
    for a, b in zip(jb.leaves2d, tb.leaves2d):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if wire == "int8":
        for a, b in zip(jb.scales, tb.scales):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for row in (0, 5):
        jr, tr = jb.materialize_row(row), tb.materialize_row(row)
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(jr[k]), tr[k].numpy())
    jm, tm = jb.materialize(), tb.materialize()
    for k in ("w", "b"):
        np.testing.assert_array_equal(np.asarray(jm[k]), tm[k].numpy())
    assert tb.handle(2).nbytes == jb.handle(2).nbytes


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_update_buffer_state_dict_round_trip(wire):
    stacked = {k: torch.from_numpy(v)
               for k, v in _stacked(np.random.default_rng(5), 4).items()}
    buf = (t_upd.UpdateBuffer.from_stacked(stacked) if wire == "f32"
           else t_upd.UpdateBuffer.quantized_from_stacked(stacked))
    back = t_upd.UpdateBuffer.from_state_dict(buf.state_dict())
    assert (back.keys, back.shapes, back.dtypes, back.wire, back.row_nbytes) \
        == (buf.keys, buf.shapes, buf.dtypes, buf.wire, buf.row_nbytes)
    for a, b in zip(back.leaves2d, buf.leaves2d):
        assert torch.equal(a, b)
    got = t_upd.materialize_handles({"x": [buf.handle(1)], "y": 3})
    assert got["y"] == 3
    assert torch.equal(got["x"][0]["w"], buf.materialize_row(1)["w"])


def test_dtype_mapping_and_validation():
    assert t_upd.np_dtype(torch.float32) == np.float32
    assert t_upd.np_dtype(torch.int8) == np.int8
    assert t_upd.np_dtype(np.dtype("float16")) == np.float16
    with pytest.raises(ValueError, match="bfloat16"):
        t_upd.np_dtype(torch.bfloat16)
    with pytest.raises(ValueError, match="sorted"):
        t_upd.UpdateBuffer([torch.ones(2, 1), torch.ones(2, 1)], ("w", "b"),
                           [(), ()], [np.float32, np.float32])
    with pytest.raises(ValueError, match="int8"):
        t_upd.UpdateBuffer([torch.ones(2, 3)], ("w",), [(3,)], [np.float32],
                           wire="int8", scales=[torch.ones(2)])
