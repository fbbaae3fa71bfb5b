"""Parity of the port's SSD scan (``kernels/ssd_scan``) with the JAX package
on the CPU: the sequential oracle, the chunked version the wrapper takes for
CPU tensors, and the reference's Pallas kernel in interpret mode, on the
same numpy inputs; the decode step's continuation of a scan, chunk
invariance, the padding of a ragged length, the decays that overflow above
the diagonal, and the shapes the CUDA kernel takes."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan import ops as jops  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref  # noqa: E402
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_decode_step as jssd_decode_step,
)
from repro_torch.kernels.ssd_scan import ops as tops  # noqa: E402

SSD_CASES = [
    # (b, l, h, p, g, n, chunk) — tests/test_kernels.py:186
    (2, 128, 4, 32, 1, 16, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 2, 16, 2, 8, 16),
    (1, 128, 4, 64, 1, 128, 128),  # mamba2-1.3b-like dims
]
SMALLEST = [SSD_CASES[2], SSD_CASES[0]]


def _inputs(seed, b, l, h, p, g, n, *, A=None, dt=None):
    """x, dt, A, B, C as numpy f32, drawn as the reference's tests do."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dtv = (np.abs(rng.standard_normal((b, l, h))) * 0.1 + 0.01).astype(
        np.float32) if dt is None else np.full((b, l, h), dt, np.float32)
    Av = (-np.abs(rng.standard_normal(h)) - 0.1).astype(np.float32) \
        if A is None else np.full((h,), A, np.float32)
    B = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    return x, dtv, Av, B, C


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_ref_matches_reference_oracle(case):
    b, l, h, p, g, n, _ = case
    arrs = _inputs(0, b, l, h, p, g, n)
    ty, ts = tops.ssd_scan(*_t(arrs), impl="ref")
    jy, js = jssd_ref(*_j(arrs))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)
    assert ty.dtype == torch.float32 and ts.shape == (b, h, p, n)


@pytest.mark.parametrize("case", SSD_CASES)
def test_chunked_matches_sequential_oracle(case):
    """The port's chunked version against the reference's oracle at the
    reference test's tolerance (test_kernels.py:207), and against the
    reference's chunked version."""
    b, l, h, p, g, n, chunk = case
    arrs = _inputs(1, b, l, h, p, g, n)
    ty, ts = tops.ssd_scan(*_t(arrs), chunk=chunk, impl="chunked")
    jy, js = jssd_ref(*_j(arrs))
    _close(ty, jy, 3e-4)
    _close(ts, js, 3e-4)
    cy, cs = jops.ssd_scan(*_j(arrs), chunk=chunk, impl="chunked")
    _close(ty, cy, 1e-5)
    _close(ts, cs, 1e-5)


@pytest.mark.parametrize("case", SMALLEST)
def test_chunked_matches_pallas_interpret(case):
    b, l, h, p, g, n, chunk = case
    arrs = _inputs(2, b, l, h, p, g, n)
    ty, ts = tops.ssd_scan(*_t(arrs), chunk=chunk)  # "auto" on the CPU
    jy, js = jops.ssd_scan(*_j(arrs), chunk=chunk, impl="pallas_interpret")
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


@pytest.mark.parametrize("case", SSD_CASES[:3])
def test_bf16_inputs_match_reference(case):
    """x, B and C in bf16 (dt and A f32, as the model passes them): y in
    bf16 within 2e-2 of the reference's, the f32 state within 1e-5."""
    b, l, h, p, g, n, chunk = case
    x, dt, A, B, C = _inputs(3, b, l, h, p, g, n)
    tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    ty, ts = tops.ssd_scan(tx, torch.from_numpy(dt), torch.from_numpy(A),
                           tB, tC, chunk=chunk)
    jx, jB, jC = (jnp.asarray(a, jnp.bfloat16) for a in (x, B, C))
    jy, js = jops.ssd_scan(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                           chunk=chunk, impl="chunked")
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    yt, yj = ty.float().numpy(), np.asarray(jy, np.float32)
    assert np.all(np.abs(yt - yj) <= 2e-2 * (1 + np.abs(yj)))
    _close(ts, js, 1e-5)


def test_decode_step_continues_scan():
    b, l, h, p, g, n = 1, 64, 4, 32, 2, 16
    arrs = _inputs(4, b, l + 1, h, p, g, n)
    x, dt, A, B, C = _t(arrs)
    y_full, s_full = tops.ssd_ref(x, dt, A, B, C)
    _, s_pre = tops.ssd_scan(x[:, :l], dt[:, :l], A, B[:, :l], C[:, :l],
                             chunk=16)
    y_step, s_step = tops.ssd_decode_step(x[:, l], dt[:, l], A, B[:, l],
                                          C[:, l], s_pre)
    _close(y_step, y_full[:, l], 1e-4)
    _close(s_step, s_full, 1e-4)
    jx, jdt, jA, jB, jC = _j(arrs)
    jy, js = jssd_decode_step(jx[:, l], jdt[:, l], jA, jB[:, l], jC[:, l],
                              jnp.asarray(s_pre.numpy()))
    _close(y_step, jy, 1e-6)
    _close(s_step, js, 1e-6)


def test_chunk_size_invariance():
    b, l, h, p, g, n = 2, 128, 4, 16, 2, 16
    args = _t(_inputs(5, b, l, h, p, g, n))
    outs = [tops.ssd_scan(*args, chunk=c) for c in (16, 32, 64, 128)]
    for y, s in outs[1:]:
        _close(y, outs[0][0], 2e-4)
        _close(s, outs[0][1], 2e-4)


@pytest.mark.parametrize("l,chunk", [(100, 32), (500, 128), (20, 16)])
def test_ragged_length_pads_with_identity_steps(l, chunk):
    """l % chunk != 0: padded with dt = 0 steps, y cut back to l; the same
    as the sequential oracle and as the reference's padding path."""
    arrs = _inputs(6, 1, l, 4, 16, 1, 8)
    ty, ts = tops.ssd_scan(*_t(arrs), chunk=chunk)
    assert ty.shape == (1, l, 4, 16)
    ry, rs = tops.ssd_ref(*_t(arrs))
    _close(ty, ry, 3e-4)
    _close(ts, rs, 3e-4)
    jy, js = jops.ssd_scan(*_j(arrs), chunk=chunk, impl="chunked")
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def test_overflowing_decays_leave_no_nan():
    """A = -64 and dt = 0.1: L falls by 6.4 a step, so exp(L_t - L_s) above
    the diagonal is inf; the chunked version selects it away."""
    arrs = _inputs(7, 2, 256, 4, 32, 1, 16, A=-64.0, dt=0.1)
    ty, ts = tops.ssd_scan(*_t(arrs), chunk=128)
    assert torch.isfinite(ty).all() and torch.isfinite(ts).all()
    ry, rs = tops.ssd_ref(*_t(arrs))
    _close(ty, ry, 3e-4)
    _close(ts, rs, 3e-4)
    jy, js = jops.ssd_scan(*_j(arrs), chunk=128, impl="chunked")
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


def test_init_state_continues_a_split_scan():
    arrs = _t(_inputs(8, 1, 96, 4, 16, 2, 8))
    x, dt, A, B, C = arrs
    y, s = tops.ssd_ref(x, dt, A, B, C)
    _, s1 = tops.ssd_chunked(x[:, :32], dt[:, :32], A, B[:, :32], C[:, :32],
                             chunk=16)
    y2, s2 = tops.ssd_chunked(x[:, 32:], dt[:, 32:], A, B[:, 32:],
                              C[:, 32:], chunk=16, init_state=s1)
    _close(y2, y[:, 32:], 1e-4)
    _close(s2, s, 1e-4)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    args = _t(_inputs(9, 1, 32, 2, 16, 1, 8))
    before = tops.ssd_scan.launches
    tops.ssd_scan(*args, chunk=16)
    assert tops.ssd_scan.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tops.ssd_scan(*args, chunk=16, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.ssd_scan(*args, chunk=16, impl="pallas")
    with pytest.raises(ValueError, match="do not fit"):
        tops.ssd_scan(args[0], args[1][:, :8], *args[2:], chunk=16)


def test_kernel_takes_every_shape_the_models_give_it():
    """Chunk, head dim and state of the reference's SSD_CASES, both serving
    shapes and both smoke configs fit the kernel's shared memory (216 KB
    at q = 128, p = 64, n = 128); wider ones are refused."""
    shapes = [(c[6], c[3], c[5]) for c in SSD_CASES]
    shapes += [(128, 64, 128), (128, 64, 64), (16, 16, 16), (12, 16, 16)]
    for q, p, n in shapes:
        assert tops.kernel_takes(q, p, n), (q, p, n)
    assert tops.smem_bytes(128, 64, 128) == 216704
    assert not tops.kernel_takes(256, 64, 128)
    assert not tops.kernel_takes(128, 128, 64)
    assert not tops.kernel_takes(128, 64, 256)
