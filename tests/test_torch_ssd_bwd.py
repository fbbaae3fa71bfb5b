"""The SSD scan's backward on the CPU: the port's written-out plain
backward (``kernels/ssd_scan/ref.py::ssd_bwd_ref``, what ``SsdScan`` runs
for CPU tensors and what the card's backward kernels are held to) against
``jax.grad`` of the reference's chunked scan on the same numpy inputs;
chunk invariance, ``gradcheck`` in f64, finite gradients where the decays
overflow above the diagonal, ``vmap(grad)`` through ``SsdScan`` against a
per-sample loop, and the routing of the CUDA backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ref import ssd_chunked as jssd_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_bwd_ref  # noqa: E402

# (b, l, h, p, g, n, chunk): g = 1 and g < h, chunks 16 to 64, a ragged
# length (100 steps in chunks of 32).
CASES = [
    (2, 128, 4, 32, 1, 16, 32),
    (1, 256, 8, 64, 2, 64, 64),
    (2, 64, 2, 16, 2, 8, 16),
    (1, 100, 4, 16, 2, 8, 32),
]
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(seed, b, l, h, p, g, n, *, A=None, dt=None):
    """x, dt, A, B, C, dy and the final state's cotangent as numpy f32,
    drawn as the reference's tests draw the forward's inputs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    dtv = (np.abs(rng.standard_normal((b, l, h))) * 0.1 + 0.01).astype(
        np.float32) if dt is None else np.full((b, l, h), dt, np.float32)
    Av = (-np.abs(rng.standard_normal(h)) - 0.1).astype(np.float32) \
        if A is None else np.full((h,), A, np.float32)
    B = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dtv, Av, B, C), dy, ds


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_grads(arrs, dy, ds, chunk):
    """jax.grad of <y, dy> (+ <final_state, ds>) through the reference's
    ``ssd_chunked``, the ragged length padded as its ``ssd_scan`` pads."""
    l = arrs[0].shape[1]
    pad = (-l) % chunk

    def padded(t):
        return jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))

    def f(x, dt, A, B, C):
        y, s = jssd_chunked(padded(x), padded(dt), A, padded(B), padded(C),
                            chunk=chunk)
        out = jnp.sum(y[:, :l] * dy)
        return out + (jnp.sum(s * ds) if ds is not None else 0.0)

    return jax.grad(f, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))


def _port_grads(arrs, dy, ds, chunk):
    t = [torch.from_numpy(a) for a in arrs]
    return ssd_bwd_ref(*t, torch.from_numpy(dy),
                       None if ds is None else torch.from_numpy(ds),
                       chunk=chunk)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_jax_grad_of_reference_chunked(case, with_dstate):
    b, l, h, p, g, n, chunk = case
    arrs, dy, ds = _inputs(0, b, l, h, p, g, n)
    ds = ds if with_dstate else None
    want = _jax_grads(arrs, dy, ds, chunk)
    got = _port_grads(arrs, dy, ds, chunk)
    for name, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert _rel(a.numpy(), w) <= 3e-4, name


def test_bwd_ref_is_chunk_invariant():
    arrs, dy, ds = _inputs(1, 1, 128, 2, 16, 1, 8)
    outs = [_port_grads(arrs, dy, ds, c) for c in (16, 32, 64, 128)]
    for other in outs[1:]:
        for name, a, w in zip(GRADS, other, outs[0]):
            assert _rel(a.numpy(), w.numpy()) <= 2e-4, name


def test_ssd_scan_passes_gradcheck_in_f64():
    """Autograd through ``SsdScan`` (the plain forward and ssd_bwd_ref in
    f64) against finite differences: a ragged length, g < h and the final
    state's cotangent."""
    gen = torch.Generator().manual_seed(0)
    b, l, h, p, g, n, q = 1, 11, 4, 3, 2, 5, 4

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).requires_grad_(True)

    x, B, C = rnd(b, l, h, p), rnd(b, l, g, n, scale=0.5), rnd(b, l, g, n)
    dt = (torch.rand((b, l, h), generator=gen, dtype=torch.float64) * 0.3
          + 0.05).requires_grad_(True)
    A = (-torch.rand((h,), generator=gen, dtype=torch.float64)
         - 0.2).requires_grad_(True)

    def f(x, dt, A, B, C):
        return ops.ssd_scan(x, dt, A, B, C, chunk=q)

    assert torch.autograd.gradcheck(f, (x, dt, A, B, C))


def test_reference_grad_is_nan_where_decays_overflow_and_port_is_finite():
    """At A = -64, dt = 0.1 the decays above the diagonal overflow: the
    reference's ``jnp.where(causal, CB * decay, 0)`` passes 0 * inf back
    into ddt, dA, dB and dC (NaN); the port selects the exponent and its
    gradients are finite, and they match the reference at an ordinary
    decay (the test above)."""
    arrs, dy, _ = _inputs(2, 2, 256, 8, 64, 1, 128, A=-64.0, dt=0.1)
    want = _jax_grads(arrs, dy, None, 128)
    assert any(np.isnan(np.asarray(w)).any() for w in want[1:])
    got = _port_grads(arrs, dy, None, 128)
    for name, a in zip(GRADS, got):
        assert torch.isfinite(a).all(), name
    # dx does not pass through the overflowing entries: it still agrees.
    assert _rel(got[0].numpy(), want[0]) <= 3e-4


def test_bwd_ref_in_f32_keeps_dA_where_decays_overflow():
    """At A = -64 the largest terms of dL (W[t,t], and dt r at the last
    step) enter it with both signs; the plain backward leaves them out, so
    in f32 every gradient, dA included, stays within 3e-4 of the same
    backward in f64 (summed, they would leave dA ~3e-3 off)."""
    arrs, dy, ds = _inputs(6, 2, 256, 8, 64, 1, 128, A=-64.0, dt=0.1)
    got = _port_grads(arrs, dy, ds, 128)
    wide = ssd_bwd_ref(*(torch.from_numpy(a).double() for a in arrs),
                       torch.from_numpy(dy).double(),
                       torch.from_numpy(ds).double(), chunk=128)
    for name, a, w in zip(GRADS, got, wide):
        err = float((a.double() - w).abs().max() / w.abs().max())
        assert err <= 3e-4, (name, err)


def test_vmap_grad_through_ssd_scan_equals_a_loop():
    """The federated clients' pattern: params (A) shared, data batched;
    the vmapped dimension is folded into the heads."""
    n, (b, l, h, p, g, ns, q) = 3, (2, 40, 4, 8, 2, 6, 16)
    arrs = [torch.from_numpy(np.stack([a * (1 + 0.2 * i) for i in range(n)]))
            for a in _inputs(3, b, l, h, p, g, ns)[0]]
    xs, dts, _, Bs, Cs = arrs
    A = arrs[2][0]
    from torch.func import grad, vmap

    def loss(A, x, dt, B, C):
        y, s = ops.ssd_scan(x, dt, A, B, C, chunk=q)
        return (y ** 2).sum() + (s * s).sum()

    argnums = (0, 1, 2, 3, 4)
    batched = vmap(grad(loss, argnums=argnums),
                   in_dims=(None, 0, 0, 0, 0))(A, xs, dts, Bs, Cs)
    for i in range(n):
        one = grad(loss, argnums=argnums)(A, xs[i], dts[i], Bs[i], Cs[i])
        for a, w in zip(batched, one):
            torch.testing.assert_close(a[i], w, atol=1e-6, rtol=1e-6)


def test_autograd_through_ssd_scan_is_the_written_out_backward():
    """``ssd_scan``'s gradient on CPU tensors is ``ssd_bwd_ref``'s, the
    final state's cotangent included, bit for bit."""
    arrs, dy, ds = _inputs(4, 2, 96, 4, 16, 2, 8)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, s = ops.ssd_scan(*leaves, chunk=32)
    got = torch.autograd.grad((y, s), leaves,
                              (torch.from_numpy(dy), torch.from_numpy(ds)))
    want = _port_grads(arrs, dy, ds, 32)
    for name, a, w in zip(GRADS, got, want):
        assert torch.equal(a, w), name


@pytest.mark.parametrize("dtype,p,n,q", [
    (torch.bfloat16, 64, 128, 128),  # mamba2-1.3b
    (torch.bfloat16, 64, 64, 128),  # zamba2-1.2b
    (torch.float32, 64, 128, 128),
    (torch.float32, 16, 16, 16),  # the smoke models
    (torch.bfloat16, 1, 1, 1),
])
def test_bwd_route_takes_the_models_shapes(dtype, p, n, q):
    assert ops.kernel_for_bwd(dtype, p, n, q) == "simt"
    assert ops.bwd_smem_bytes(q, p) <= ops.SMEM_LIMIT


@pytest.mark.parametrize("dtype,p,n,q,exc", [
    (torch.float16, 64, 128, 128, TypeError),
    (torch.float64, 16, 16, 16, TypeError),
    (torch.float32, 128, 64, 64, ValueError),
    (torch.bfloat16, 64, 256, 128, ValueError),
    (torch.bfloat16, 64, 128, 256, ValueError),
])
def test_bwd_route_refuses_what_the_kernels_do_not_take(dtype, p, n, q, exc):
    with pytest.raises(exc):
        ops.kernel_for_bwd(dtype, p, n, q)


def test_bwd_scratch_and_shared_memory_sizes():
    """The sizes the launch checks against its own (csrc/ssd_scan.cu
    bwd::scratch_floats, bwd::chunk_smem_floats) at mamba2-1.3b's training
    shape."""
    b, l, h, p, g, n, q = 1, 4096, 64, 64, 1, 128, 128
    nc = l // q
    assert ops.bwd_scratch_floats(b, l, h, p, g, n, q) == (
        nc * q * q + 2 * h * nc * p * n + 2 * l * h * n + h * nc)
    assert ops.bwd_smem_bytes(q, p) == 203392


def test_cuda_backward_refuses_cpu_tensors():
    arrs, dy, _ = _inputs(5, 1, 32, 2, 16, 1, 8)
    t = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="CUDA"):
        ops._ssd_scan_bwd_cuda(*t, torch.from_numpy(dy), None, 16)
