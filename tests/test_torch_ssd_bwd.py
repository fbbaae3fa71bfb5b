"""The SSD scan's backward on the CPU: the port's written-out plain
backward (``kernels/ssd_scan/ref.py::ssd_bwd_ref``, what ``SsdScan`` runs
for CPU tensors and what the card's backward kernels are held to) against
``jax.grad`` of the reference's chunked scan on the same numpy inputs;
chunk invariance, ``gradcheck`` in f64, finite gradients where the decays
overflow above the diagonal, ``vmap(grad)`` through ``SsdScan`` against a
per-sample loop, the routing of the CUDA backward, and the tensor-core
route's algorithm and rounding emulated in plain torch against the plain
backward in f64."""
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


@pytest.mark.parametrize("dtype,p,n,q,route", [
    (torch.bfloat16, 64, 128, 128, "tc"),  # mamba2-1.3b
    (torch.bfloat16, 64, 64, 128, "tc"),  # zamba2-1.2b
    (torch.bfloat16, 64, 128, 64, "tc"),
    (torch.bfloat16, 64, 64, 64, "tc"),
    (torch.float32, 64, 128, 128, "simt"),  # f32 on tensor cores is TF32
    (torch.float32, 16, 16, 16, "simt"),  # the smoke models
    (torch.bfloat16, 1, 1, 1, "simt"),
])
def test_bwd_route_takes_the_models_shapes(dtype, p, n, q, route):
    """bf16 at the forward's tensor-core shapes takes the tensor-core
    backward (exactly where the forward takes its tensor-core kernel),
    everything else the plain-FMA one; both fit the shared memory."""
    assert ops.kernel_for_bwd(dtype, p, n, q) == route
    if route == "tc":
        assert ops.kernel_for(dtype, p, n, q) == "tc"
        assert max(ops.tc_bwd_smem_bytes(q, n).values()) <= ops.SMEM_LIMIT
    else:
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


def test_tc_bwd_scratch_and_shared_memory_sizes():
    """The tensor-core route's sizes (csrc/ssd_scan.cu bwd_tc::
    scratch_floats, which the launch checks against its own, and the three
    block layouts) at mamba2-1.3b's training shape: the plain-FMA
    route's scratch (about half), and every block under its 203 KB."""
    b, l, h, p, g, n, q = 1, 4096, 64, 64, 1, 128, 128
    nc, blocks = l // q, (h // g) // ops.TC_BWD_HEADS
    states = h * nc * p * n
    assert ops.tc_bwd_scratch_floats(b, l, h, p, g, n, q) == (
        states + max(2 * states, nc * blocks * (q * q + 2 * q * n))
        + h * l + h * nc * (p * n // 1024) + h * nc)
    assert ops.tc_bwd_scratch_floats(b, l, h, p, g, n, q) < \
        0.51 * ops.bwd_scratch_floats(b, l, h, p, g, n, q)
    assert ops.tc_bwd_smem_bytes(q, n) == {"local": 100360, "chunk": 188440,
                                           "dbdc": 164888}
    assert ops.tc_bwd_smem_bytes(64, 64) == {"local": 34312, "chunk": 69144,
                                             "dbdc": 66584}
    # A group of fewer heads than a block takes: one block per group.
    assert ops.tc_bwd_scratch_floats(2, 256, 8, 64, 2, 64, 64) == (
        2 * 8 * 4 * 64 * 64 * 3 + 2 * 8 * 256 + 2 * 8 * 4 * 4 + 2 * 8 * 4)


def test_cuda_backward_refuses_cpu_tensors():
    arrs, dy, _ = _inputs(5, 1, 32, 2, 16, 1, 8)
    t = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError, match="CUDA"):
        ops._ssd_scan_bwd_cuda(*t, torch.from_numpy(dy), None, 16)


# --------------------------------------------------------------------------
# The tensor-core route's rounding, emulated on the CPU.  Its algorithm, as
# csrc/ssd_scan.cu bwd_tc lays it out: each chunk's own state contribution
# X = (w x)^T B and cotangent contribution Y = (exp(L) dy)^T C; the
# cross-chunk recurrences in f32; per (chunk, head) u = B dS_out^T, v = C
# S_in^T, the scores with rows s, dL's terms from f32 sums; Wd summed over a
# block's heads before the products with B and C; dB and dC summed over the
# blocks of a group.  bf16 where the kernels round (w x, exp(L) dy, S_in,
# dS_out, M^T, the summed Wd, the outputs), f32 everywhere else; with
# ``exact`` nothing is rounded, which checks the algorithm alone.

def _bf(t):
    return t.to(torch.bfloat16).float()


def _tc_bwd_emulation(x, dt, A, B, C, dy, dstate, chunk, *, exact=False):
    bf = (lambda t: t) if exact else _bf
    acc = torch.float64 if exact else torch.float32
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep, q, nc = h // g, chunk, l // chunk
    hpb = ops.TC_BWD_HEADS
    xf = x.to(acc).reshape(b, nc, q, h, p)
    dyf = dy.to(acc).reshape(b, nc, q, h, p)
    dtf = dt.to(acc).reshape(b, nc, q, h)
    Bh = torch.repeat_interleave(B.to(acc), rep, 2).reshape(b, nc, q, h, n)
    Ch = torch.repeat_interleave(C.to(acc), rep, 2).reshape(b, nc, q, h, n)
    L = torch.cumsum(dtf * A.to(acc), 2)
    Lq = L[:, :, -1]
    rq = torch.exp(Lq[:, :, None] - L)
    w, eL = rq * dtf, torch.exp(L)
    wx, edy = bf(w[..., None] * xf), bf(eL[..., None] * dyf)
    X = torch.einsum("bcshp,bcshn->bchpn", wx, Bh)
    Y = torch.einsum("bcthp,bcthn->bchpn", edy, Ch)
    S = torch.zeros(b, h, p, n, dtype=acc)
    s_in = []
    for c in range(nc):
        s_in.append(bf(S))
        S = torch.exp(Lq[:, c])[..., None, None] * S + X[:, c]
    dS = torch.zeros_like(S) if dstate is None else dstate.to(acc)
    d_out, ss = [None] * nc, torch.zeros(b, nc, h, dtype=acc)
    for c in reversed(range(nc)):
        d_out[c] = bf(dS)
        ss[:, c] = (dS * s_in[c]).sum((-2, -1))
        dS = torch.exp(Lq[:, c])[..., None, None] * dS + Y[:, c]
    idx = torch.arange(q)
    ge, gt = idx[None, :] >= idx[:, None], idx[None, :] > idx[:, None]
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dA = torch.zeros(h, dtype=acc)
    dB = torch.zeros(b, nc, q, g, n, dtype=acc)
    dC = torch.zeros(b, nc, q, g, n, dtype=acc)
    for c in range(nc):
        xc, dyc, Bc, Cc = xf[:, c], dyf[:, c], Bh[:, c], Ch[:, c]
        Lc, dtc, rqc, wc, eLc = (t[:, c].transpose(1, 2)
                                 for t in (L, dtf, rq, w, eL))
        dot = torch.einsum("bshp,bthp->bhst", xc, dyc)  # rows s
        G = torch.einsum("bshn,bthn->bhst", Bc, Cc)
        D = torch.exp(torch.where(ge, Lc[..., None, :] - Lc[..., :, None],
                                  -torch.inf))
        W = dot * G * D
        row, diag = (W * gt).sum(-1), torch.diagonal(W, dim1=-2, dim2=-1)
        col = (W * gt * dtc[..., :, None]).sum(-2)
        Wd = dot * D * dtc[..., :, None]
        M = bf(G * D * dtc[..., :, None])
        u = torch.einsum("bshn,bhpn->bhsp", Bc, d_out[c])
        r = rqc * (xc.transpose(1, 2) * u).sum(-1)
        dx[:, c] = (wc[..., None] * u + torch.einsum(
            "bhst,bthp->bhsp", M, dyc)).transpose(1, 2)
        v = torch.einsum("bthn,bhpn->bhtp", Cc, s_in[c])
        dL = col - dtc * row + eLc * (dyc.transpose(1, 2) * v).sum(-1)
        dL[..., :-1] -= dtc[..., :-1] * r[..., :-1]
        dL[..., -1] += (torch.exp(Lq[:, c]) * ss[:, c]
                        + (dtc[..., :-1] * r[..., :-1]).sum(-1))
        rev = torch.flip(torch.cumsum(torch.flip(dL, (-1,)), -1), (-1,))
        ddt[:, c] = (row + diag + r + A.to(acc)[:, None] * rev).transpose(1, 2)
        dA = dA + (dtc * rev).sum((0, 2))
        for gi in range(g):  # the blocks: up to hpb heads of one group
            for h0 in range(gi * rep, (gi + 1) * rep, hpb):
                hs = list(range(h0, min(h0 + hpb, (gi + 1) * rep)))
                wd = bf(Wd[:, hs].sum(1))
                dB[:, c, :, gi] += torch.einsum(
                    "bst,btn->bsn", wd, Cc[:, :, h0]) + torch.einsum(
                    "bshp,bhpn->bsn", wx[:, c][:, :, hs], d_out[c][:, hs])
                dC[:, c, :, gi] += torch.einsum(
                    "bst,bsn->btn", wd, Bc[:, :, h0]) + torch.einsum(
                    "bthp,bhpn->btn", edy[:, c][:, :, hs], s_in[c][:, hs])
    out = (dx.reshape(b, l, h, p), ddt.reshape(b, l, h), dA,
           dB.reshape(b, l, g, n), dC.reshape(b, l, g, n))
    if exact:
        return out
    return (out[0].to(x.dtype), *out[1:3], out[3].to(B.dtype),
            out[4].to(C.dtype))


def _tc_case(seed, case, *, A=None, dt=None, dstate=True):
    b, l, h, p, g, n, _ = case
    arrs, dy, ds = _inputs(seed, b, l, h, p, g, n, A=A, dt=dt)
    x, dtv, Av, B, C = (torch.from_numpy(a) for a in arrs)
    args = (x.bfloat16(), dtv, Av, B.bfloat16(), C.bfloat16(),
            torch.from_numpy(dy).bfloat16())
    return args, torch.from_numpy(ds) if dstate else None


def _wide_ref(args, ds, chunk):
    return ssd_bwd_ref(*(t.double() for t in args),
                       None if ds is None else ds.double(), chunk=chunk)


@pytest.mark.parametrize("case,A,dstate", [
    ((1, 512, 64, 64, 1, 128, 128), None, False),  # mamba2-1.3b
    ((1, 512, 64, 64, 1, 64, 128), None, False),  # zamba2-1.2b
    ((1, 256, 8, 64, 1, 128, 128), -64.0, True),  # decays that overflow
    ((1, 256, 20, 64, 2, 64, 64), None, True),  # g > 1, a partial block
])
def test_tc_bwd_rounding_holds_bf16_tolerance(case, A, dstate):
    """With bf16 at the tensor-core route's rounding points and f32
    elsewhere, each of dx, ddt, dA, dB and dC is finite and within 2e-2 of
    its largest entry of ``ssd_bwd_ref`` in f64: one rounding of w x holds
    here (the forward's state, at 3e-4, needed a split)."""
    args, ds = _tc_case(7, case, A=A, dt=0.1 if A else None, dstate=dstate)
    got = _tc_bwd_emulation(*args, ds, case[-1])
    want = _wide_ref(args, ds, case[-1])
    for name, a, w in zip(GRADS, got, want):
        assert bool(torch.isfinite(a.float()).all()), name
        err = float((a.double() - w).abs().max() / w.abs().max())
        assert err <= 2e-2, (name, err)


@pytest.mark.parametrize("case", [(2, 256, 8, 64, 2, 64, 64),
                                  (1, 256, 12, 64, 1, 128, 128)])
def test_tc_bwd_algorithm_is_the_written_out_backward(case):
    """Unrounded (in f64), the tensor-core route's algorithm (the states
    from per-chunk contributions, dL's inter term through C S_in^T, Wd
    summed over a block's heads before its products with B and C) gives
    ``ssd_bwd_ref``'s gradients to 1e-10."""
    args, ds = _tc_case(8, case)
    got = _tc_bwd_emulation(*(t.double() for t in args), ds.double(),
                            case[-1], exact=True)
    want = _wide_ref(args, ds, case[-1])
    for name, a, w in zip(GRADS, got, want):
        assert float((a - w).abs().max() / w.abs().max()) <= 1e-10, name
