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
    shapes and both smoke configs fit the plain-FMA kernel's shared memory
    (216 KB at q = 128, p = 64, n = 128), and take a kernel in both
    dtypes; the bf16 serving shapes take the tensor-core one.  Wider ones
    are refused."""
    shapes = [(c[6], c[3], c[5]) for c in SSD_CASES]
    shapes += [(128, 64, 128), (128, 64, 64), (16, 16, 16), (12, 16, 16)]
    for q, p, n in shapes:
        assert tops.kernel_takes(q, p, n), (q, p, n)
        for dtype in (torch.float32, torch.bfloat16):
            assert tops.kernel_for(dtype, p, n, q) in ("tc", "simt")
    for n in (128, 64):  # mamba2-1.3b, zamba2-1.2b at chunk 128
        assert tops.kernel_for(torch.bfloat16, 64, n, 128) == "tc"
    assert tops.smem_bytes(128, 64, 128) == 216704
    assert not tops.kernel_takes(256, 64, 128)
    assert not tops.kernel_takes(128, 128, 64)
    assert not tops.kernel_takes(128, 64, 256)


@pytest.mark.parametrize("dtype,p,n,q,want", [
    (torch.bfloat16, 64, 128, 128, "tc"),   # mamba2-1.3b serving
    (torch.bfloat16, 64, 64, 128, "tc"),    # zamba2-1.2b serving
    (torch.bfloat16, 64, 128, 64, "tc"),
    (torch.bfloat16, 64, 64, 64, "tc"),
    (torch.float32, 64, 128, 128, "simt"),  # TF32 would break 3e-4
    (torch.float32, 64, 64, 128, "simt"),
    (torch.bfloat16, 32, 16, 32, "simt"),   # the reference's SSD_CASES
    (torch.bfloat16, 64, 128, 32, "simt"),
    (torch.bfloat16, 16, 16, 16, "simt"),   # the smoke configs
    (torch.bfloat16, 64, 96, 128, "simt"),
    (torch.bfloat16, 64, 128, 100, "simt")])
def test_ssd_kernel_route_by_dtype_and_shape(dtype, p, n, q, want):
    """bf16 at the models' shapes (p = 64, n in {64, 128}, chunk 64 or
    128) takes the tensor-core kernel; f32 and every other shape the
    plain-FMA one; a pure function of its arguments."""
    assert tops.kernel_for(dtype, p, n, q) == want
    assert tops.kernel_for(dtype, p, n, q) == want


@pytest.mark.parametrize("dtype,p,n,q,exc,match", [
    (torch.float16, 64, 128, 128, TypeError, "float32 or bfloat16"),
    (torch.float32, 128, 64, 128, ValueError, "shared memory"),
    (torch.bfloat16, 64, 256, 128, ValueError, "shared memory"),
    (torch.bfloat16, 64, 128, 256, ValueError, "shared memory")])
def test_ssd_kernel_route_refuses_what_neither_kernel_takes(dtype, p, n, q,
                                                            exc, match):
    with pytest.raises(exc, match=match):
        tops.kernel_for(dtype, p, n, q)


@pytest.mark.parametrize("q,n,want", [(128, 128, 168968), (128, 64, 119816),
                                      (64, 128, 101384), (64, 64, 68616)])
def test_tc_kernel_shared_memory_fits(q, n, want):
    """The tensor-core kernel's footprint (csrc/ssd_scan.cu tc::Layout):
    bf16 C and B tiles, x and its split w x for two heads, two heads' bf16
    state, four per-step f32 vectors; under Hopper's 227 KB per block."""
    assert tops.tc_smem_bytes(q, n) == want
    assert want <= tops.SMEM_LIMIT


# --------------------------------------------------------------------------
# The tensor-core kernel's rounding, emulated on the CPU: C.B^T and every
# product exact in f32 (bf16 x bf16 is exact, sums in f32), M rounded to
# bf16 for M.x, the carried state rounded to bf16 for C.S^T, and the state
# update's operand w x either split in two bf16 terms (hi + lo, as the
# kernel does) or rounded once.

def _bf(t):
    return t.to(torch.bfloat16).float()


def _tc_emulation(x, dt, A, B, C, chunk, *, split=True):
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    nc, q = l // chunk, chunk
    xf = x.float().reshape(b, nc, q, h, p)
    dtf = dt.float().reshape(b, nc, q, h)
    Bh = torch.repeat_interleave(B.float(), rep, 2).reshape(b, nc, q, h, n)
    Ch = torch.repeat_interleave(C.float(), rep, 2).reshape(b, nc, q, h, n)
    S = torch.zeros(b, h, p, n)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bh[:, c], Ch[:, c]
        L = torch.cumsum(dtc * A[None, None], 1)
        Lt = L.transpose(1, 2)
        CB = torch.einsum("bqhn,bshn->bhqs", Cc, Bc)
        M = torch.where(causal, CB * torch.exp(Lt[..., :, None]
                                               - Lt[..., None, :])
                        * dtc.transpose(1, 2)[:, :, None, :], 0.0)
        y = torch.exp(L)[..., None] * torch.einsum("bhpn,bqhn->bqhp",
                                                    _bf(S), Cc)
        ys.append(y + torch.einsum("bhqs,bshp->bqhp", _bf(M), xc))
        Lq = L[:, -1]
        wx = (torch.exp(Lq[:, None] - L) * dtc)[..., None] * xc
        hi = _bf(wx)
        upd = torch.einsum("bqhp,bqhn->bhpn", hi, Bc)
        if split:
            upd = upd + torch.einsum("bqhp,bqhn->bhpn", _bf(wx - hi), Bc)
        S = torch.exp(Lq)[..., None, None] * S + upd
    return torch.stack(ys, 1).reshape(b, l, h, p).to(x.dtype), S


def _bf16_inputs(seed, case):
    b, l, h, p, g, n, _ = case
    x, dt, A, B, C = _t(_inputs(seed, b, l, h, p, g, n))
    return x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16()


@pytest.mark.parametrize("case", [(1, 256, 4, 64, 1, 128, 128),
                                  (1, 256, 4, 64, 1, 64, 128),
                                  (1, 256, 4, 64, 2, 128, 64)])
def test_tc_rounding_holds_bf16_tolerances(case):
    """With M and S rounded to bf16 and w x split in two bf16 terms, y is
    within 2e-2 relative and the final state within 3e-4 absolute of the
    sequential oracle: the card's bf16 tolerances."""
    args = _bf16_inputs(10, case)
    y, s = _tc_emulation(*args, case[-1])
    ry, rs = tops.ssd_ref(*args)
    yt, yr = y.float(), ry.float()
    assert bool(((yt - yr).abs() <= 2e-2 * (1 + yr.abs())).all())
    assert float((s - rs).abs().max()) <= 3e-4


def test_one_bf16_rounding_of_the_state_update_misses_its_tolerance():
    """Rounding w x to bf16 once (2^-9 of every term) misses the state's
    3e-4, where the split operand stays ~100x inside it."""
    case = (1, 256, 8, 64, 1, 128, 128)
    args = _bf16_inputs(0, case)
    _, rs = tops.ssd_ref(*args)
    _, single = _tc_emulation(*args, case[-1], split=False)
    _, split = _tc_emulation(*args, case[-1], split=True)
    assert float((single - rs).abs().max()) > 3e-4
    assert float((split - rs).abs().max()) <= 3e-6
