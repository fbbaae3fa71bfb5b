"""Parity of the port's attention kernels' plain versions with the JAX
package on the CPU: ``decode_attention`` and ``flash_attention`` (the
reference's Pallas kernels in interpret mode and its jnp oracles), the
split-and-combine, stale-KV and empty-slot contracts, the arena slot
helpers, and the decode kernel's launch plan.  Inputs are numpy arrays
drawn from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import ops as jdec  # noqa: E402
from repro.kernels.flash_attention import ops as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jattn  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdec  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tflash  # noqa: E402

FLASH_CASES = [
    # (b, sq, sk, h, kv, d, causal, q_offset) — test_kernels.py:27
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 8, 8, 128, False, 0),
    (2, 96, 200, 6, 2, 64, True, 104),
    (1, 1, 256, 4, 1, 64, True, 255),
    (1, 512, 512, 2, 1, 32, True, 0),
    (2, 40, 40, 6, 2, 16, True, 0),  # GQA group of 3 (llama3.2-3b's)
]
DECODE_CASES = [
    # (b, s, h, kv, d) — test_kernels.py:65, plus the group of 3
    (2, 256, 8, 2, 64),
    (1, 512, 4, 4, 128),
    (3, 300, 6, 1, 64),
    (2, 64, 16, 16, 32),
    (3, 96, 24, 8, 16),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 3e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, dt):
    """The same numpy values as a JAX array and a torch tensor of dtype
    ``dt`` (bf16 rounding happens once, in numpy->f32->bf16 on both)."""
    jd, td, _ = DTYPES[dt]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_plain_matches_reference(case, dt):
    b, s, h, kv, d = case
    rng = np.random.default_rng(hash(case) % 2**32)
    q, kc, vc = (_rand(rng, (b, h, d)), _rand(rng, (b, s, kv, d)),
                 _rand(rng, (b, s, kv, d)))
    lens = rng.integers(1, s + 1, size=b).astype(np.int32)
    tol = DTYPES[dt][2]
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(kc, dt), _pair(vc, dt)
    out = tdec.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert out.dtype == tq.dtype and out.shape == (b, h, d)
    kernel = jdec.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                   impl="pallas_interpret")
    oracle = jdec.decode_attention_ref(
        jq.astype(jnp.float32), jk.astype(jnp.float32),
        jv.astype(jnp.float32), jnp.asarray(lens))
    np.testing.assert_allclose(_np(out), _np(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(out), _np(oracle), atol=tol, rtol=tol)


def test_decode_partial_combine_matches_reference_and_full():
    """Split partials + combine == the full decode, and each split's
    (o, m, l) equals the reference's (3e-5)."""
    b, s, h, kv, d, nsh = 2, 512, 6, 2, 64, 8
    rng = np.random.default_rng(1)
    q, kc, vc = (_rand(rng, (b, h, d)), _rand(rng, (b, s, kv, d)),
                 _rand(rng, (b, s, kv, d)))
    lens = rng.integers(1, s + 1, size=b).astype(np.int32)
    full = tdec.decode_attention_ref(torch.from_numpy(q),
                                     torch.from_numpy(kc),
                                     torch.from_numpy(vc),
                                     torch.from_numpy(lens))
    ssh = s // nsh
    parts = []
    for i in range(nsh):
        sl = slice(i * ssh, (i + 1) * ssh)
        shard_len = np.clip(lens - i * ssh, 0, ssh).astype(np.int32)
        t = tdec.decode_attention_partial(
            torch.from_numpy(q), torch.from_numpy(kc[:, sl]),
            torch.from_numpy(vc[:, sl]), torch.from_numpy(shard_len))
        j = jdec.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(kc[:, sl]), jnp.asarray(vc[:, sl]),
            jnp.asarray(shard_len))
        for a, r in zip(t, j):
            np.testing.assert_allclose(_np(a), _np(r), atol=3e-5, rtol=3e-5)
        parts.append(t)
    out = tdec.combine_partials(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=3e-5)
    jout = jdec.combine_partials(
        *(jnp.asarray(torch.stack(x).numpy()) for x in zip(*parts)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=3e-5)


def test_decode_reused_slot_ignores_stale_kv():
    """A reused slot keeps the retired request's rows past the new length,
    yet attends exactly as over a zero-scrubbed cache (1e-6)."""
    slots, s, h, kv, d, new_len = 4, 96, 6, 2, 32, 24
    rng = np.random.default_rng(2)
    old_k = torch.from_numpy(_rand(rng, (slots, s, kv, d)))
    old_v = torch.from_numpy(_rand(rng, (slots, s, kv, d)))
    rows_k = torch.from_numpy(_rand(rng, (1, new_len, kv, d)))
    rows_v = torch.from_numpy(_rand(rng, (1, new_len, kv, d)))
    sid = torch.tensor([2], dtype=torch.int32)
    dirty_k = tdec.scatter_prefill_rows(old_k.clone(), rows_k, sid)
    dirty_v = tdec.scatter_prefill_rows(old_v.clone(), rows_v, sid)
    clean_k, clean_v = dirty_k.clone(), dirty_v.clone()
    clean_k[2, new_len:] = 0.0
    clean_v[2, new_len:] = 0.0
    assert dirty_k[2, new_len:].abs().max() > 0  # reuse, not a wipe
    lens = torch.tensor([s, 13, new_len, s], dtype=torch.int32)
    q = torch.from_numpy(_rand(rng, (slots, h, d)))
    a = tdec.decode_attention(q, dirty_k, dirty_v, lens)
    c = tdec.decode_attention(q, clean_k, clean_v, lens)
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-6)


def test_decode_zero_length_slot_outputs_exact_zeros():
    slots, s, h, kv, d = 3, 64, 4, 2, 16
    rng = np.random.default_rng(3)
    kc = torch.from_numpy(_rand(rng, (slots, s, kv, d)))
    vc = torch.from_numpy(_rand(rng, (slots, s, kv, d)))
    q = torch.from_numpy(_rand(rng, (slots, h, d)))
    out = tdec.decode_attention(q, kc, vc,
                                torch.tensor([0, 5, 0], dtype=torch.int32))
    assert (out[0] == 0).all() and (out[2] == 0).all()
    assert out[1].abs().max() > 0


def test_scatter_and_gather_sentinels_match_reference():
    """Out-of-range slot ids and write positions are padding: the port's
    in-place helpers leave exactly what the reference's drop/fill modes
    leave."""
    cache = np.zeros((3, 8, 2, 4), np.float32)
    rows = np.arange(2 * 5 * 2 * 4, dtype=np.float32).reshape(2, 5, 2, 4) + 1
    sids = np.array([1, 3], np.int32)
    t = tdec.scatter_prefill_rows(torch.from_numpy(cache.copy()),
                                  torch.from_numpy(rows),
                                  torch.from_numpy(sids))
    j = jdec.scatter_prefill_rows(jnp.asarray(cache), jnp.asarray(rows),
                                  jnp.asarray(sids))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    tok = np.full((3, 2, 4), 7.0, np.float32)
    pos = np.array([5, 8, 0], np.int32)
    t2 = tdec.scatter_decode_token(t.clone(), torch.from_numpy(tok),
                                   torch.from_numpy(pos))
    j2 = jdec.scatter_decode_token(j, jnp.asarray(tok), jnp.asarray(pos))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
    ids = np.array([2, 3, 0, 7], np.int32)
    np.testing.assert_array_equal(
        tdec.gather_slots(t2, torch.from_numpy(ids)).numpy(),
        np.asarray(jdec.gather_slots(j2, jnp.asarray(ids))))
    # Every slot padded: nothing changes.
    t3 = tdec.scatter_prefill_rows(t2.clone(), torch.from_numpy(rows),
                                   torch.tensor([3, 9], dtype=torch.int32))
    np.testing.assert_array_equal(t3.numpy(), t2.numpy())


def test_slot_sources_inverts_the_scatter():
    src = tdec.slot_sources(torch.tensor([2, 4, 0, 4], dtype=torch.int32), 4)
    assert src.tolist() == [2, -1, 0, -1]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_plain_matches_reference(case, dt):
    b, sq, sk, h, kv, d, causal, off = case
    rng = np.random.default_rng(hash(case) % 2**32)
    q, k, v = (_rand(rng, (b, sq, h, d)), _rand(rng, (b, sk, kv, d)),
               _rand(rng, (b, sk, kv, d)))
    tol = DTYPES[dt][2]
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    kw = dict(causal=causal, q_offset=off)
    out = tflash.flash_attention(tq, tk, tv, **kw)  # CPU: "chunked"
    assert out.dtype == tq.dtype and out.shape == (b, sq, h, d)
    kernel = jflash.flash_attention(jq, jk, jv, impl="pallas_interpret", **kw)
    chunked = jflash.flash_attention(jq, jk, jv, impl="chunked", **kw)
    oracle = jattn(jq.astype(jnp.float32), jk.astype(jnp.float32),
                   jv.astype(jnp.float32), **kw)
    for ref in (kernel, chunked, oracle):
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(tflash.flash_attention(tq, tk, tv, impl="ref", **kw)),
        _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 256), (32, 128),
                                    (48, 80)])
def test_flash_block_shape_invariance(blocks):
    """The chunked plain version gives the oracle's result at any chunking
    (3e-5), as the reference's kernel does at any block shape."""
    bq, bk = blocks
    rng = np.random.default_rng(4)
    q = _rand(rng, (1, 256, 6, 64))
    k, v = _rand(rng, (1, 256, 2, 64)), _rand(rng, (1, 256, 2, 64))
    out = tflash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 impl="chunked", block_q=bq, block_k=bk)
    jout = jflash.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  impl="pallas_interpret",
                                  block_q=min(bq, 128), block_k=min(bk, 128))
    ref = jattn(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=3e-5)


def test_kernel_routes_refuse_cpu_tensors_and_fixed_tiles():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention(q, q[:, :, :1], q[:, :, :1], impl="cuda")
    with pytest.raises(ValueError, match="tile"):
        tflash.flash_attention(q, q, q, impl="cuda", block_q=32)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32),
                              impl="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_kernel_route_by_dtype_and_width(dtype, d):
    """bf16 at the published configs' widths (64, 128) goes to the
    tensor-core kernel; f32 (TF32 would break its 3e-5 tolerance) and the
    other widths to the plain-FMA kernel."""
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
    assert tflash.kernel_for(dtype, d) == want
    assert tflash.kernel_for(dtype, d) == want  # a pure function


@pytest.mark.parametrize("dtype,d,exc,match", [
    (torch.float16, 64, TypeError, "float32 or bfloat16"),
    (torch.float64, 128, TypeError, "float32 or bfloat16"),
    (torch.bfloat16, 48, ValueError, "head_dim"),
    (torch.float32, 96, ValueError, "head_dim"),
    (torch.bfloat16, 512, ValueError, "head_dim")])
def test_flash_kernel_route_refuses_what_neither_kernel_takes(dtype, d, exc,
                                                              match):
    with pytest.raises(exc, match=match):
        tflash.kernel_for(dtype, d)


@pytest.mark.parametrize("d,itemsize,tile", [(128, 2, 16), (128, 4, 4),
                                             (256, 4, 4), (16, 4, 32)])
def test_decode_tile_fits_shared_memory(d, itemsize, tile):
    """Rows per warp tile: 16 on the bf16 tensor-core stream (d = 64, 128),
    four steps of 32 / (lanes per row) rows on the plain-FMA one; a block
    of any head group fits one SM's opt-in shared memory."""
    assert tdec.tile_rows(d, itemsize) == tile
    assert tile * d * itemsize <= 4 * 1024  # one warp's K tile
    for g in (1, 3, 16):
        assert tdec.smem_bytes(d, itemsize, g) <= tdec.SMEM_PER_SM - 1024
        assert tdec.blocks_per_sm(d, itemsize, g) >= 1


def _plan(b, kv, s, d=128, itemsize=2, g=3, **kw):
    return tdec.plan(b, kv, s, d=d, itemsize=itemsize, g=g, sm_count=132,
                     **kw)


def test_decode_plan_rule():
    """As many splits as keep the launch's blocks resident at once, at most
    the capacity's 16-row groups and one cluster (8); the capacity, never
    the lengths, decides; block_k fixes the rows per split instead."""
    # The serving arena, bf16 tensor-core stream: two ~104 KB blocks fit an
    # SM, 264 over 16 slots x 8 KV heads = 128 groups.
    assert tdec.blocks_per_sm(128, 2, 3) == 2
    assert _plan(16, 8, 577) == (2, 0)
    # zamba2's 16 x 32 groups already fill the card: one split.
    assert _plan(16, 32, 577, d=64, g=1) == (1, 0)
    # One sequence, one KV head: one cluster of 8.
    assert _plan(1, 1, 512, g=4) == (8, 0)
    # A short cache: no more splits than 16-row groups.
    assert _plan(2, 2, 40, d=64, itemsize=4, g=1) == (3, 0)
    assert _plan(128, 8, 4096) == (1, 0)
    assert _plan(2, 2, 300, d=64, itemsize=4, block_k=16) == (19, 16)
    with pytest.raises(ValueError):
        _plan(1, 1, 0)
    with pytest.raises(ValueError):
        _plan(1, 1, 64, block_k=0)


@pytest.mark.parametrize("args", [
    dict(b=16, kv=8, s=577), dict(b=16, kv=32, s=577, d=64, g=1),
    dict(b=1, kv=1, s=512, g=4), dict(b=3, kv=6, s=300, d=64, itemsize=4,
                                      g=1),
    dict(b=2, kv=2, s=300, block_k=16), dict(b=2, kv=2, s=96, block_k=512)])
def test_decode_splits_cover_each_length_once(args):
    """The kernel's row ranges (``split_range``, mirrored by its
    ``split_rows``): for every length 0..s the splits cover [0, length)
    exactly once, in order, with no overlap; by length every non-empty
    split has whole 16-row groups but the last, and an equal share; the
    splits past the end and every split of length 0 read nothing."""
    b, kv, s = args.pop("b"), args.pop("kv"), args.pop("s")
    p = _plan(b, kv, s, **args)
    for length in range(0, s + 1):
        ranges = [tdec.split_range(length, i, p, s) for i in range(p.splits)]
        covered = [r for lo, hi in ranges for r in range(lo, hi)]
        assert covered == list(range(length))  # once each, in order
        sizes = [hi - lo for lo, hi in ranges if hi > lo]
        if p.fixed_rows:
            assert all(n == p.fixed_rows for n in sizes[:-1])
        elif sizes:
            assert all(n % tdec.ROW_GROUP == 0 and n == sizes[0]
                       for n in sizes[:-1])
            assert sizes[-1] <= sizes[0]
            assert len(sizes) == -(-length // sizes[0])
    assert tdec.split_range(-3, 0, p, s) == (0, 0)
    assert tdec.split_range(s + 50, p.splits - 1, p, s)[1] == s


def test_decode_plan_reads_shapes_only():
    """The plan takes no lengths: one launch shape serves every length of
    a capacity, and the same shapes give the same plan."""
    import inspect

    assert "lengths" not in inspect.signature(tdec.plan).parameters
    assert _plan(16, 8, 577) == _plan(16, 8, 577)
    p = _plan(16, 8, 577)
    for length in (0, 1, 15, 16, 17, 300, 576, 577):
        hi = max(hi for _, hi in (tdec.split_range(length, i, p, 577)
                                  for i in range(p.splits)))
        assert hi == length


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_decode_kernel_route_by_dtype_and_width(dtype, d):
    """bf16 at the models' widths (64, 128) streams on the tensor cores;
    f32 (TF32 would break its 3e-5 tolerance) and the other widths on
    plain FMAs."""
    want = "mma" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
    assert tdec.kernel_for(dtype, d) == want
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tdec.kernel_for(torch.float16, d)
    with pytest.raises(ValueError, match="head_dim"):
        tdec.kernel_for(dtype, d + 8)


def test_plain_calls_record_no_launch_shape():
    """A wrapper's shape record (``.shapes``) holds launches only: a call
    on CPU tensors takes the plain version, launches nothing and adds
    nothing, whatever the wrapper."""
    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    q = torch.ones(2, 4, 16)
    kc = torch.ones(2, 8, 2, 16)
    fq = torch.ones(2, 5, 4, 16)
    wrappers = (fed_reduce, tdec.decode_attention, tflash.flash_attention)
    for f in wrappers:
        f.shapes = set()
    try:
        fed_reduce(torch.ones(3, 2), torch.ones(3))
        tdec.decode_attention(q, kc, kc, torch.tensor([3, 8],
                                                      dtype=torch.int32))
        tflash.flash_attention(fq, kc, kc, causal=True)
        assert [f.shapes for f in wrappers] == [set(), set(), set()]
    finally:
        for f in wrappers:
            f.shapes = None
