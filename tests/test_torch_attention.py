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
from repro.kernels.flash_attention.ref import attention_chunked as jchunked  # noqa: E402
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
    (o, m, l) equals the reference's (3e-5); a split with no valid row is
    (0, NEG_INF, 0) exactly (the reference's is NEG_INF with the uniform
    weights of an all-masked softmax, which the combine weighs by 0)."""
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
    parts, empties = [], 0
    for i in range(nsh):
        sl = slice(i * ssh, (i + 1) * ssh)
        shard_len = np.clip(lens - i * ssh, 0, ssh).astype(np.int32)
        t = tdec.decode_attention_partial(
            torch.from_numpy(q), torch.from_numpy(kc[:, sl]),
            torch.from_numpy(vc[:, sl]), torch.from_numpy(shard_len))
        j = jdec.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(kc[:, sl]), jnp.asarray(vc[:, sl]),
            jnp.asarray(shard_len))
        full_rows = shard_len > 0
        empties += int((~full_rows).sum())
        for a, r in zip(t, j):
            np.testing.assert_allclose(_np(a)[full_rows], _np(r)[full_rows],
                                       atol=3e-5, rtol=3e-5)
        o, m, l = t
        assert torch.equal(o[~torch.from_numpy(full_rows)],
                           torch.zeros_like(o[~torch.from_numpy(full_rows)]))
        assert bool((m[~torch.from_numpy(full_rows)]
                     == tdec._ref.NEG_INF).all())
        assert bool((l[~torch.from_numpy(full_rows)] == 0).all())
        np.testing.assert_array_equal(_np(m)[~full_rows],
                                      _np(j[1])[~full_rows])
        parts.append(t)
    assert empties > 0  # the case holds empty splits
    out = tdec.combine_partials(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=3e-5)
    jout = jdec.combine_partials(
        *(jnp.asarray(torch.stack(x).numpy()) for x in zip(*parts)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=3e-5)


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_partial_on_rank_blocks_matches_reference(blocks, dt):
    """K2p's wrapper (``decode_attention_partial``, its plain version on
    the CPU) on each rank's block of a sequence-split cache, at a GQA group
    of 3 (llama3.2-3b's): every block with rows matches the reference's
    ``decode_attention_partial`` within the dtype's tolerance, empty blocks
    (one sequence shorter than a block, one of length 0) are (0, NEG_INF,
    0) exactly, and the ranks' states combined (``combine_partials``, as
    the sharded decode combines them) equal the reference's combine and
    the whole-cache decode."""
    b, s, h, kv, d = 4, 96, 6, 2, 32
    rng = np.random.default_rng(blocks)
    q, kc, vc = (_rand(rng, (b, h, d)), _rand(rng, (b, s, kv, d)),
                 _rand(rng, (b, s, kv, d)))
    lens = np.array([s, 13, s // blocks + 5, 0], np.int32)
    tol = DTYPES[dt][2]
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(kc, dt), _pair(vc, dt)
    size = s // blocks
    parts, jparts = [], []
    for r in range(blocks):
        sl = slice(r * size, (r + 1) * size)
        n = np.clip(lens - r * size, 0, size).astype(np.int32)
        got = tdec.decode_attention_partial(
            tq, tk[:, sl].contiguous(), tv[:, sl].contiguous(),
            torch.from_numpy(n))
        assert [t.dtype for t in got] == [torch.float32] * 3
        assert [tuple(t.shape) for t in got] == [(b, h, d), (b, h), (b, h)]
        want = jdec.decode_attention_partial(jq, jk[:, sl], jv[:, sl],
                                             jnp.asarray(n))
        rows = n > 0
        for a, w in zip(got, want):
            np.testing.assert_allclose(_np(a)[rows], _np(w)[rows], atol=tol,
                                       rtol=tol)
        o, m, l = (t[torch.from_numpy(~rows)] for t in got)
        assert not bool(o.any()) and not bool(l.any())
        assert bool((m == tdec._ref.NEG_INF).all())
        parts.append(got)
        jparts.append(want)
    assert sum(int((np.clip(lens - r * size, 0, size) == 0).sum())
               for r in range(blocks)) >= blocks  # empty blocks were held
    out = tdec.combine_partials(*(torch.stack(x) for x in zip(*parts)),
                                out_dtype=tq.dtype)
    jout = jdec.combine_partials(*(jnp.stack(x) for x in zip(*jparts)),
                                 out_dtype=jq.dtype)
    whole = tdec.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    full = lens > 0  # the reference's all-masked row is no attention
    np.testing.assert_allclose(_np(out)[full], _np(jout)[full], atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(_np(out), _np(whole), atol=tol, rtol=tol)


def test_decode_partial_meta_route_gives_f32_state_shapes():
    q = torch.empty((2, 6, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 40, 2, 64), dtype=torch.bfloat16, device="meta")
    lens = torch.full((2,), 7, dtype=torch.int32, device="meta")
    o, m, l = tdec.decode_attention_partial(q, k, k, lens)
    assert (o.shape, m.shape, l.shape) == ((2, 6, 64), (2, 6), (2, 6))
    assert {o.dtype, m.dtype, l.dtype} == {torch.float32}
    assert o.device.type == "meta"


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


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the backward's tests: the suite runs several
    workers on few cores, and gradcheck's many small ops slow down
    many-fold when every worker's thread pool spins on all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (b, sq, sk, h, kv, d, causal, q_offset) for the backward: g in {1, 2, 3,
# 4}, causal and not, a query offset, sq != sk, ragged key tails.
BWD_CASES = [
    (2, 40, 40, 6, 2, 16, True, 0),
    (1, 64, 200, 4, 4, 32, False, 0),
    (2, 48, 100, 4, 2, 16, True, 52),
    (1, 70, 70, 6, 2, 16, False, 0),
    (1, 33, 65, 4, 1, 16, True, 32),
]


def _bwd_case(case, dt, seed):
    b, sq, sk, h, kv, d, causal, off = case
    rng = np.random.default_rng(seed)
    arrays = (_rand(rng, (b, sq, h, d)), _rand(rng, (b, sk, kv, d)),
              _rand(rng, (b, sk, kv, d)), _rand(rng, (b, sq, h, d)))
    return [_pair(x, dt) for x in arrays]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attention_bwd_ref_matches_jax_grad_of_chunked(case, dt):
    """``attention_bwd_ref`` (P from the saved log-sum-exp, D = rowsum(dO *
    O), dK and dV summed over each group) against ``jax.vjp`` of the
    reference's ``attention_chunked`` on the same inputs."""
    b, sq, sk, h, kv, d, causal, off = case
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _bwd_case(case, dt, sq + sk)
    kw = dict(causal=causal, q_offset=off)
    _, vjp = jax.vjp(lambda q, k, v: jchunked(q, k, v, kv_chunk=32, **kw),
                     jq, jk, jv)
    want = vjp(jdo)
    o, lse = tflash.attention_fwd_lse(tq, tk, tv, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    got = tflash.attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    tol = DTYPES[dt][2]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype and tuple(a.shape) == w.shape, name
        np.testing.assert_allclose(_np(a), _np(w), atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("case", BWD_CASES[:3])
def test_attention_fwd_lse_matches_reference(case):
    b, sq, sk, h, kv, d, causal, off = case
    (jq, tq), (jk, tk), (jv, tv), _ = _bwd_case(case, "f32", 3)
    o, lse = tflash.attention_fwd_lse(tq, tk, tv, causal=causal, q_offset=off)
    s = jnp.einsum("bqkgd,bskd->bkgqs",
                   jq.reshape(b, sq, kv, h // kv, d) * d ** -0.5, jk)
    if causal:
        mask = (off + jnp.arange(sq))[:, None] >= jnp.arange(sk)[None, :]
        s = jnp.where(mask, s, -jnp.inf)
    want = jax.nn.logsumexp(s, axis=-1).reshape(b, h, sq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=3e-5,
                               rtol=3e-5)
    np.testing.assert_allclose(
        o.numpy(), np.asarray(jattn(jq, jk, jv, causal=causal, q_offset=off)),
        atol=3e-5, rtol=3e-5)


@pytest.mark.usefixtures("one_torch_thread")
def test_plain_autograd_through_chunked_equals_the_written_backward():
    """The CPU training path differentiates the chunked plain version by
    autograd (as JAX does); it agrees with ``attention_bwd_ref`` (3e-5)."""
    case = BWD_CASES[2]
    b, sq, sk, h, kv, d, causal, off = case
    _, (_, tk), (_, tv), (_, tdo) = _bwd_case(case, "f32", 9)
    (_, tq), = [_pair(_rand(np.random.default_rng(8), (b, sq, h, d)), "f32")]
    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = tflash.attention_chunked(q, k, v, causal=causal, q_offset=off,
                                   kv_chunk=32)
    out.backward(tdo)
    o, lse = tflash.attention_fwd_lse(tq, tk, tv, causal=causal, q_offset=off)
    want = tflash.attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                                    q_offset=off)
    for a, w in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=3e-5, rtol=3e-5)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("causal,off", [(True, 0), (True, 3), (False, 0)])
def test_flash_attention_function_passes_gradcheck(causal, off):
    """``FlashAttention`` on CPU tensors (the plain forward and
    ``attention_bwd_ref``) in f64 at a tiny GQA shape (g = 2, sq != sk)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 5, 4, 8, generator=gen, dtype=torch.float64)
    k = torch.randn(2, 7, 2, 8, generator=gen, dtype=torch.float64)
    v = torch.randn(2, 7, 2, 8, generator=gen, dtype=torch.float64)
    inputs = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: tflash.FlashAttention.apply(q, k, v, causal, off,
                                                    8 ** -0.5)[0], inputs)


@pytest.mark.usefixtures("one_torch_thread")
def test_flash_attention_function_vmap_grad_equals_a_loop():
    from torch.func import grad, vmap

    gen = torch.Generator().manual_seed(1)
    q = torch.randn(3, 2, 6, 6, 16, generator=gen)
    k = torch.randn(3, 2, 9, 2, 16, generator=gen)
    v = torch.randn(3, 2, 9, 2, 16, generator=gen)

    def loss(q, k, v):
        o, _ = tflash.FlashAttention.apply(q, k, v, True, 3, 0.25)
        return (o * o).sum()

    g = grad(loss, argnums=(0, 1, 2))
    batched = vmap(g)(q, k, v)
    shared = vmap(g, in_dims=(0, None, None))(q, k[0], v[0])
    for i in range(3):
        for a, w in zip(batched, g(q[i], k[i], v[i])):
            torch.testing.assert_close(a[i], w, atol=1e-6, rtol=1e-6)
        for a, w in zip(shared, g(q[i], k[0], v[0])):
            torch.testing.assert_close(a[i], w, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_bwd_route_by_dtype_and_width(dtype, d):
    """bf16 at the published widths (64, 128) runs on wgmma; f32 (TF32
    would break its 3e-5) and the other widths on plain FMAs."""
    want = "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "simt"
    assert tflash.kernel_for_bwd(dtype, d) == want
    assert tflash.kernel_for_bwd(dtype, d) == want  # a pure function


@pytest.mark.parametrize("dtype,d,exc,match", [
    (torch.float16, 64, TypeError, "float32 or bfloat16"),
    (torch.float64, 16, TypeError, "float32 or bfloat16"),
    (torch.bfloat16, 256, ValueError, "head_dim"),
    (torch.float32, 48, ValueError, "head_dim")])
def test_flash_bwd_route_refuses_what_it_does_not_take(dtype, d, exc, match):
    with pytest.raises(exc, match=match):
        tflash.kernel_for_bwd(dtype, d)


def test_flash_bwd_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tflash._flash_attention_bwd_cuda(q, q, q, q, lse, q, True, 0, 0.25)


@pytest.mark.parametrize("sq,rows", [(1, 64), (63, 64), (64, 64), (65, 128),
                                     (4000, 4032), (4096, 4096)])
def test_flash_bwd_scratch_rows_pad_to_the_kernels_tile(sq, rows):
    """The Hopper backward's scratch (lse, D, dQ's f32 sum, turn counters)
    holds ``bwd_rows(sq)`` rows: sq rounded up to ``BWD_ROWS``, the row
    tile the CUDA side (``wg_bwd::ROWS``) reads in whole runs and checks
    the padded length against."""
    import pathlib
    import re

    assert tflash.bwd_rows(sq) == rows
    assert rows % tflash.BWD_ROWS == 0 and 0 <= rows - sq < tflash.BWD_ROWS
    src = (pathlib.Path(tflash.__file__).resolve().parents[2] / "csrc"
           / "flash_attention.cu").read_text()
    ns = src[src.index("namespace wg_bwd {"):]
    tile = int(re.search(r"constexpr int ROWS = (\d+);", ns).group(1))
    assert tile == tflash.BWD_ROWS
