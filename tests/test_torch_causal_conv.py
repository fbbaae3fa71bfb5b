"""Mamba2's depthwise causal conv + bias + SiLU (``kernels/causal_conv``).

On the CPU: the plain chain against the JAX package's ``_causal_conv`` and
its gradient against an f32 ``F.conv1d`` + SiLU reference, the routes, the
wrapper's refusals, the launch plan, the vmap rule's folding and the work
formulas.  Marked ``cuda`` (skipped without a card): the kernel and its
backward against the plain chain on the card at the models' shapes, bitwise
repeatable, through ``vmap(grad)``, and the launch counters of a model's
training step and prefill.  JAX is imported inside the CPU tests only, so
the file runs on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_causal_conv.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels._vmap import fold, unfold  # noqa: E402
from repro_torch.kernels.causal_conv import ops  # noqa: E402
from repro_torch.kernels.causal_conv.ops import (  # noqa: E402
    causal_conv,
    causal_conv_ref,
    plan,
)
from repro_torch.roofline import op_analysis  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _inputs(seed, b, l, c, width=4, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    w = (rng.standard_normal((width, c)) * 0.5 / width).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype)
                 for a in (x, w, bias))


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _conv1d_silu(x, w, b):
    """The benchmark reference's form (``bench/reference/mamba2.py``):
    ``F.conv1d`` over the left-padded sequence, then SiLU, in f32."""
    width = w.shape[0]
    out = F.conv1d(F.pad(x.transpose(1, 2), (width - 1, 0)),
                   w.t().unsqueeze(1), b, groups=x.shape[-1])
    return F.silu(out.transpose(1, 2))


# --------------------------------------------------------------------------- #
# CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,width", [
    ((2, 37, 3), 4), ((1, 64, 128), 4), ((3, 5, 16), 2), ((2, 9, 24), 3)])
def test_plain_chain_matches_the_jax_package(dtype, shape, width):
    import jax.numpy as jnp

    from repro.models import mamba2 as jmamba2

    x, w, b = _inputs(sum(shape) + width, *shape, width=width, dtype=dtype)
    got = causal_conv_ref(x, w, b)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def j(a):
        return jnp.asarray(a.float().numpy(), jdt)

    want = jmamba2._causal_conv(j(x), j(w), j(b))
    assert got.dtype == dtype and got.shape == x.shape
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert _rel(got.float(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,width", [((2, 37, 3), 4), ((1, 200, 64), 4),
                                         ((2, 16, 8), 2)])
def test_plain_chain_gradient_matches_conv1d_reference(dtype, shape, width):
    x, w, b = _inputs(3 * sum(shape), *shape, width=width, dtype=dtype)
    dy = _inputs(5, *shape, dtype=dtype)[0]
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    causal_conv_ref(*leaves).backward(dy)
    got = [t.grad for t in leaves]
    ref = [t.float().clone().requires_grad_(True) for t in (x, w, b)]
    _conv1d_silu(*ref).backward(dy.float())
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        assert _rel(g.float(), r.grad) <= TOL[dtype]


def test_kernel_route_refuses_what_it_does_not_take():
    x, w, b = _inputs(0, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        causal_conv(x, w, b, impl="cuda")
    x5, w5, b5 = _inputs(0, 2, 8, 16, width=5)
    with pytest.raises(ValueError, match="width"):
        causal_conv(x5, w5, b5, impl="cuda")
    xh, wh, bh = (t.half() for t in (x, w, b))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        causal_conv(xh, wh, bh, impl="cuda")
    with pytest.raises(TypeError, match="as torch.float32"):
        causal_conv(x, w.bfloat16(), b, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        causal_conv(x, w, b, impl="pallas")
    with pytest.raises(ValueError, match="do not fit"):
        causal_conv(x, w[:, :8], b)


@pytest.mark.parametrize("impl,function", [("auto", True),
                                           ("chunked", False),
                                           ("ref", False)])
def test_routes(monkeypatch, impl, function):
    """On a CPU tensor "auto" goes through ``CausalConv`` (whose CPU route
    is the plain chain); "chunked" and "ref" run the chain's ops."""
    calls = []
    real = ops.CausalConv.apply

    def apply(*a):
        calls.append(a)
        return real(*a)
    monkeypatch.setattr(ops.CausalConv, "apply", apply)
    x, w, b = _inputs(1, 2, 11, 8)
    y = causal_conv(x, w, b, impl=impl)
    assert bool(calls) == function
    assert torch.equal(y, causal_conv_ref(x, w, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_is_the_chain_forward_and_backward(dtype):
    """``CausalConv`` on the CPU gives the plain chain's output and, from
    its backward, the gradients autograd takes through the chain, bit for
    bit."""
    x, w, b = _inputs(6, 2, 29, 12, dtype=dtype)
    dy = _inputs(7, 2, 29, 12, dtype=dtype)[0]
    got, want = [], []
    for fn, out in ((causal_conv, got), (causal_conv_ref, want)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*leaves)
        y.backward(dy)
        out += [y.detach()] + [t.grad for t in leaves]
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_vmap_grad_on_the_cpu_route_is_the_per_sample_loop():
    n = 3
    x, w, b = _inputs(8, 2, 21, 6)
    xs = torch.stack([x * (i + 1) for i in range(n)])
    ws = torch.stack([w + 0.01 * i for i in range(n)])

    def loss(xi, wi):
        return causal_conv(xi, wi, b).square().sum()
    gx, gw = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(xs, ws)
    for i in range(n):
        xi, wi = xs[i].clone().requires_grad_(True), ws[i].clone()
        wi.requires_grad_(True)
        loss(xi, wi).backward()
        assert _rel(gx[i], xi.grad) <= 1e-6 and _rel(gw[i], wi.grad) <= 1e-6


def test_meta_route_gives_shapes_and_checks_as_the_card():
    """On the meta device "auto" gives y and the gradients as empty tensors
    of the right shapes, after the kernel's own checks."""
    x, w, b = (t.to("meta").bfloat16() for t in _inputs(0, 2, 16, 8))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = causal_conv(*leaves)
    assert y.device.type == "meta" and y.shape == x.shape
    assert y.dtype == torch.bfloat16
    y.backward(torch.empty_like(y))
    for t in leaves:
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
    before = (causal_conv.launches, causal_conv.bwd_launches)
    with pytest.raises(ValueError, match="width"):
        causal_conv(*(t.to("meta") for t in _inputs(0, 2, 8, 16, width=5)))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        causal_conv(*(t.to("meta").half() for t in _inputs(0, 2, 8, 16)))
    assert (causal_conv.launches, causal_conv.bwd_launches) == before


def _conv_step(x, w, b, dy):
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    causal_conv(*leaves).backward(dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_analysis_records_the_kernels_work_on_every_device(dtype):
    """Under the analyzer a call and its backward count as one call each of
    the kernel's work, with no op of the chain, on the CPU and on the meta
    device alike (the card records the same formulas)."""
    shape = (2, 24, 16)
    got = {}
    for device in ("cpu", "meta"):
        x, w, b = (t.to(device) for t in _inputs(9, *shape, dtype=dtype))
        dy = _inputs(10, *shape, dtype=dtype)[0].to(device)
        got[device] = op_analysis.analyze(_conv_step, x, w, b, dy)[1]
    assert got["cpu"] == got["meta"]
    dims = (*shape, 4, torch.tensor([], dtype=dtype).element_size())
    fwd = op_analysis.causal_conv_work(*dims)
    bwd = op_analysis.causal_conv_bwd_work(*dims)
    kernels = got["meta"]["kernels"]
    assert {k: v["calls"] for k, v in kernels.items()} == {
        "causal_conv": 1, "causal_conv_bwd": 1}
    assert (kernels["causal_conv"]["flops"],
            kernels["causal_conv_bwd"]["flops"]) == (fwd.flops, bwd.flops)


@pytest.mark.parametrize("attention_impl,kernel", [("auto", True),
                                                   ("einsum", False),
                                                   ("ref", False)])
def test_model_routes_the_conv_with_its_scan(monkeypatch, attention_impl,
                                            kernel):
    """A block's conv takes the route its scan takes: the kernel's for a
    model on the kernels (here a CPU tensor on the "auto" route, which then
    runs the plain chain), the plain chain where ``attention_impl`` asks for
    the plain ops."""
    from repro_torch.models import mamba2

    seen = []
    real = ops.causal_conv

    def spy(x, w, b, *, impl="auto"):
        seen.append(impl)
        return real(x, w, b, impl=impl)
    monkeypatch.setattr(mamba2, "causal_conv", spy)
    cfg = dataclasses.replace(get_config("mamba2_1_3b", smoke=True),
                              dtype="float32", attention_impl=attention_impl)
    params = mamba2.init(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(0))
    mamba2.apply(params, tokens, cfg)
    assert seen == ["auto" if kernel else "chunked"] * (2 * cfg.num_layers)


@pytest.mark.parametrize("b,l,c,itemsize,backward,want", [
    # mamba2-1.3b: x at 4096 channels and B,C at 256, training and prefill
    (1, 4096, 4096, 2, False, (4, 8, 32, 8, 64, 32)),
    (1, 4096, 256, 2, False, (4, 4, 32, 8, 128, 2)),
    (8, 4096, 4096, 2, False, (4, 8, 32, 8, 512, 32)),
    (1, 4096, 4096, 2, True, (4, 16, 16, 16, 16, 64)),
    (1, 4096, 256, 2, True, (4, 4, 16, 16, 64, 4)),
    # zamba2's B,C (state 64), a tensor-parallel rank's share, f32
    (1, 4096, 128, 2, True, (4, 4, 16, 16, 64, 2)),
    (1, 4096, 2048, 2, False, (4, 8, 32, 8, 64, 16)),
    (1, 1000, 64, 4, True, (2, 4, 16, 16, 16, 2)),
    # smoke widths: 3 channels, ragged lengths
    (2, 37, 3, 2, False, (1, 4, 4, 64, 1, 1)),
    (2, 37, 3, 4, True, (1, 4, 4, 64, 1, 1))])
def test_plan_fills_the_card_from_the_shapes(b, l, c, itemsize, backward,
                                            want):
    p = plan(b, l, c, itemsize, True, backward=backward, sm_count=132)
    assert tuple(p) == want
    assert p.tx * p.ty == 256
    runs = b * -(-l // p.rows)
    assert p.blocks == -(-runs // p.ty)
    assert p.tiles * p.tx * p.vec >= c
    assert p.rows == 4 or p.blocks * p.tiles >= 3 * 132


def test_plan_takes_one_channel_a_thread_where_vectors_do_not_fit():
    assert plan(1, 64, 4096, 2, False, backward=False, sm_count=132).vec == 1
    assert plan(1, 64, 4098, 2, True, backward=True, sm_count=132).vec == 1
    assert plan(1, 64, 4100, 4, True, backward=True, sm_count=132).vec == 2


@pytest.mark.parametrize("x_dim,w_dim", [(0, 0), (1, None), (None, 1)])
def test_vmap_fold_is_the_per_sample_conv(x_dim, w_dim):
    """The vmap rule's layout: the vmapped dimension folded into the
    channels, one conv over them, unfolded — equal to each sample's own
    (within the CPU's vector and scalar tails' rounding of SiLU)."""
    n = 3
    x, w, b = _inputs(4, 2, 9, 5)
    xs = torch.stack([x + i for i in range(n)])
    ws = torch.stack([w * (i + 1) for i in range(n)])
    xv = xs if x_dim is None else xs.movedim(0, x_dim)
    wv = ws if w_dim is None else ws.movedim(0, w_dim)
    y = unfold(causal_conv_ref(
        fold(x if x_dim is None else xv, x_dim, n, 2),
        fold(w if w_dim is None else wv, w_dim, n, 1),
        fold(b, None, n, 0)), n, 2)
    for i in range(n):
        want = causal_conv_ref(x if x_dim is None else xs[i],
                               w if w_dim is None else ws[i], b)
        assert _rel(y[:, :, i], want) <= 1e-6


def test_work_formulas():
    fwd = op_analysis.causal_conv_work(1, 4096, 4096, 4, 2)
    assert fwd == (2 * 4 * 4096 * 4096, (2 * 4096 * 4096 + 5 * 4096) * 2)
    bwd = op_analysis.causal_conv_bwd_work(1, 4096, 256, 4, 4)
    assert bwd == (4 * 4 * 4096 * 256, (3 * 4096 * 256 + 10 * 256) * 4)


# --------------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_case(dev, shape, width, dtype):
    x, w, b = _inputs(sum(shape) + width, *shape, width=width, dtype=dtype,
                      device=dev)
    dy = _inputs(11, *shape, dtype=dtype, device=dev)[0]
    return x, w, b, dy


def _both(x, w, b, dy):
    """(y, dx, dw, db) of the kernel and of the plain chain, on the card."""
    out = []
    for fn in (lambda *a: causal_conv(*a, impl="cuda"), causal_conv_ref):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*leaves)
        y.backward(dy)
        out.append([y.detach()] + [t.grad for t in leaves])
    return out


CARD_CASES = [((1, 4096, 4096), 4, torch.bfloat16),  # mamba2-1.3b x, train
              ((1, 4096, 256), 4, torch.bfloat16),  # its B,C
              ((8, 4096, 4096), 4, torch.bfloat16),  # x in a prefill batch
              ((1, 4096, 128), 4, torch.bfloat16),  # zamba2's B,C
              ((1, 4096, 2048), 4, torch.bfloat16),  # a tp rank's x share
              ((2, 37, 3), 4, torch.bfloat16),  # smoke width, ragged
              ((3, 301, 40), 3, torch.bfloat16),  # narrower conv, ragged
              ((1, 1000, 64), 4, torch.float32),
              ((2, 515, 4096), 2, torch.float32),
              ((2, 37, 3), 4, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,width,dtype", CARD_CASES)
def test_kernel_matches_plain_chain_on_card(cuda_device, shape, width,
                                            dtype):
    x, w, b, dy = _card_case(cuda_device, shape, width, dtype)
    before = (causal_conv.launches, causal_conv.bwd_launches)
    got, want = _both(x, w, b, dy)
    assert (causal_conv.launches, causal_conv.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    for name, g, r in zip(("y", "dx", "dw", "db"), got, want):
        assert g.dtype == r.dtype == dtype and g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= tol, (name, _rel(g, r))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,width,dtype", [CARD_CASES[0], CARD_CASES[1],
                                               CARD_CASES[5], CARD_CASES[7]])
def test_kernel_is_bitwise_repeatable(cuda_device, shape, width, dtype):
    x, w, b, dy = _card_case(cuda_device, shape, width, dtype)
    first, _ = _both(x, w, b, dy)
    second, _ = _both(x, w, b, dy)
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_vmap_grad_through_the_kernel_is_the_per_sample_loop(cuda_device):
    n = 3
    x, w, b, _ = _card_case(cuda_device, (2, 70, 24), 4, torch.float32)
    xs = torch.stack([x * (i + 1) for i in range(n)])
    ws = torch.stack([w + 0.01 * i for i in range(n)])

    def loss(xi, wi):
        return causal_conv(xi, wi, b, impl="cuda").square().sum()
    gx, gw = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(xs, ws)
    for i in range(n):
        xi, wi = xs[i].clone().requires_grad_(True), ws[i].clone()
        wi.requires_grad_(True)
        loss(xi, wi).backward()
        assert _rel(gx[i], xi.grad) <= 1e-6 and _rel(gw[i], wi.grad) <= 1e-6


@pytest.mark.cuda
def test_model_step_and_prefill_launch_counts(cuda_device):
    """A remat training step of mamba2 runs each conv's forward twice per
    layer (the forward and the recomputation) and its backward once; a
    prefill runs each conv once per layer."""
    from repro_torch.models import mamba2

    cfg = get_config("mamba2_1_3b", smoke=True)
    params = mamba2.init(0, cfg, device=cuda_device)
    for leaf in (t for lp in params["layers"] for t in lp.values()):
        leaf.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda_device)
    batch = {"tokens": tokens, "targets": tokens,
             "mask": torch.ones_like(tokens, dtype=torch.float32)}
    before = (causal_conv.launches, causal_conv.bwd_launches)
    loss, _ = mamba2.loss_fn(params, batch, cfg, remat=True)
    loss.backward()
    layers = cfg.num_layers
    assert (causal_conv.launches - before[0],
            causal_conv.bwd_launches - before[1]) == (2 * 2 * layers,
                                                      2 * layers)
    before = causal_conv.launches
    with torch.no_grad():
        mamba2.prefill(params, tokens, cfg)
    assert causal_conv.launches - before == 2 * layers


@pytest.mark.cuda
def test_card_and_meta_analyses_of_a_mamba2_step_agree(cuda_device):
    """A mamba2 train step's analysis on the card (the scan and conv
    kernels) equals the dry run's on the meta device (their shapes-only
    routes): flops, bytes, kernel work and memory."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution.steps import (
        build_train_step,
        init_train_state,
        train_batch_specs,
    )

    cfg = get_config("mamba2_1_3b", smoke=True)
    shape = ShapeConfig("t", seq_len=64, global_batch=2, kind="train",
                        microbatches=2)
    got = {}
    for device in ("meta", cuda_device):
        step, _, _ = build_train_step(cfg, None, shape)
        state = init_train_state(cfg, device=device)
        batch = {k: (torch.randint(0, cfg.vocab_size, sh, dtype=dt,
                                   device=device)
                     if dt == torch.int32 else torch.ones(sh, dtype=dt,
                                                          device=device))
                 for k, (sh, dt) in train_batch_specs(cfg, shape).items()}
        an = op_analysis.analyze(step, state, batch)[1]
        got[str(device)] = {k: an[k] for k in (
            "flops", "bytes", "kernels", "temp_bytes", "output_bytes")}
    assert got["meta"] == got["cuda"]
    assert got["cuda"]["kernels"]["causal_conv"]["calls"] == \
        2 * 2 * 2 * cfg.num_layers
