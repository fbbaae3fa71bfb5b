"""The plain reference against the port's CPU path at smoke size, and the
SSD reference against the recurrence it computes."""
import dataclasses

import numpy as np
import pytest
import torch
from conftest import smoke_config

from harness import program, weights
from models import mamba2 as arch
from reference import mamba2 as model
from reference.adamw import AdamW


def _ssd_loop(x, dt, A, B, C):
    """S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T; y_t = S_t C_t, one step
    at a time, in f64."""
    b, l, h, p = x.shape
    rep = h // B.shape[2]
    Bh, Ch = B.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
    S = torch.zeros(b, h, p, B.shape[3], dtype=x.dtype)
    ys = []
    for t in range(l):
        a = torch.exp(dt[:, t] * A)
        S = a[..., None, None] * S + (dt[:, t, :, None] * x[:, t])[..., None] \
            * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", S, Ch[:, t]))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("l,chunk,g", [(64, 16, 1), (50, 16, 2), (37, 8, 1)])
def test_ssd_reference_is_the_recurrence(l, chunk, g):
    gen = torch.Generator().manual_seed(l)
    b, h, p, n = 2, 4, 8, 6
    x = torch.randn(b, l, h, p, generator=gen, dtype=torch.float64)
    dt = torch.rand(b, l, h, generator=gen, dtype=torch.float64) * 0.5
    A = -torch.rand(h, generator=gen, dtype=torch.float64) * 4
    B = torch.randn(b, l, g, n, generator=gen, dtype=torch.float64)
    C = torch.randn(b, l, g, n, generator=gen, dtype=torch.float64)
    got = model.ssd(x, dt, A, B, C, chunk)
    want = _ssd_loop(x, dt, A, B, C)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def _f32_port(name):
    """The port's smoke config in f32 and the benchmark's weights as both
    sides' trees (the port's in its layout and dtypes cast to f32)."""
    from repro_torch.models.registry import get_model

    c = smoke_config(name)
    cfg = dataclasses.replace(program.model_config(c, arch.FIELDS),
                              dtype="float32")
    spec = arch.leaves(c)
    ts = [t.float() for t in weights.make_all(spec, 5, "cpu")]
    return c, cfg, get_model(cfg), spec, ts


def _tokens(c, b, s, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, c["vocab_size"], (b, s + 1), generator=g)


def test_reference_logits_match_the_port():
    c, cfg, api, spec, ts = _f32_port("mamba2-1.3b")
    tok = _tokens(c, 2, 40)[:, :-1]
    port = api.apply(weights.nest(spec, ts), tok, cfg)[0][..., :c[
        "vocab_size"]]
    with torch.no_grad():
        ref = model.logits_of(weights.nest(spec, ts),
                              model.hidden(weights.nest(spec, ts), tok, c),
                              c)
    err = (port - ref).abs().max() / ref.abs().max()
    assert err < 1e-5, err


def test_reference_loss_and_gradients_match_the_port():
    c, cfg, api, spec, ts = _f32_port("mamba2-1.3b")
    t = _tokens(c, 2, 48)
    batch = {"tokens": t[:, :-1].int(), "targets": t[:, 1:].int(),
             "mask": torch.ones(2, 48)}
    pp = [x.clone().requires_grad_(True) for x in ts]
    loss_p, _ = api.loss_fn(weights.nest(spec, pp), batch, cfg)
    loss_p.backward()
    rp = [x.clone().requires_grad_(True) for x in ts]
    loss_r = model.loss(weights.nest(spec, rp), t[:, :-1], t[:, 1:], c)
    loss_r.backward()
    lp, lr = float(loss_p.detach()), float(loss_r.detach())
    assert abs(lp - lr) < 1e-5 * lr
    for leaf, a, b in zip(spec, pp, rp):
        ga, gb = a.grad, b.grad
        assert (ga - gb).norm() <= 1e-4 * gb.norm() + 1e-12, leaf.path


def test_reference_readings_are_the_parents():
    """The moved reference gives, on the same weights and tokens, the
    numbers the reference gave before architectures became modules
    (frozen from that harness at smoke size)."""
    c = smoke_config("mamba2-1.3b")
    spec = arch.leaves(c)
    params = weights.nest(spec, [t.float() for t in
                                 weights.make_all(spec, 5, "cpu")])
    t = _tokens(c, 2, 48)
    with torch.no_grad():
        loss = model.loss(params, t[:, :-1], t[:, 1:], c, remat=False)
        lg = model.logits_at(params, t[:, :-1], [0, 17, 47], c)
    assert float(loss) == pytest.approx(6.2441558837890625, rel=1e-6)
    assert float(lg.double().sum()) == pytest.approx(3.449030186615346,
                                                     rel=1e-5)
    assert float(lg.abs().double().sum()) == pytest.approx(
        377.1597518058388, rel=1e-6)
    assert float(lg[0, 1, 7]) == pytest.approx(0.060059335082769394,
                                               rel=1e-5)


def test_reference_adamw_matches_the_port():
    from repro_torch.optim.optimizers import (AdamWConfig, adamw_init,
                                              adamw_update)

    hp = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=1.0, warmup_steps=2, total_steps=10,
              min_lr_ratio=0.1)
    g = torch.Generator().manual_seed(0)
    params = [torch.randn(17, 5, generator=g), torch.randn(9, generator=g)]
    port_p = [p.clone() for p in params]
    opt = adamw_init(port_p)
    ref_p = [p.clone() for p in params]
    ref = AdamW(ref_p, hp)
    for step in range(4):
        grads = [torch.randn(p.shape, generator=g) * (3 if step else 0.1)
                 for p in params]
        adamw_update(AdamWConfig(**hp), [x.clone() for x in grads], opt,
                     port_p)
        ref.update([x.clone() for x in grads])
        for a, b, m, mr in zip(opt["master"], ref_p, opt["m"], ref.m):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-9)
            assert torch.allclose(m, mr, rtol=1e-6, atol=1e-12)


def test_fp8_control_rounds_to_e4m3_and_passes_gradients():
    from reference.lowp import fp8

    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = fp8(x)
    assert 0 < (y - x).abs().max() < 0.2
    assert len(np.unique(y.detach().numpy())) < 101
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
