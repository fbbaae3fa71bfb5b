"""granite-4.0-h-small (the ``hybrid_moe`` family) on the CPU against the
benchmark's plain f32 reference (``bench/reference/granite_hybrid.py``,
which imports neither JAX nor the port): logits, loss and every leaf's
gradient, prefill and decode through the cache, the expert share, dropless
routing, the grouped products, the spans, the serving and training entry
points, and the published configuration against the card's cut."""
import collections
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs import granite_4_0_h_small as granite  # noqa: E402
from repro_torch.kernels.moe_experts.ops import moe_experts  # noqa: E402
from repro_torch.models import granite_hybrid, moe  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from reference import granite_hybrid as ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SMOKE = get_config("granite_4_0_h_small", smoke=True)


def _file_config(cfg) -> dict:
    """The reference's configuration (the published config.json's keys) of
    the port's ``cfg``."""
    return {
        "hidden_size": cfg.d_model, "layer_types": list(cfg.layer_types),
        "num_hidden_layers": cfg.num_layers, "vocab_size": cfg.vocab_size,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "attention_head_dim": cfg.head_dim,
        "intermediate_size": cfg.d_ff,
        "shared_intermediate_size": cfg.shared_d_ff,
        "num_routed_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.experts_per_token,
        "num_local_experts": cfg.experts_held,
        "mamba_expand": cfg.ssm_expand, "mamba_d_head": cfg.ssm_head_dim,
        "mamba_d_state": cfg.ssm_state, "mamba_n_groups": cfg.ssm_groups,
        "mamba_d_conv": cfg.ssm_conv_width,
        "mamba_chunk_size": cfg.ssm_chunk, "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "logits_scaling": cfg.logits_scaling,
    }


def _params(cfg, seed=0):
    """The port's params of ``cfg`` with nonzero conv biases (the init's
    zeros would hide them)."""
    p = get_model(cfg).init(seed, cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for lp in p["layers"]:
        if "mamba" in lp:
            for k in ("conv_x_b", "conv_BC_b"):
                b = lp["mamba"][k]
                b.copy_(torch.randn(b.shape, generator=g) * 0.1)
    return p


def _f32(tree):
    return tree_map(lambda t: t.detach().float(), tree)


def _tokens(cfg, b, s, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)


def _rel(a, b):
    a, b = a.detach(), b.detach()
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_loss_and_every_gradient_match_the_reference(dtype):
    """Two rows of 48 tokens: the port's logits, loss and each leaf's
    gradient against the f32 reference on the same (rounded) weights
    (each leaf's gradient against the larger of its own norm and the
    median leaf's); f32 within 1e-5, bf16 within 2e-2.  In bf16 the port
    routes on bf16 activations: where rounding flips a near-tied expert
    choice (here one token of 96 in a layer), that layer's router, experts
    and FFN norm move by up to ~10%, so those leaves are held to 2e-1 and
    the whole gradient to 2e-2."""
    cfg = dataclasses.replace(SMOKE, dtype=dtype)
    c = _file_config(cfg)
    p = _params(cfg)
    t = _tokens(cfg, 2, 48)
    batch = {"tokens": t[:, :-1].int(), "targets": t[:, 1:].int(),
             "mask": torch.ones(2, 48)}
    pp = [x.requires_grad_(True) for x in tree_leaves(p)]
    loss_p, _ = get_model(cfg).loss_fn(p, batch, cfg)
    loss_p.backward()
    rp = _f32(p)
    rl = [x.requires_grad_(True) for x in tree_leaves(rp)]
    loss_r = ref.loss(rp, t[:, :-1], t[:, 1:], c)
    loss_r.backward()
    tol = TOL[dtype]
    assert abs(float(loss_p.detach()) - float(loss_r.detach())) \
        <= tol * float(loss_r.detach())
    with torch.no_grad():
        lg_p = granite_hybrid.apply(p, t[:, :-1], cfg)[0][..., :c[
            "vocab_size"]]
        lg_r = ref.logits_of(rp, ref.hidden(rp, t[:, :-1], c), c)
    assert _rel(lg_p, lg_r) <= tol
    norms = [float(b.grad.norm()) for b in rl]
    med = float(np.median(norms))
    for (path, a, b) in zip(_paths(p), pp, rl):
        err = float((a.grad.double() - b.grad.double()).norm())
        routed = dtype == "bfloat16" and ("moe" in path or "ln2" in path)
        assert err <= (10 if routed else 1) * tol * max(
            float(b.grad.norm()), med), (path, err)
    whole = [torch.cat([x.grad.double().flatten() for x in t])
             for t in (pp, rl)]
    assert _rel(*whole) <= tol


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in _paths(v, pre + (k,))]
    if isinstance(tree, list):
        return [q for i, v in enumerate(tree) for q in _paths(v, pre + (i,))]
    return [pre]


def test_prefill_and_decode_through_the_cache_match_the_reference():
    """A 20-token prefill, then 4 decode steps through the cache (Mamba2
    states, the attention layer's K/V): each step's logits against the
    reference's full forward at that position (f32)."""
    cfg = dataclasses.replace(SMOKE, dtype="float32")
    c = _file_config(cfg)
    p = _params(cfg)
    api = get_model(cfg)
    t = _tokens(cfg, 2, 24)[:, :24]
    with torch.no_grad():
        want = ref.logits_at(_f32(p), t, list(range(19, 24)), c)
        lg, cache = api.prefill(p, t[:, :20], cfg, 24)
        got = [lg]
        for j in range(20, 24):
            lg, cache = api.decode_step(p, t[:, j], cfg, cache)
            got.append(lg)
    for j, g in enumerate(got):
        assert _rel(g[:, :c["vocab_size"]], want[:, j]) <= 1e-5, j
    assert [int(x["pos"]) for x, k in zip(cache, cfg.layer_types)
            if k == "attention"] == [24]


SHARES = [(0, 3), (3, 3), (6, 2)]  # (first, held) covering all 8 experts


def _share(p_moe, first, held):
    """The MoE weights of a card that holds experts ``first`` ..
    ``first + held - 1``: the router's columns permuted so that those come
    first, and their ``w1``, ``w2``."""
    n = p_moe["router"].shape[1]
    perm = torch.tensor([*range(first, n), *range(first)])
    return {"router": p_moe["router"][:, perm],
            "w1": p_moe["w1"][first:first + held],
            "w2": p_moe["w2"][first:first + held]}


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Three cards' shares that together hold all 8 experts: the sum of
    their FFN outputs, with the shared expert (computed on every card)
    counted once, is the uncut layer's, in the port and in the
    reference (f32)."""
    full = dataclasses.replace(SMOKE, dtype="float32", experts_held=8)
    p = _params(full)["layers"][0]
    x = torch.randn(2, 24, full.d_model, generator=torch.Generator()
                    .manual_seed(5))
    h = torch.randn(48, full.d_model, generator=torch.Generator()
                    .manual_seed(6))
    c = _file_config(full)
    with torch.no_grad():
        whole = granite_hybrid.ffn_apply(p, x, full)
        whole_r = ref.moe(p["moe"], h, c, ref.plain_matmul) \
            + ref.shared(p["shared"], h, c, ref.plain_matmul)
        shared = granite_hybrid.mlp_apply(
            p["shared"], granite_hybrid.rmsnorm(x, p["ln2"], full.norm_eps),
            dataclasses.replace(full, d_ff=full.shared_d_ff))
        parts, parts_r = [], []
        for first, held in SHARES:
            cfg = dataclasses.replace(full, experts_held=held)
            q = dict(p, moe=_share(p["moe"], first, held))
            parts.append(granite_hybrid.ffn_apply(q, x, cfg))
            cs = dict(c, num_local_experts=held)
            parts_r.append(ref.moe(q["moe"], h, cs, ref.plain_matmul)
                           + ref.shared(p["shared"], h, cs,
                                        ref.plain_matmul))
    n = len(SHARES) - 1
    assert _rel(sum(parts) - n * shared, whole) <= 1e-5
    assert _rel(sum(parts_r) - n * ref.shared(p["shared"], h, c,
                                              ref.plain_matmul),
                whole_r) <= 1e-5
    # and each share is the reference's share
    for (first, held), part_r in zip(SHARES, parts_r):
        cfg = dataclasses.replace(full, experts_held=held)
        with torch.no_grad():
            got = moe.dropless_apply(_share(p["moe"], first, held),
                                     h[None], cfg)[0]
        want = part_r - ref.shared(p["shared"], h, c, ref.plain_matmul)
        assert _rel(got, want) <= 1e-5


def test_a_router_that_sends_every_token_to_one_expert_drops_none():
    """Every token's largest logit is expert 1's (held): its rows are all
    the tokens, the layer's output is the reference's for every token, and
    a capacity-factor route of the same load would have dropped most."""
    cfg = dataclasses.replace(SMOKE, dtype="float32")
    p = _params(cfg)["layers"][0]["moe"]
    u = torch.ones(cfg.d_model) / cfg.d_model ** 0.5
    x = torch.randn(1, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(7)) + 5 * u
    router = p["router"].clone()
    router[:, 1] = 20 * u  # a logit near 100 for every token
    p["router"] = router
    r = moe.route_dropless(p["router"], x[0], cfg)
    offs = r.offs.tolist()
    assert offs[1] - offs[0] == 40  # all 40 tokens on expert 1
    assert bool(r.held[:, 0].all()) and bool(
        (torch.topk(x[0] @ router, 3).indices[:, 0] == 1).all())
    c = _file_config(cfg)
    with torch.no_grad():
        got = moe.dropless_apply(p, x, cfg)[0]
        want = ref.moe(p, x[0], c, ref.plain_matmul)
    assert _rel(got, want) <= 1e-5
    assert float(got.norm(dim=-1).min()) > 0
    assert moe.capacity(40, dataclasses.replace(
        cfg, capacity_factor=1.25, num_experts=8)) < 40


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_grouped_products_match_the_plain_route(dtype, tol):
    """``torch._grouped_mm`` (the card's route) against the plain route
    on the CPU: the rows of each expert, forward and backward; the rows
    past the last offset are read by neither."""
    if not hasattr(torch, "_grouped_mm"):
        pytest.skip("this torch has no grouped products")
    g = torch.Generator().manual_seed(0)
    n, d, f, rows, held = 3, 32, 16, 40, 29
    x = torch.randn(rows, d, generator=g)
    w1 = torch.randn(n, d, 2 * f, generator=g) * 0.2
    w2 = torch.randn(n, f, d, generator=g) * 0.2
    offs = torch.tensor([7, 7, held], dtype=torch.int32)
    dy = torch.randn(held, d, generator=g)
    out = {}
    for impl in ("grouped", "plain"):
        ts = [t.to(dtype).requires_grad_(True) for t in (x, w1, w2)]
        y = moe_experts(*ts, offs, impl=impl)
        y[:held].backward(dy.to(dtype))
        out[impl] = [y[:held], ts[0].grad[:held], ts[1].grad, ts[2].grad]
    for a, b in zip(out["grouped"], out["plain"]):
        assert _rel(a.float(), b.float()) <= tol
    before = moe_experts.launches
    moe_experts(x, w1, w2, offs)  # "auto" on the CPU: the plain route
    assert moe_experts.launches == before
    with pytest.raises(ValueError, match="impl"):
        moe_experts(x, w1, w2, offs, impl="cuda")


def test_a_traced_step_opens_a_moe_span_in_every_block():
    """Under a profiler each layer is a ``model.block`` span with one
    ``model.moe`` inside, in the forward and in the recomputation."""
    cfg = dataclasses.replace(SMOKE, dtype="float32")
    p = _params(cfg)
    for t in tree_leaves(p):
        t.requires_grad_(True)
    tok = _tokens(cfg, 2, 16)
    batch = {"tokens": tok[:, :-1].int(), "targets": tok[:, 1:].int(),
             "mask": torch.ones(2, 16)}
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        loss, _ = granite_hybrid.loss_fn(p, batch, cfg)
        loss.backward()
    records = tracing.records()
    tracing.reset()
    by_id = {r.id: r for r in records}
    names = collections.Counter(r.name for r in records)
    assert names == {"model.block": 2 * cfg.num_layers,
                     "model.moe": 2 * cfg.num_layers}
    assert all(by_id[r.parent].name == "model.block" for r in records
               if r.name == "model.moe")


def test_batched_server_and_training_step_run_the_family():
    """The normal entry points: ``BatchedServer`` serves a batch whose
    greedy tokens are the argmax of the model's own full forward, and
    ``make_cloud_step`` trains two steps."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distribution.steps import init_train_state
    from repro_torch.launch import serve
    from repro_torch.launch.train import make_cloud_step

    cfg = dataclasses.replace(SMOKE, dtype="float32")

    class Msg:
        def __init__(self, i, prompt):
            self.device_id = i
            self.payload = {"tokens": np.asarray(prompt, np.int32)}

    prompts = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 8))
    server = serve.BatchedServer(cfg, batch_size=2, prompt_len=8,
                                 decode_tokens=3, max_len=12, device="cpu")
    for i, pr in enumerate(prompts):
        server.queue.append((Msg(i, pr), 0.0))
    server._serve_batch(0.0)
    seqs = torch.from_numpy(prompts)
    for r in sorted(server.records, key=lambda r: r.request_id):
        row = seqs[r.request_id]
        for tok in r.tokens:
            with torch.no_grad():
                lg = granite_hybrid.apply(server.params, row[None], cfg)[0]
            assert tok == int(lg[0, -1, :cfg.vocab_size].argmax())
            row = torch.cat([row, torch.tensor([tok])])
    shape = ShapeConfig("t", 16, 4, "train", microbatches=2)
    step = make_cloud_step(cfg, shape, TokenPipeline(
        cfg.vocab_size, 16, 4, seed=0), device="cpu")
    state = init_train_state(cfg, 0, device="cpu")
    losses = [float(step(state)[1]["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses))


def test_the_sharded_steps_refuse_the_family():
    from repro_torch.distribution.steps import (
        build_prefill_step,
        build_serve_step,
    )

    shape = ShapeConfig("t", 16, 2, "prefill")
    for build in (build_prefill_step, build_serve_step):
        with pytest.raises(NotImplementedError, match="one device"):
            build(SMOKE, object(), shape)


def test_the_published_config_and_the_cut_differ_in_reduced_keys_only():
    """``CONFIG`` is ``PUBLISHED`` with the keys the benchmark's
    configuration file lists under ``reduced`` changed, to the values the
    file states; every width and the router's 72 outputs and 10 per token
    as published."""
    path = os.path.join(BENCH, "configs", "granite-4.0-h-small.json")
    c = json.loads(open(path).read())
    field = {"num_hidden_layers": "num_layers",
             "layer_types": "layer_types",
             "num_local_experts": "experts_held",
             "vocab_size": "vocab_size", "mamba_chunk_size": "ssm_chunk"}
    assert sorted(c["reduced"]) == sorted(field)
    pub, cut = granite.PUBLISHED, granite.CONFIG
    changed = {f.name for f in dataclasses.fields(pub)
               if getattr(pub, f.name) != getattr(cut, f.name)}
    assert changed == set(field.values()) | {"name"}
    for key, f in field.items():
        assert getattr(cut, f) == (tuple(c[key]) if key == "layer_types"
                                   else c[key])
        want = c["published"][key]
        if key != "layer_types":
            assert getattr(pub, f) == want
    assert [i for i, t in enumerate(pub.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert (pub.num_experts, pub.experts_per_token, pub.d_ff,
            pub.shared_d_ff, pub.d_model) == (72, 10, 768, 1536, 4096)
    assert pub.num_params() == 32_267_681_920 or abs(
        pub.num_params() / 32.2e9 - 1) < 0.01
    assert abs(cut.num_params() / 2.055e9 - 1) < 0.001
