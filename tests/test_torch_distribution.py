"""The port's distribution modules against the reference's.

* Rule parity: for every LM config, train and serve, and every plan that
  ``choose_mesh_plan`` gives at model axes 1-16, ``param_shardings`` of the
  port's unstacked per-layer tree equals the reference's spec of the matching
  stacked leaf minus its layer dims; likewise ``activation_rules``,
  ``batch_shardings`` and ``cache_shardings`` role by role.
* Worlds of gloo CPU ranks, each in a subprocess (a ``FileStore`` in
  ``tmp_path`` for the rendezvous): 8 ranks run the sharded train steps
  (dense and MoE on a (2, 4) mesh, and a tp = 2, sp = 2 plan) and the
  sharded decode, held against the port's unsharded run and against the
  reference's run of the same plan (8 fake host devices) at the reference's
  tolerances in bf16 and within 1e-5 in f32; 4 ranks run the fleet-sharded
  ``fed_reduce``, the tiers over 2 fleet shards and the mesh errors; 1 rank
  runs the one-shard paths and the CLI.  The initial states reach the port
  through its checkpointer, restored straight into the sharded placements
  (``restore(shardings=)``); one of them was written by the reference's
  checkpointer.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

TINY = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
            head_dim=16, vocab_size=512)
CFGS = {
    "dense": dict(name="tiny", family="dense", d_ff=128, **TINY),
    "moe": dict(name="tinymoe", family="moe", d_ff=64, num_experts=4,
                experts_per_token=2, **TINY),
}
# (config, dtype, plan or None for choose_mesh_plan on the (2, 4) mesh)
TRAIN_CASES = {
    f"{fam}_{tag}_{dt}": (fam, dtype, plan)
    for fam, tag, plan in (("dense", "2x4", None), ("moe", "2x4", None),
                           ("dense", "sp2", {"tp": 2, "sp": 2}))
    for dt, dtype in (("bf16", "bfloat16"), ("f32", "float32"))}
DECODE_CASES = {
    f"decode_{tag}_{dt}": ("dense", dtype, plan)
    for tag, plan in (("2x4", None), ("sp2", {"tp": 2, "sp": 2}))
    for dt, dtype in (("bf16", "bfloat16"), ("f32", "float32"))}
TOL_TRAIN, TOL_DECODE, TOL_F32 = 5e-2, 2e-1, 1e-5


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    return env


# --------------------------------------------------------------------------- #
# Rule parity
# --------------------------------------------------------------------------- #
def _plans():
    from repro.configs.base import choose_mesh_plan as ref_choose
    from repro.configs.registry import get_config, lm_arch_ids

    out = []
    for arch in lm_arch_ids():
        cfg = get_config(arch)
        seen = []
        for axis in (1, 2, 4, 8, 16):
            plan = ref_choose(cfg, model_axis=axis)
            if plan not in seen:
                seen.append(plan)
        out.append((arch, seen))
    return out


def _port_cfg(arch):
    from repro_torch.configs.registry import get_config

    return get_config(arch)


def _port_plan(plan):
    from repro_torch.configs.base import MeshPlan

    return MeshPlan(tp=plan.tp, sp=plan.sp, kv_dup=plan.kv_dup,
                    fsdp=plan.fsdp)


def _ref_lmesh(plan, has_pod=False):
    import jax
    from jax.sharding import Mesh

    from repro.distribution.sharding import LogicalMesh

    names = (("pod",) if has_pod else ()) + ("data", "tp", "sp")
    devs = np.array(jax.devices()[:1]).reshape((1,) * len(names))
    return LogicalMesh(mesh=Mesh(devs, names), plan=plan, has_pod=has_pod)


def _port_lmesh(plan, has_pod=False):
    from repro_torch.distribution.sharding import LogicalMesh

    return LogicalMesh(mesh=None, plan=_port_plan(plan), has_pod=has_pod)


def _ref_specs(tree):
    """``{path: spec tuple}`` of a reference tree of NamedShardings."""
    import jax

    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(sh.spec)
    return out


def _port_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_specs(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tuple(tree.spec)}


def _norm(entry):
    """A dim split over one axis, named alone (JAX's spec prints it so)."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _pad(spec, rank):
    return tuple(_norm(e) for e in spec) + (None,) * (rank - len(spec))


def _match(port: dict, ref: dict, port_shapes: dict, ref_shapes: dict):
    """Each port leaf's spec against the reference leaf of the same path
    with the layer index dropped (stacked) or kept (a list of layers); the
    reference's leading layer dims must be unsharded."""
    assert port, "no leaves"
    for path, spec in port.items():
        parts = path.split("/")
        stacked = "/".join(p for p in parts if not p.isdigit())
        key = path if path in ref else stacked
        assert key in ref, (path, sorted(ref)[:5])
        want = _pad(ref[key], len(ref_shapes[key]))
        extra = len(ref_shapes[key]) - len(port_shapes[path])
        assert all(e is None for e in want[:extra]), (path, want)
        got = _pad(spec, len(port_shapes[path]))
        assert got == want[extra:], (path, got, want)


def _ref_shapes(tree):
    import jax

    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): tuple(getattr(leaf, "shape", ()))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_shapes(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_shapes(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tuple(getattr(tree, "shape", ()))}


@pytest.mark.parametrize("arch,plans", _plans(),
                         ids=[a for a, _ in _plans()])
def test_param_and_cache_shardings_match_reference(arch, plans):
    pytest.importorskip("torch")
    import jax

    from repro.configs.registry import get_config as ref_get
    from repro.distribution import sharding as ref_sh
    from repro.distribution.steps import serve_cache_shape as ref_cache_shape
    from repro.models.registry import get_model as ref_model
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distribution import sharding as port_sh
    from repro_torch.distribution.steps import serve_cache_shape
    from repro_torch.models.registry import get_model

    rcfg, pcfg = ref_get(arch), _port_cfg(arch)
    rtree = jax.eval_shape(lambda k: ref_model(rcfg).init(k, rcfg),
                           jax.random.PRNGKey(0))
    ptree = get_model(pcfg).init(0, pcfg, device="meta")
    from repro.configs.base import ShapeConfig as RShape
    rcache = ref_cache_shape(rcfg, RShape("d", 64, 16, "decode"))
    pcache = serve_cache_shape(pcfg, ShapeConfig("d", 64, 16, "decode"))
    for plan in plans:
        for has_pod in (False, True):
            rl, pl = _ref_lmesh(plan, has_pod), _port_lmesh(plan, has_pod)
            for train in (True, False):
                _match(_port_specs(port_sh.param_shardings(ptree, pcfg, pl,
                                                           train=train)),
                       _ref_specs(ref_sh.param_shardings(rtree, rcfg, rl,
                                                         train=train)),
                       _port_shapes(ptree), _ref_shapes(rtree))
            for bs in (True, False):
                _match(_port_specs(port_sh.cache_shardings(
                    pcfg, pl, pcache, batch_shardable=bs)),
                    _ref_specs(ref_sh.cache_shardings(
                        rcfg, rl, rcache, batch_shardable=bs)),
                    _port_shapes(pcache), _ref_shapes(rcache))


@pytest.mark.parametrize("arch,plans", _plans(),
                         ids=[a for a, _ in _plans()])
def test_activation_and_batch_rules_match_reference(arch, plans):
    pytest.importorskip("torch")
    from repro.configs.registry import get_config as ref_get
    from repro.distribution import sharding as ref_sh
    from repro_torch.distribution import sharding as port_sh

    rcfg, pcfg = ref_get(arch), _port_cfg(arch)
    for plan in plans:
        for has_pod in (False, True):
            rl, pl = _ref_lmesh(plan, has_pod), _port_lmesh(plan, has_pod)
            for bs in (True, False):
                for kind in ("train", "prefill", "decode"):
                    got = {k: _pad(v.spec, 0) for k, v in
                           port_sh.activation_rules(
                               pcfg, pl, kind=kind,
                               batch_shardable=bs).items()}
                    want = {k: _pad(v.spec, 0) for k, v in
                            ref_sh.activation_rules(
                                rcfg, rl, kind=kind,
                                batch_shardable=bs).items()}
                    assert got == want, (arch, plan, kind)
                    got = {k: _pad(v.spec, 0) for k, v in
                           port_sh.batch_shardings(
                               pcfg, pl, kind=kind,
                               batch_shardable=bs).items()}
                    want = {k: _pad(v.spec, 0) for k, v in
                            ref_sh.batch_shardings(
                                rcfg, rl, kind=kind,
                                batch_shardable=bs).items()}
                    assert got == want, (arch, plan, kind)


def test_placements_follow_the_spec():
    pytest.importorskip("torch")
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distribution.sharding import Sharding

    class Mesh:  # the DeviceMesh surface Sharding reads
        mesh_dim_names = ("pod", "data", "tp", "sp")

    sh = Sharding(Mesh(), (("pod", "data"), ("tp", "sp"), None))
    assert sh.placements == (Shard(0), Shard(0), Shard(1), Shard(1))
    assert Sharding(Mesh(), (None, "tp")).placements == (
        Replicate(), Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        _ = Sharding(Mesh(), (("sp", "tp"),)).placements


def test_ctx_is_a_no_op_outside_a_context():
    torch = pytest.importorskip("torch")
    from repro_torch.distribution import ctx

    x = torch.ones(2, 3)
    assert ctx.constrain(x, "act_btd") is x and not ctx.active()
    assert ctx.moe_impl() is None and ctx.seq_offset() == 0
    with ctx.sharding_context({"act_btd": lambda t: t * 2,
                               "seq_offset": lambda: 5}):
        assert ctx.active() and ctx.seq_offset() == 5
        assert torch.equal(ctx.constrain(x, "act_btd"), x * 2)
        assert ctx.constrain(x, "logits") is x
        bound = ctx.bind(lambda: ctx.seq_offset())
    assert not ctx.active() and bound() == 5


def test_launch_mesh_imports_without_a_process_group():
    pytest.importorskip("torch")
    code = ("import torch.distributed as d, repro_torch.launch.mesh, "
            "repro_torch.distribution.steps; assert not d.is_initialized()")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr


# --------------------------------------------------------------------------- #
# The worlds
# --------------------------------------------------------------------------- #
REF_SCRIPT = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig, ShapeConfig, MeshPlan, choose_mesh_plan
from repro.distribution.sharding import derive_logical_mesh
from repro.distribution.steps import build_train_step, build_serve_step, init_train_state
from repro.models.registry import get_model
out_dir, cfgs, train_cases, decode_cases = sys.argv[1], *map(json.loads, sys.argv[2:5])

def flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

def lmesh_of(cfg, plan):
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    plan = MeshPlan(**plan) if plan else choose_mesh_plan(cfg, model_axis=4)
    return derive_logical_mesh(mesh, plan)

rng = np.random.default_rng(0)
batch = {"tokens": jnp.asarray(rng.integers(0, 512, (2, 4, 32)), jnp.int32),
         "targets": jnp.asarray(rng.integers(0, 512, (2, 4, 32)), jnp.int32),
         "mask": jnp.ones((2, 4, 32), jnp.float32)}
res = {}
for name, (fam, dtype, plan) in train_cases.items():
    cfg = ModelConfig(dtype=dtype, **cfgs[fam])
    lm = lmesh_of(cfg, plan)
    fn, in_sh, out_sh, _ = build_train_step(
        cfg, lm, ShapeConfig("t", seq_len=32, global_batch=8, kind="train",
                             microbatches=2))
    with lm.mesh:
        state = init_train_state(cfg, seed=0)
        jitted = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        for _ in range(2):
            state, m = jitted(state, batch)
    np.savez(os.path.join(out_dir, f"ref_{name}.npz"), **flat(state["params"]))
    res[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
for name, (fam, dtype, plan) in decode_cases.items():
    cfg = ModelConfig(dtype=dtype, **cfgs[fam])
    lm = lmesh_of(cfg, plan)
    fn, in_sh, out_sh, _ = build_serve_step(
        cfg, lm, ShapeConfig("d", seq_len=64, global_batch=8, kind="decode"))
    api = get_model(cfg)
    with lm.mesh:
        params = api.init(jax.random.PRNGKey(0), cfg)
        caches = api.init_cache(cfg, 8, 64)
        tok = jnp.arange(8, dtype=jnp.int32) + 3
        jitted = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
        logits, caches = jitted(params, caches, tok)
        logits2, _ = jitted(params, caches, tok + 1)
    np.save(os.path.join(out_dir, f"ref_{name}.npy"),
            np.asarray(jnp.asarray(logits2, jnp.float32)))
print(json.dumps(res))
'''

WORLD_HEAD = r'''
import datetime, json, os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: np.asarray(tree)}

def main(body, world):
    out_dir = sys.argv[1]
    store = os.path.join(out_dir, f"store{world}")
    mp.spawn(entry, args=(world, store, out_dir), nprocs=world, join=True)

def entry(rank, world, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = body(rank, world, out_dir)
        if rank == 0:
            with open(os.path.join(out_dir, f"world{world}.json"), "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()
'''

WORLD8 = r'''
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import MeshPlan, ModelConfig, ShapeConfig, choose_mesh_plan
from repro_torch.distribution import sharding as shlib
from repro_torch.distribution.sharding import derive_logical_mesh
from repro_torch.distribution.steps import (
    build_serve_step, build_train_step, gather, init_train_state, place,
    place_params, train_state_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
from repro_torch.models.registry import get_model

CFGS, TRAIN, DECODE = (json.loads(a) for a in sys.argv[2:5])

def body(rank, world, out_dir):
    mesh = make_host_mesh(2, 4)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(0, 512, (2, 4, 32)), dtype=torch.int32),
             "targets": torch.tensor(rng.integers(0, 512, (2, 4, 32)), dtype=torch.int32),
             "mask": torch.ones((2, 4, 32))}
    shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train", microbatches=2)
    res = {}

    def lmesh_of(cfg, plan):
        plan = MeshPlan(**plan) if plan else choose_mesh_plan(cfg, model_axis=4)
        return derive_logical_mesh(mesh, plan)

    for name, (fam, dtype, plan) in TRAIN.items():
        cfg = ModelConfig(dtype=dtype, **CFGS[fam])
        lm = lmesh_of(cfg, plan)
        ck = Checkpointer(os.path.join(out_dir, f"init_{fam}_{dtype}"))
        like = init_train_state(cfg, 0, device="cpu")
        state, _ = ck.restore(like, shardings=train_state_shardings(cfg, lm, like))
        fn = build_train_step(cfg, lm, shape)[0]
        for _ in range(2):
            state, m = fn(state, batch)
        params = transformer.params_to_numpy(gather(state["params"]), cfg)
        r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "plan": str(lm.plan)}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"port_{name}.npz"), **flat(params))
            plain, _ = ck.restore(like)
            fn1 = build_train_step(cfg, None, shape)[0]
            for _ in range(2):
                plain, m1 = fn1(plain, batch)
            np.savez(os.path.join(out_dir, f"plain_{name}.npz"),
                     **flat(transformer.params_to_numpy(plain["params"], cfg)))
            r["plain_loss"] = float(m1["loss"])
            r["plain_grad_norm"] = float(m1["grad_norm"])
        res[name] = r
    for name, (fam, dtype, plan) in DECODE.items():
        cfg = ModelConfig(dtype=dtype, **CFGS[fam])
        lm = lmesh_of(cfg, plan)
        api = get_model(cfg)
        ck = Checkpointer(os.path.join(out_dir, f"params_{fam}_{dtype}"))
        params, _ = ck.restore(api.init(0, cfg, device="cpu"))
        fn, (psh, csh, tsh), _, _ = build_serve_step(
            cfg, lm, ShapeConfig("d", seq_len=64, global_batch=8, kind="decode"))
        tok = torch.arange(8, dtype=torch.int32) + 3
        caches = place(api.init_cache(cfg, 8, 64, device="cpu"), csh)
        placed = place_params(params, cfg, lm)
        _, caches = fn(placed, caches, tok)
        logits2, _ = fn(placed, caches, tok + 1)
        logits2 = logits2.full_tensor().float().numpy()
        if rank == 0:
            np.save(os.path.join(out_dir, f"port_{name}.npy"), logits2)
            c = api.init_cache(cfg, 8, 64, device="cpu")
            _, c = api.decode_step(params, tok, cfg, c)
            l2, _ = api.decode_step(params, tok + 1, cfg, c)
            np.save(os.path.join(out_dir, f"plain_{name}.npy"), l2.float().numpy())
        res[name] = {"plan": str(lm.plan)}
    # The port's other layouts and families, f32, against its own unsharded
    # step: tied and fused projections, sp = 4 with q/k/v biases, the VLM
    # prefix (tensor parallel), and the data-parallel SSM, hybrid and audio.
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution.steps import place_train_state, train_batch_specs
    from repro_torch.optim.optimizers import tree_leaves
    extra = {
        "tied": (ModelConfig(dtype="float32", tie_embeddings=True, **CFGS["dense"]), None),
        "fused": (ModelConfig(dtype="float32", fuse_qkv=True, qkv_bias=True, **CFGS["dense"]),
                  {"tp": 2, "sp": 2}),
    }
    for arch in ("qwen2_7b", "internvl2_26b", "mamba2_1_3b", "zamba2_1_2b",
                 "seamless_m4t_medium"):
        extra[arch] = (dataclasses.replace(get_config(arch, smoke=True),
                                           dtype="float32"), None)
    gen = np.random.default_rng(5)
    for name, (cfg, plan) in extra.items():
        lm = lmesh_of(cfg, plan)
        specs = train_batch_specs(cfg, shape)
        b = {k: (torch.tensor(gen.integers(0, cfg.vocab_size, shp), dtype=dt)
                 if dt == torch.int32 else
                 torch.ones(shp) if k == "mask" else
                 torch.tensor(gen.standard_normal(shp), dtype=torch.float32).to(dt))
             for k, (shp, dt) in specs.items()}
        state = place_train_state(init_train_state(cfg, 0, device="cpu"), cfg, lm)
        fn = build_train_step(cfg, lm, shape)[0]
        for _ in range(2):
            state, m = fn(state, b)
        got = [t.float() for t in tree_leaves(gather(state["params"]))]
        r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "plan": str(lm.plan)}
        if rank == 0:
            plain = init_train_state(cfg, 0, device="cpu")
            fn1 = build_train_step(cfg, None, shape)[0]
            for _ in range(2):
                plain, m1 = fn1(plain, b)
            want = [t.float() for t in tree_leaves(plain["params"])]
            r["plain_loss"], r["plain_grad_norm"] = float(m1["loss"]), float(m1["grad_norm"])
            r["param_diff"] = max(float((a - c).abs().max()) for a, c in zip(got, want))
            r["param_scale"] = max(float(c.abs().max()) for c in want)
        res["extra_" + name] = r
    # Serving, f32, against the unsharded prefill and two decode steps: the
    # data-parallel families and the VLM at sp = 2 (data parallel too).
    from repro_torch.distribution.steps import build_prefill_step
    for arch, plan in (("mamba2_1_3b", None), ("zamba2_1_2b", None),
                       ("seamless_m4t_medium", None),
                       ("internvl2_26b", {"tp": 2, "sp": 2})):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        lm, api = lmesh_of(cfg, plan), get_model(cfg)
        params = api.init(0, cfg, device="cpu")
        s_len, b = 32, 8
        toks = torch.tensor(gen.integers(0, cfg.vocab_size, (b, s_len)), dtype=torch.int32)
        if cfg.family == "vlm":
            f = cfg.frontend_tokens
            inputs = (toks[:, f:], torch.tensor(gen.standard_normal((b, f, cfg.d_model)),
                                                 dtype=torch.float32))
            want, _ = api.prefill(params, inputs[0], cfg, s_len, prefix_embeds=inputs[1])
        elif cfg.family == "audio":
            inputs = (torch.tensor(gen.standard_normal((b, s_len, cfg.d_model)),
                                   dtype=torch.float32), toks)
            want, _ = api.prefill(params, *inputs, cfg, s_len)
        else:
            inputs = (toks,)
            want, _ = api.prefill(params, toks, cfg, s_len)
        placed = place_params(params, cfg, lm)
        pshape = ShapeConfig("p", seq_len=s_len, global_batch=b, kind="prefill")
        got, _ = build_prefill_step(cfg, lm, pshape)[0](placed, *inputs)
        got = got.full_tensor()
        dshape = ShapeConfig("d", seq_len=64, global_batch=b, kind="decode")
        fn, (psh, csh, tsh), _, _ = build_serve_step(cfg, lm, dshape)
        tok = torch.arange(b, dtype=torch.int32) + 3
        mk = ((lambda: api.init_cache(cfg, b, 64, 64, device="cpu"))
              if cfg.family == "audio" else
              (lambda: api.init_cache(cfg, b, 64, device="cpu")))
        caches = place(mk(), csh)
        _, caches = fn(placed, caches, tok)
        d2, _ = fn(placed, caches, tok + 1)
        d2 = d2.full_tensor()
        r = {"plan": str(lm.plan)}
        if rank == 0:
            c = mk()
            _, c = api.decode_step(params, tok, cfg, c)
            w2, _ = api.decode_step(params, tok + 1, cfg, c)
            r["prefill"] = float((got - want).abs().max() / want.abs().max())
            r["decode"] = float((d2 - w2).abs().max() / w2.abs().max())
        res["serve_" + arch] = r
    # A reference checkpoint restored into a sharded state, gathered.
    cfg = ModelConfig(dtype="bfloat16", scan_layers=False, **CFGS["dense"])
    lm = lmesh_of(cfg, {"tp": 2, "sp": 2})
    like = init_train_state(cfg, 0, device="cpu")
    shard = train_state_shardings(cfg, lm, like)
    state, extra = Checkpointer(os.path.join(out_dir, "ref_ckpt")).restore(
        like, shardings=shard)
    from torch.distributed.tensor import DTensor
    placed_ok = all(isinstance(t, DTensor) and t.placements == s.placements
                    for t, s in zip(_leaves(state["params"]), _leaves(shard["params"])))
    full = gather(state)
    if rank == 0:
        np.savez(os.path.join(out_dir, "restored.npz"),
                 **{k: v.astype(np.float32) for k, v in flat(_np(full)).items()})
    res["restore"] = {"placed": placed_ok, "extra": extra}
    return res

def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [t]

def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree

if __name__ == "__main__":
    main(body, 8)
'''

WORLD4 = r'''
from repro_torch.configs.base import MeshPlan
from repro_torch.core.devicemodel import GRADES
from repro_torch.core.simulation import DeviceTier, LogicalTier
from repro_torch.core.updates import dequantize_rows, quantize_rows
from repro_torch.distribution.sharding import derive_logical_mesh, make_fleet_mesh
from repro_torch.kernels.fed_reduce.ops import fed_reduce
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import ctr

def raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False

def tiers(mesh):
    rng = np.random.default_rng(2)
    n, dim, rec = 8, 24, 10
    batches = {"x": torch.tensor((rng.random((n, rec, dim)) < 0.2) / 3.0, dtype=torch.float32),
               "y": torch.tensor(rng.random((n, rec)) < 0.4, dtype=torch.float32),
               "mask": torch.ones((n, rec))}
    params = {"w": torch.tensor(rng.standard_normal(dim), dtype=torch.float32),
              "b": torch.tensor(0.1)}
    fn = ctr.make_local_train_fn(lr=0.05, epochs=5)
    seeds = torch.arange(n, dtype=torch.int64)
    out = {}
    for name, make in (("device", lambda m: DeviceTier(fn, GRADES["High"], device="cpu", mesh=m, data_axis="dp")),
                       ("logical", lambda m: LogicalTier(fn, device="cpu", mesh=m, data_axis="dp"))):
        p0, m0 = make(None)._cohort_fn(params, batches, seeds)
        p1, m1 = make(mesh)._cohort_fn(params, batches, seeds)
        out[name] = max(float((p0[k].float() - p1[k].float()).abs().max()) for k in p0)
        out[name + "_metrics"] = max(float((m0[k].float() - m1[k].float()).abs().max()) for k in m0)
    return out

def body(rank, world, out_dir):
    res = {}
    rng = np.random.default_rng(3)
    stack = torch.tensor(rng.standard_normal((10, 3, 5)), dtype=torch.float32)
    w = torch.tensor(rng.random(10), dtype=torch.float32)
    mesh = make_fleet_mesh(4, device="cpu")
    res["mesh_axes"] = list(mesh.mesh_dim_names)
    out, ref = fed_reduce(stack, w, impl="ref", mesh=mesh), fed_reduce(stack, w, impl="ref")
    res["fed_reduce_err"] = float((out - ref).abs().max())
    res["fed_reduce_rel"] = float(((out - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((10, 48)), dtype=torch.float32)
    w = torch.tensor(rng.random(10), dtype=torch.float32)
    (q,), (s,), _ = quantize_rows([x])
    out = fed_reduce(q, w, scales=s, impl="ref", mesh=mesh)
    want = torch.tensordot(w * s, dequantize_rows([q], [s])[0] / s[:, None], dims=1)
    res["int8_err"] = float((out - want).abs().max())
    res["int8_scale"] = float(want.abs().max())
    # Padding rows: 10 rows over 4 shards pads 2 rows of weight 0.
    res["pad_zero"] = float(fed_reduce(q[:2], torch.zeros(2), scales=s[:2],
                                       impl="ref", mesh=mesh).abs().max())
    res["tiers"] = tiers(make_fleet_mesh(2, model_shards=2, device="cpu"))
    res["errors"] = {
        "fleet_too_many": raises(lambda: make_fleet_mesh(5, device="cpu")),
        "fleet_model_shards": raises(lambda: make_fleet_mesh(None, model_shards=3, device="cpu")),
        "derive_tp_sp": raises(lambda: derive_logical_mesh(make_host_mesh(1, 4), MeshPlan(tp=2, sp=1))),
        "production": raises(lambda: make_production_mesh(device="cpu")),
        "multi_pod": raises(lambda: make_production_mesh(multi_pod=True, device="cpu")),
    }
    full = make_fleet_mesh(device="cpu")
    res["fleet_all"] = [full.size(0), full.size(1)]
    # Cloud mode under a 4-rank world: a (4, 1) mesh; then 1 step and a
    # resume to 2 from the checkpoint rank 0 wrote.
    from repro_torch.launch import train
    os.environ["WORLD_SIZE"] = "4"
    argv = ["--mode", "cloud", "--smoke", "--checkpoint-every", "1",
            "--device", "cpu"]
    whole = train.run(argv + ["--steps", "2", "--checkpoint-dir",
                              os.path.join(out_dir, "ck_whole")])["losses"]
    first = train.run(argv + ["--steps", "1", "--checkpoint-dir",
                              os.path.join(out_dir, "ck_resume")])["losses"]
    rest = train.run(argv + ["--steps", "2", "--checkpoint-dir",
                             os.path.join(out_dir, "ck_resume")])["losses"]
    res["cloud"] = {"whole": whole, "resumed": first + rest}
    return res

if __name__ == "__main__":
    main(body, 4)
'''

WORLD1 = r'''
import contextlib, io
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core.devicemodel import GRADES
from repro_torch.core.simulation import DeviceTier, LogicalTier
from repro_torch.distribution.sharding import make_fleet_mesh
from repro_torch.kernels.fed_reduce.ops import fed_reduce
from repro_torch.launch import train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ctr

def body(rank, world, out_dir):
    res = {}
    rng = np.random.default_rng(0)
    stack = torch.tensor(rng.standard_normal((6, 4, 8)), dtype=torch.float32)
    w = torch.tensor(rng.random(6), dtype=torch.float32)
    mesh = make_fleet_mesh(1, device="cpu")
    res["axes"] = list(mesh.mesh_dim_names)
    res["single_shard_equal"] = bool(torch.equal(
        fed_reduce(stack, w, impl="ref", mesh=mesh), fed_reduce(stack, w, impl="ref")))
    try:
        make_fleet_mesh(2, device="cpu")
        res["too_many"] = False
    except ValueError:
        res["too_many"] = True
    rng = np.random.default_rng(2)
    batches = {"x": torch.tensor((rng.random((8, 10, 24)) < 0.2) / 3.0, dtype=torch.float32),
               "y": torch.tensor(rng.random((8, 10)) < 0.4, dtype=torch.float32),
               "mask": torch.ones((8, 10))}
    params = {"w": torch.tensor(rng.standard_normal(24), dtype=torch.float32),
              "b": torch.tensor(0.1)}
    fn = ctr.make_local_train_fn(lr=0.05, epochs=5)
    seeds = torch.arange(8, dtype=torch.int64)
    for name, cls in (("device", lambda m: DeviceTier(fn, GRADES["High"], device="cpu", mesh=m)),
                      ("logical", lambda m: LogicalTier(fn, device="cpu", mesh=m))):
        p0, _ = cls(None)._cohort_fn(params, batches, seeds)
        p1, _ = cls(init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
                    )._cohort_fn(params, batches, seeds)
        res["tier_" + name] = max(float((p0[k] - p1[k]).abs().max()) for k in p0)
    lines = {}
    for tag, extra in (("mesh", ["--fleet-shards", "1"]), ("plain", [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.run(["--smoke", "--rounds", "2", "--clients-per-round", "4",
                       "--traffic", "curve", "--device", "cpu", *extra])
        lines[tag] = buf.getvalue().splitlines()
    res["cli"] = lines
    res["cloud"] = train.run(["--mode", "cloud", "--smoke", "--steps", "2",
                              "--device", "cpu", "--checkpoint-dir",
                              os.path.join(out_dir, "ck_one")])["losses"]
    try:
        train.run(["--mode", "cloud", "--smoke", "--multi-pod", "--device", "cpu"])
        res["multi_pod_raises"] = False
    except ValueError as e:
        res["multi_pod_raises"] = "512" in str(e)
    try:
        make_production_mesh(device="cpu")
        res["production_raises"] = False
    except ValueError:
        res["production_raises"] = True
    return res

if __name__ == "__main__":
    main(body, 1)
'''


def _write_inits(out: pathlib.Path):
    """The reference's initial states as the port's checkpoints (the
    port's layout), and one reference checkpoint (unstacked layers)."""
    import jax

    from repro.checkpoint.checkpointer import Checkpointer as RefCk
    from repro.configs.base import ModelConfig as RCfg
    from repro.distribution.steps import init_train_state as ref_init
    from repro.models.registry import get_model as ref_model
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import ModelConfig
    from repro_torch.distribution.steps import train_state_from_numpy
    from repro_torch.models import transformer

    for fam, kw in CFGS.items():
        for dtype in ("bfloat16", "float32"):
            rcfg, pcfg = RCfg(dtype=dtype, **kw), ModelConfig(dtype=dtype, **kw)
            tree = jax.tree.map(np.asarray, ref_init(rcfg, seed=0))
            Checkpointer(out / f"init_{fam}_{dtype}").save(
                0, train_state_from_numpy(tree, pcfg, "cpu"))
            params = jax.tree.map(np.asarray, ref_model(rcfg).init(
                jax.random.PRNGKey(0), rcfg))
            Checkpointer(out / f"params_{fam}_{dtype}").save(
                0, transformer.params_from_numpy(params, pcfg, "cpu"))
    rcfg = RCfg(dtype="bfloat16", scan_layers=False, **CFGS["dense"])
    state = ref_init(rcfg, seed=3)
    RefCk(out / "ref_ckpt").save(0, state, extra={"from": "reference"})
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf, np.float32)
    np.savez(out / "ref_ckpt.npz", **flat)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    pytest.importorskip("torch")
    out = tmp_path_factory.mktemp("worlds")
    args = [json.dumps(CFGS), json.dumps(TRAIN_CASES),
            json.dumps(DECODE_CASES)]
    procs = {}
    # The reference's runs (the longest) need no inits: they start first,
    # the train and the decode cases in two processes.
    (out / "ref.py").write_text(REF_SCRIPT)
    for name, cases in (("ref", [json.dumps(TRAIN_CASES), "{}"]),
                        ("ref_decode", ["{}", json.dumps(DECODE_CASES)])):
        procs[name] = subprocess.Popen(
            [sys.executable, str(out / "ref.py"), str(out), args[0], *cases],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    try:
        _write_inits(out)
    except BaseException:
        for p in procs.values():
            p.kill()
        raise
    for name, body in (("world8", WORLD8), ("world4", WORLD4),
                       ("world1", WORLD1)):
        script = out / f"{name}.py"
        script.write_text(WORLD_HEAD + body)
        procs[name] = subprocess.Popen(
            [sys.executable, str(script), str(out), *args], cwd=ROOT,
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    res = {"dir": out}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            raise
        assert p.returncode == 0, f"{name}:\n{stdout}\n{stderr}"
        if name.startswith("ref"):
            res.setdefault("ref", {}).update(
                json.loads(stdout.strip().splitlines()[-1]))
        else:
            res[name] = json.loads((out / f"{name}.json").read_text())
    return res


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def _max_diff(a: dict, b: dict) -> tuple[float, float]:
    assert sorted(a) == sorted(b)
    diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    scale = max(float(np.abs(b[k]).max()) for k in b)
    return diff, scale


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_unsharded_port(worlds, case):
    pytest.importorskip("torch")
    r = worlds["world8"][case]
    d = worlds["dir"]
    diff, scale = _max_diff(_npz(d / f"port_{case}.npz"),
                            _npz(d / f"plain_{case}.npz"))
    # The reference's test tolerance, bf16 and f32 alike: an MoE step's
    # routing capacity is per shard, so the (2, 4) run is another function.
    assert abs(r["loss"] - r["plain_loss"]) < TOL_TRAIN, r
    assert diff < TOL_TRAIN, (diff, r)
    if CFGS[TRAIN_CASES[case][0]]["family"] == "dense" and case.endswith(
            "f32"):
        # Dense f32: the same function, to rounding.
        assert abs(r["loss"] - r["plain_loss"]) <= TOL_F32 * abs(
            r["plain_loss"]), r
        assert diff <= TOL_F32 * scale, (diff, scale)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_sharded_train_step_matches_reference_same_plan(worlds, case):
    pytest.importorskip("torch")
    r, ref = worlds["world8"][case], worlds["ref"][case]
    d = worlds["dir"]
    diff, scale = _max_diff(_npz(d / f"port_{case}.npz"),
                            _npz(d / f"ref_{case}.npz"))
    if case.endswith("bf16"):
        assert abs(r["loss"] - ref["loss"]) < TOL_TRAIN, (r, ref)
        assert diff < TOL_TRAIN, (diff, r, ref)
    else:
        # Largest difference seen: ~1e-7 relative (loss, grad norm) and
        # ~3e-9 of the largest weight.
        for k in ("loss", "grad_norm"):
            assert abs(r[k] - ref[k]) <= TOL_F32 * abs(ref[k]), (k, r, ref)
        assert diff <= TOL_F32 * scale, (diff, scale)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_sharded_decode_matches_unsharded_and_reference(worlds, case):
    pytest.importorskip("torch")
    d = worlds["dir"]
    port = np.load(d / f"port_{case}.npy")
    plain = np.load(d / f"plain_{case}.npy")
    ref = np.load(d / f"ref_{case}.npy")
    tol = TOL_DECODE if case.endswith("bf16") else TOL_F32 * float(
        np.abs(ref).max())
    assert float(np.abs(port - ref).max()) < tol, case
    assert float(np.abs(port - plain).max()) < (
        TOL_DECODE if case.endswith("bf16") else
        TOL_F32 * float(np.abs(plain).max())), case


def test_reference_checkpoint_restores_into_sharded_state(worlds):
    pytest.importorskip("torch")
    d = worlds["dir"]
    r = worlds["world8"]["restore"]
    assert r["placed"] and r["extra"] == {"from": "reference"}
    got, want = _npz(d / "restored.npz"), _npz(d / "ref_ckpt.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fed_reduce_over_four_fleet_shards(worlds):
    pytest.importorskip("torch")
    r = worlds["world4"]
    assert r["mesh_axes"] == ["dp", "mp"]
    assert r["fed_reduce_err"] <= 1e-6 or r["fed_reduce_rel"] <= 2e-5, r
    assert r["int8_err"] <= 2e-5 * r["int8_scale"] + 1e-5, r
    assert r["pad_zero"] == 0.0


def test_tiers_over_two_fleet_shards_match_unsharded(worlds):
    pytest.importorskip("torch")
    t = worlds["world4"]["tiers"]
    for k in ("device", "logical", "device_metrics", "logical_metrics"):
        assert t[k] <= 1e-6, t


def test_mesh_errors_where_the_reference_raises(worlds):
    pytest.importorskip("torch")
    r = worlds["world4"]
    assert all(r["errors"].values()), r["errors"]
    assert r["fleet_all"] == [4, 1]
    assert worlds["world1"]["too_many"]


def test_single_fleet_shard_paths(worlds):
    pytest.importorskip("torch")
    r = worlds["world1"]
    assert r["axes"] == ["dp", "mp"] and r["single_shard_equal"]
    assert r["tier_device"] <= 1e-6 and r["tier_logical"] <= 1e-6


def test_cli_fleet_shards_prints_the_unsharded_lines(worlds):
    pytest.importorskip("torch")
    cli = worlds["world1"]["cli"]
    rounds = [ln for ln in cli["mesh"] if ln.startswith("round")]
    assert len(rounds) == 2 and cli["mesh"] == cli["plain"]


def _cli_columns(lines):
    """The aggregation, latency and shelf columns of the round lines (the
    client loss depends on each package's own init)."""
    return [ln.split("aggregations", 1)[1] for ln in lines
            if ln.startswith("round")]


def test_cli_fleet_shards_columns_match_reference(worlds):
    pytest.importorskip("torch")
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", "--smoke", "--rounds",
         "2", "--clients-per-round", "4", "--traffic", "curve",
         "--fleet-shards", "1"], capture_output=True, text=True, cwd=ROOT,
        env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr
    assert _cli_columns(worlds["world1"]["cli"]["mesh"]) == _cli_columns(
        out.stdout.splitlines())


def test_cli_workers_with_fleet_shards_exits_like_reference():
    pytest.importorskip("torch")
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="--workers is incompatible with "
                                         "--fleet-shards"):
        train.run(["--smoke", "--workers", "2", "--fleet-shards", "1",
                   "--device", "cpu"])


def test_cli_multi_pod_raises_at_world_one(worlds):
    pytest.importorskip("torch")
    assert worlds["world1"]["multi_pod_raises"]
    assert worlds["world1"]["production_raises"]


EXTRA = ("tied", "fused", "qwen2_7b", "internvl2_26b", "mamba2_1_3b",
         "zamba2_1_2b", "seamless_m4t_medium")


@pytest.mark.parametrize("name", EXTRA)
def test_sharded_train_step_layouts_and_families_f32(worlds, name):
    """Tied and fused projections, sp = 4 with biases, the VLM prefix, and
    the data-parallel families, each against the port's unsharded step."""
    pytest.importorskip("torch")
    r = worlds["world8"]["extra_" + name]
    for k in ("loss", "grad_norm"):
        assert abs(r[k] - r["plain_" + k]) <= TOL_F32 * abs(r["plain_" + k]), r
    assert r["param_diff"] <= TOL_F32 * r["param_scale"], r


def test_cli_multi_pod_outside_cloud_mode_raises():
    pytest.importorskip("torch")
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="--multi-pod"):
        train.run(["--smoke", "--multi-pod", "--device", "cpu"])


def test_cloud_mode_over_a_four_rank_world(worlds):
    """``launch.train --mode cloud`` under a 4-rank world builds a (4, 1)
    mesh: its losses follow the one-process run (bf16, 2e-2) and a run
    resumed from the checkpoint rank 0 wrote gives the uninterrupted
    losses exactly."""
    pytest.importorskip("torch")
    four, one = worlds["world4"]["cloud"], worlds["world1"]["cloud"]
    assert len(four["whole"]) == len(one) == 2
    assert four["resumed"] == four["whole"]
    for a, b in zip(four["whole"], one):
        assert abs(a - b) <= 2e-2 * abs(b), (four, one)


SERVE = ("mamba2_1_3b", "zamba2_1_2b", "seamless_m4t_medium", "internvl2_26b")


@pytest.mark.parametrize("arch", SERVE)
def test_sharded_serving_of_the_data_parallel_families_f32(worlds, arch):
    """``build_prefill_step`` and two ``build_serve_step`` steps of the
    SSM, hybrid and audio families and the VLM at sp = 2 (each rank's batch
    block whole) against the unsharded prefill and decode."""
    pytest.importorskip("torch")
    r = worlds["world8"]["serve_" + arch]
    assert r["prefill"] <= TOL_F32 and r["decode"] <= TOL_F32, r
