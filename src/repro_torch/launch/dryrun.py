"""Production-mesh dry run on the meta device: every (arch x shape x mesh)
cell's sharded program, traced for one rank.

The twin of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell for a 256- or 512-device mesh of fake host devices
(``--xla_force_host_platform_device_count=512``); here ``main()`` starts an
in-process fake process group of 256 or 512 ranks (torch's ``"fake"``
backend: collectives return at once, nothing is sent) and this process
plays rank 0.  For each cell it proves (a) the sharding is coherent: the
step is built with ``build_train_step``, ``build_prefill_step`` or
``build_serve_step`` on ``make_production_mesh``, its inputs are placed on
the ``meta`` device with ``steps.place``, and rank 0's program runs once to
its end, every kernel on its shapes-only route; (b) what that rank holds
(its argument shards, the outputs, the peak of what the program
allocates); (c) the flops, bytes and collectives the roofline reads,
counted by :func:`repro_torch.roofline.op_analysis.analyze`, with each
kernel's work by formula.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Importing this module starts no process group; ``main()`` does, and tears
it down before it returns.  ``run_cell`` needs one already running with
the mesh's world size (:func:`start_world`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, choose_mesh_plan
from repro_torch.configs.registry import ALIASES, get_config, lm_arch_ids
from repro_torch.distribution.sharding import derive_logical_mesh
from repro_torch.distribution.steps import (
    build_prefill_step,
    build_serve_step,
    build_train_step,
    place,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.op_analysis import COLLECTIVES, analyze

SKIPPED_LONG = {
    # long_500k requires a sub-quadratic path; these are pure full-attention
    # (see DESIGN.md §6).
    "phi3_medium_14b", "llama3_2_3b", "qwen2_7b", "nemotron_4_15b",
    "granite_moe_3b_a800m", "phi3_5_moe_42b_a6_6b", "internvl2_26b",
    "seamless_m4t_medium",
}

META = torch.device("meta")


def cell_supported(arch: str, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and arch in SKIPPED_LONG:
        return False, "pure full-attention arch at 524k context (DESIGN.md §6)"
    return True, ""


def start_world(ranks: int) -> None:
    """A fake process group of ``ranks`` ranks in this process, as rank 0
    (any running group is torn down first)."""
    import torch.distributed as dist
    # Registers the "fake" backend with torch.distributed.
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def stop_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _empty(spec) -> torch.Tensor:
    shape, dtype = spec
    return torch.empty(shape, dtype=dtype, device=META)


def _local_bytes(tree) -> int:
    """Bytes of the rank's own blocks of ``tree``'s tensors (each storage
    once)."""
    from torch.utils._pytree import tree_flatten

    seen = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = getattr(t, "_local_tensor", t).untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def cell_program(cfg, lmesh, shape):
    """``(step, inputs)``: the cell's sharded step and its placed meta
    inputs, each rank's block as a ``DTensor``."""
    if shape.kind == "train":
        fn, state_shape, specs = build_train_step(cfg, lmesh, shape)
        state_sh, batch_sh = fn.shardings
        batch = {k: _empty(v) for k, v in specs.items()}
        return fn, (place(state_shape, state_sh), place(batch, batch_sh))
    if shape.kind == "prefill":
        fn, in_sh, _, in_specs = build_prefill_step(cfg, lmesh, shape)
        pshape, *inputs = in_specs
        return fn, (place(pshape, in_sh[0]),
                    *(place(_empty(s), sh)
                      for s, sh in zip(inputs, in_sh[1:])))
    fn, (pshard, cshard, tshard), _, (pshape, cshape, tspec) = \
        build_serve_step(cfg, lmesh, shape)
    if "pos" in cshape:  # the last token of a full cache: seq_len rows read
        cshape = dict(cshape, pos=shape.seq_len - 1)
    return fn, (place(pshape, pshard), place(cshape, cshard),
                place(_empty(tspec), tshard))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: pathlib.Path, step_override=None) -> dict:
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if step_override:
        cfg = dataclasses.replace(cfg, **step_override)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    plan = choose_mesh_plan(cfg, model_axis=mesh.shape[-1])
    lmesh = derive_logical_mesh(mesh, plan)
    fn, inputs = cell_program(cfg, lmesh, shape)
    t1 = time.perf_counter()
    _, an = analyze(fn, *inputs)
    t_trace = time.perf_counter() - t1

    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "plan": {"tp": plan.tp, "sp": plan.sp, "kv_dup": plan.kv_dup,
                 "fsdp": plan.fsdp and shape.kind == "train"},
        "ok": True,
        "seconds": {"trace": round(t_trace, 1),
                    "total": round(time.perf_counter() - t0, 1)},
        "memory": {
            "argument_bytes": _local_bytes(inputs),
            "output_bytes": an["output_bytes"],
            "temp_bytes": an["temp_bytes"],
        },
        "cost_analysis": {
            "flops": an["flops"],
            "bytes_accessed": an["bytes"],
        },
        "collective_op_counts": {k: an["collective_count"].get(k, 0)
                                 for k in COLLECTIVES},
        "collective_bytes": {k: an["collective_bytes"].get(k, 0)
                             for k in COLLECTIVES},
        "kernels": an["kernels"],
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{arch}__{shape_name}__{rec['mesh'].replace('x', '_')}"
    (out_dir / f"{stem}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    cells: list[tuple[str, str]] = []
    archs = lm_arch_ids() if (args.all or not args.arch) else (args.arch,)
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        a_norm = ALIASES.get(a, a).replace("-", "_").replace(".", "_")
        for s in shapes:
            cells.append((a_norm, s))

    # One world per mesh: a fake group of 256 ranks, then one of 512.
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    try:
        for i, mp in enumerate(meshes):
            start_world(512 if mp else 256)
            for arch, shape_name in cells:
                ok, why = cell_supported(arch, shape_name)
                if not ok:
                    if i == 0:
                        print(f"SKIP  {arch} x {shape_name}: {why}",
                              flush=True)
                    continue
                tag = f"{arch} x {shape_name} x {'2x16x16' if mp else '16x16'}"
                try:
                    rec = run_cell(arch, shape_name, multi_pod=mp,
                                   out_dir=out_dir)
                    print(
                        f"PASS  {tag}  trace={rec['seconds']['trace']}s "
                        f"flops/dev={rec['cost_analysis']['flops']:.3e} "
                        f"temp/dev={rec['memory']['temp_bytes'] / 1e9:.2f}GB",
                        flush=True,
                    )
                except Exception as e:
                    failures += 1
                    print(f"FAIL  {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    finally:
        stop_world()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
