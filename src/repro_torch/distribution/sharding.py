"""Sharding rules: params / activations / caches -> partition specs, and
their DTensor placements on a ``torch.distributed`` device mesh.

The rules are the reference's (``src/repro/distribution/sharding.py``),
verbatim.  A spec is a plain tuple with one entry per tensor dim: a mesh
axis name, ``None`` (not sharded), or a tuple of names (the dim split over
several axes, major first).

The physical production mesh is ``(pod?, data=16, model=16)``.  Per
architecture we *derive* a logical mesh by reshaping the same rank array to
``(pod?, data, tp, sp)`` with ``tp*sp = model`` — the hardware topology is
untouched; only the axis naming is refined.

Placement summary (train):
  weights      — ``tp`` on heads/d_ff/experts/vocab + FSDP (``data``) on the
                 other matrix dim; biases/norms replicated.
  activations  — batch on ``(pod, data)``, sequence on ``sp``.
  KV caches    — batch on ``data``, sequence on ``sp``, kv-heads on ``tp``
                 (replicated over ``tp`` when kv_dup > 1).
  optimizer    — same specs as the (FSDP-sharded) parameters.
Serving drops FSDP (params replicated over ``data``).

A :class:`Sharding` (the reference's ``NamedSharding``) turns its spec into
DTensor placements (``Shard(dim)`` on each mesh dim the spec names,
``Replicate()`` elsewhere), cuts a rank's local block out of a full tensor
(:meth:`Sharding.local`) and wraps a local block as a ``DTensor``
(:meth:`Sharding.place`).  Every split must be even.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import MeshPlan, ModelConfig

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a device mesh (the reference's ``NamedSharding``)."""

    mesh: DeviceMesh
    spec: tuple

    def _axis(self, name: str) -> tuple[int, int, int]:
        """(mesh dim, size, this rank's coordinate) of axis ``name``."""
        names = self.mesh.mesh_dim_names
        i = names.index(name)
        return i, self.mesh.size(i), int(self.mesh.get_coordinate()[i])

    @property
    def placements(self) -> tuple:
        names = self.mesh.mesh_dim_names
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            order = [names.index(n) for n in _names(entry)]
            if order != sorted(order):
                raise ValueError(f"spec {self.spec}: axes {entry} are not in "
                                 f"the mesh's order {names}")
            for i in order:
                out[i] = Shard(dim)
        return tuple(out)

    def shards(self, dim: int) -> int:
        """How many blocks tensor dim ``dim`` is cut into."""
        n = 1
        for name in _names(self.spec[dim] if dim < len(self.spec) else None):
            n *= self._axis(name)[1]
        return n

    def block(self, dim: int, length: int) -> tuple[int, int]:
        """``(start, size)`` of this rank's block of dim ``dim``."""
        idx, n = 0, 1
        for name in _names(self.spec[dim] if dim < len(self.spec) else None):
            _, sz, c = self._axis(name)
            idx, n = idx * sz + c, n * sz
        if length % n:
            raise ValueError(f"dim {dim} of length {length} does not split "
                             f"evenly over {self.spec[dim]} ({n} blocks)")
        return idx * (length // n), length // n

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor (a view)."""
        out = full
        for dim in range(min(len(self.spec), full.ndim)):
            start, sz = self.block(dim, full.shape[dim])
            if sz != full.shape[dim]:
                out = out.narrow(dim, start, sz)
        return out

    def place(self, local: torch.Tensor, shape) -> DTensor:
        """``local`` (this rank's block) as a DTensor of global ``shape``."""
        shape = torch.Size(shape)
        stride, step = [], 1
        for n in reversed(shape):  # contiguous strides, nothing allocated
            stride.insert(0, step)
            step *= max(n, 1)
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=shape,
                                  stride=tuple(stride))

    def distribute(self, full: torch.Tensor) -> DTensor:
        """The full tensor (the same on every rank) cut to this rank's
        block, in storage of its own (a view would keep the whole tensor
        alive on every rank), and wrapped; no communication."""
        block = self.local(full)
        block = (block.contiguous() if block is full
                 else block.clone(memory_format=torch.contiguous_format))
        return self.place(block, full.shape)


@dataclasses.dataclass(frozen=True)
class LogicalMesh:
    mesh: DeviceMesh
    plan: MeshPlan
    has_pod: bool

    @property
    def dp(self):  # batch axes
        return ("pod", "data") if self.has_pod else ("data",)

    def sharding(self, *spec) -> Sharding:
        return Sharding(self.mesh, tuple(spec))

    def size(self, name: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    def group(self, name: str):
        """The process group of mesh axis ``name`` (``None`` for one rank,
        where every collective is the identity)."""
        if self.size(name) == 1:
            return None
        return self.mesh.get_group(name)

    def coord(self, name: str) -> int:
        return int(self.mesh.get_coordinate()[
            self.mesh.mesh_dim_names.index(name)])


def derive_logical_mesh(production_mesh: DeviceMesh, plan: MeshPlan
                        ) -> LogicalMesh:
    """Reshape (pod?, data, model) ranks into (pod?, data, tp, sp)."""
    ranks = production_mesh.mesh
    has_pod = "pod" in production_mesh.mesh_dim_names
    model = ranks.shape[-1]
    if plan.tp * plan.sp != model:
        raise ValueError(f"tp*sp={plan.tp * plan.sp} != model axis {model}")
    new_shape = tuple(ranks.shape[:-1]) + (plan.tp, plan.sp)
    names = (("pod",) if has_pod else ()) + ("data", "tp", "sp")
    mesh = DeviceMesh(production_mesh.device_type, ranks.reshape(new_shape),
                      mesh_dim_names=names)
    return LogicalMesh(mesh=mesh, plan=plan, has_pod=has_pod)


# --------------------------------------------------------------------------- #
# Parameter specs by path rules
# --------------------------------------------------------------------------- #
def param_spec_for(
    path: str, shape: tuple[int, ...], cfg: ModelConfig, plan: MeshPlan,
    *, train: bool,
) -> tuple:
    """Rule table mapping a parameter path+shape to a partition spec.

    Leading stacked-layer dims (from scan-layers) are detected by rank vs the
    rule's expected rank and left unsharded.
    """
    fsdp = "data" if (train and plan.fsdp) else None
    tp = "tp" if plan.tp > 1 else None
    kv_shardable = (cfg.num_kv_heads % plan.tp == 0) if plan.tp > 1 else False

    def with_stack(rule: tuple, base_rank: int) -> tuple:
        extra = len(shape) - base_rank
        return tuple(([None] * extra) + list(rule))

    leaf = path.rsplit("/", 1)[-1]
    # ---- embedding / unembedding ----
    if leaf == "embedding":
        return (None, tp)  # rows local-gather, features tp-sharded
    if leaf == "lm_head":
        return (fsdp, tp)  # vocab tp-sharded => logits stay vocab-sharded
    # ---- attention ----
    if leaf in ("wq", "wqkv"):
        return with_stack((fsdp, tp), 2)
    if leaf in ("wk", "wv"):
        return with_stack((fsdp, tp if kv_shardable else None), 2)
    if leaf == "wo":
        return with_stack((tp, fsdp), 2)
    if leaf in ("bq", "bqkv"):
        return with_stack((tp,), 1)
    if leaf in ("bk", "bv"):
        return with_stack((tp if kv_shardable else None,), 1)
    # ---- dense MLP ----
    if leaf in ("w_gate", "w_up", "w_gate_up") and "moe" not in path:
        return with_stack((fsdp, tp), 2)
    if leaf == "w_down" and "moe" not in path:
        return with_stack((tp, fsdp), 2)
    # ---- MoE (experts on tp = ep axis; FSDP on d_model; router replicated
    #      so every (data, sp) cell routes its own tokens without a gather;
    #      F is NOT sp-sharded — sp ranks hold disjoint tokens) ----
    if "moe" in path:
        if leaf == "router":
            return with_stack((None, None), 2)
        if leaf in ("w_gate", "w_up"):
            return with_stack((tp, fsdp, None), 3)
        if leaf == "w_down":
            return with_stack((tp, None, fsdp), 3)
    # ---- Mamba2 ----
    if leaf in ("in_z", "in_x"):
        return with_stack((fsdp, tp), 2)
    if leaf == "in_BC":
        bc_shardable = (cfg.ssm_groups % plan.tp == 0) if plan.tp > 1 else False
        return with_stack((fsdp, tp if bc_shardable else None), 2)
    if leaf == "in_dt":
        return with_stack((fsdp, tp), 2)
    if leaf == "conv_x_w":
        return with_stack((None, tp), 2)
    if leaf in ("conv_x_b", "norm_w"):
        return with_stack((tp,), 1)
    if leaf in ("conv_BC_w",):
        return with_stack((None, None), 2)
    if leaf in ("conv_BC_b",):
        return with_stack((None,), 1)
    if leaf in ("A_log", "dt_bias", "D_skip"):
        return with_stack(("tp" if (plan.tp > 1 and shape[-1] % plan.tp == 0)
                           else None,), 1)
    if leaf == "out_proj":
        return with_stack((tp, fsdp), 2)
    # ---- norms, biases, scalars ----
    return tuple([None] * len(shape))


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict/list tree (paths join keys and
    list indices with ``/``); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
            for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def param_shardings(params_shape: Any, cfg: ModelConfig, lmesh: LogicalMesh,
                    *, train: bool) -> Any:
    """Tree of :class:`Sharding` matching a params (shape) tree — the
    port's unstacked per-layer tree, or the reference's stacked one."""

    def rule(path, leaf):
        return lmesh.sharding(*param_spec_for(path, _shape(leaf), cfg,
                                              lmesh.plan, train=train))

    return tree_map_with_path(rule, params_shape)


# --------------------------------------------------------------------------- #
# Activation / cache / batch specs
# --------------------------------------------------------------------------- #
def activation_rules(cfg: ModelConfig, lmesh: LogicalMesh,
                     *, kind: str, batch_shardable: bool = True
                     ) -> dict[str, Sharding]:
    """Role -> sharding map consumed by the models' ``constrain`` hooks.

    ``batch_shardable=False`` (e.g. long_500k's global_batch=1): the batch
    stays unsharded and decode caches shard their *sequence* over the
    otherwise-idle ``data`` axis.
    """
    dp = lmesh.dp if batch_shardable else None
    plan = lmesh.plan
    tp = "tp" if plan.tp > 1 else None
    sp = "sp" if plan.sp > 1 else None
    kv_tp = tp if (plan.tp > 1 and cfg.num_kv_heads % plan.tp == 0) else None
    sh = lmesh.sharding
    rules = {
        "act_btd": sh(dp, sp, None),
        "act_q": sh(dp, sp, tp, None),
        # KV sequence-replicated (the sp all-gather: context parallelism);
        # kv-heads tp-sharded when divisible, else replicated.
        "act_kv": sh(dp, None, kv_tp, None),
        "logits": sh(dp, sp, tp),
        "ssm_inner": sh(dp, None, tp),
        "ssm_bc": sh(dp, None, None),
    }
    if kind == "decode":
        # Cache layout: (batch, seq, kv, hd).  The sequence takes every axis
        # the other dims cannot use: sp always; tp when kv-heads are not
        # tp-shardable; data when the batch cannot shard.
        seq_axes = []
        if not batch_shardable:
            seq_axes += list(lmesh.dp)
        if kv_tp is None and tp:
            seq_axes.append(tp)
        if sp:
            seq_axes.append(sp)
        cache_seq = tuple(seq_axes) if seq_axes else None
        rules["cache_kv"] = sh(dp, cache_seq, kv_tp, None)
        rules["act_btd"] = sh(dp, None, None)
        rules["act_q"] = sh(dp, None, tp, None)
        rules["logits"] = sh(dp, None, tp)
    return rules


def batch_shardings(cfg: ModelConfig, lmesh: LogicalMesh, *, kind: str,
                    batch_shardable: bool = True) -> dict:
    dp = lmesh.dp if batch_shardable else None
    sp = "sp" if lmesh.plan.sp > 1 else None
    sh = lmesh.sharding
    if kind == "train":
        # leaves carry a leading microbatch dim: (n_micro, mb, seq)
        out = {
            "tokens": sh(None, dp, sp),
            "targets": sh(None, dp, sp),
            "mask": sh(None, dp, sp),
        }
        if cfg.family == "vlm":
            out["prefix_embeds"] = sh(None, dp, None, None)
        if cfg.family == "audio":
            out["src_embeds"] = sh(None, dp, sp, None)
        return out
    if kind == "prefill":
        out = {"tokens": sh(dp, sp)}
        if cfg.family == "vlm":
            out["prefix_embeds"] = sh(dp, None, None)
        if cfg.family == "audio":
            out["src_embeds"] = sh(dp, sp, None)
        return out
    if kind == "decode":
        return {"token": sh(dp)}
    raise ValueError(kind)


def cache_seq_axes(cfg: ModelConfig, lmesh: LogicalMesh,
                   batch_shardable: bool = True):
    """The axes a KV cache's sequence is split over (``None`` if none)."""
    plan = lmesh.plan
    tp = "tp" if plan.tp > 1 else None
    sp = "sp" if plan.sp > 1 else None
    kv_tp = tp if (plan.tp > 1 and cfg.num_kv_heads % plan.tp == 0) else None
    seq_axes = []
    if not batch_shardable:
        seq_axes += list(lmesh.dp)
    if kv_tp is None and tp:
        seq_axes.append(tp)
    if sp:
        seq_axes.append(sp)
    return tuple(seq_axes) if seq_axes else None


def cache_shardings(cfg: ModelConfig, lmesh: LogicalMesh, cache_shape: Any,
                    *, batch_shardable: bool = True) -> Any:
    """Shardings for a KV/SSM cache (shape) tree."""
    plan = lmesh.plan
    dp = lmesh.dp if batch_shardable else None
    tp = "tp" if plan.tp > 1 else None
    cache_seq = cache_seq_axes(cfg, lmesh, batch_shardable)
    kv_tp = tp if (plan.tp > 1 and cfg.num_kv_heads % plan.tp == 0) else None
    ssm_h_tp = tp if (plan.tp > 1 and cfg.family in ("ssm", "hybrid")
                      and cfg.ssm_heads % plan.tp == 0) else None
    sh = lmesh.sharding

    def rule(path, leaf):
        leaf_name = path.rsplit("/", 1)[-1]
        rank = len(_shape(leaf))
        base = {
            "k": (dp, cache_seq, kv_tp, None),
            "v": (dp, cache_seq, kv_tp, None),
            "xk": (dp, None, kv_tp, None),
            "xv": (dp, None, kv_tp, None),
            "pos": (),
            "conv_x": (dp, None, tp),
            "conv_BC": (dp, None, None),
            "ssm": (dp, ssm_h_tp, None, None),
        }.get(leaf_name)
        if base is None:
            return sh(*([None] * rank))
        extra = rank - len(base)  # stacked-layer leading dims
        return sh(*(([None] * extra) + list(base)))

    return tree_map_with_path(rule, cache_shape)


# --------------------------------------------------------------------------- #
# Fleet mesh
# --------------------------------------------------------------------------- #
def ensure_process_group(device="cuda") -> None:
    """A process with no process group is a world of one: start a one-rank
    group (gloo for the CPU, NCCL for the card) on an in-memory store."""
    if dist.is_initialized():
        return
    backend = "gloo" if str(device).startswith("cpu") else "nccl"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_fleet_mesh(num_fleet_shards: int | None = None,
                    model_shards: int = 1, *, device="cuda") -> DeviceMesh:
    """``(dp, mp)`` mesh for fleet-sharded federated rounds.

    The redco ``mesh_utils`` idiom: the process group's ranks reshaped to
    ``(ranks // model_shards, model_shards)`` with the axes named ``dp``
    (fleet shards — cohort rows and ``fed_reduce`` rows split here) and
    ``mp`` (intra-model shards).  ``num_fleet_shards=None`` uses every
    rank.  With no process group running, one is started with a single
    rank (:func:`ensure_process_group`).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_fleet_shards is None:
        if world % model_shards:
            raise ValueError(
                f"{world} devices not divisible by "
                f"model_shards={model_shards}")
        num_fleet_shards = world // model_shards
    need = num_fleet_shards * model_shards
    if need > world:
        raise ValueError(
            f"fleet mesh needs {need} devices, have {world}")
    ensure_process_group(device)
    dtype = "cpu" if str(device).startswith("cpu") else "cuda"
    if need == world:
        return init_device_mesh(dtype, (num_fleet_shards, model_shards),
                                mesh_dim_names=("dp", "mp"))
    ranks = torch.arange(need).reshape(num_fleet_shards, model_shards)
    return DeviceMesh(dtype, ranks, mesh_dim_names=("dp", "mp"))
