"""Expert-parallel MoE with an explicit all-to-all (``torch.distributed``).

The production formulation dispatches **per data-shard**: each
``(data, sp)`` cell routes its local tokens with a local capacity, and the
token<->expert shuffle is an explicit ``all_to_all`` over the ``tp`` (=
expert parallel) group, as the reference's ``shard_map`` body
(``src/repro/distribution/moe_parallel.py``).  Routing is the port's
``models/moe.py::route``, so expert choices, capacity and the overflow slot
are the reference's.

The block runs on the rank's shards as plain tensors: ``x`` is its
``(batch, seq)`` block (replicated over ``tp``), the expert weights its
``E / tp`` experts.  In training the sharded step all-gathers the FSDP
weight shards over ``data`` before the forward (the reference gathers them
inside the region) and reduce-scatters their gradients after it.
Gradients flow through the all-to-all (its own inverse), the tp split of
the tokens (each rank's gradient reaches ``x`` through an all-reduce over
``tp``) and the router (replicated, so its tp partials are summed the
same way).  ``aux`` is the mean over every ``(data, sp, tp)`` cell of
the cells' Switch losses, as the reference's ``pmean``; the block returns
this rank's share of it, ``sum_tp(aux_cell) / cells``, which the step's
sum over the batch groups completes.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import collectives as cc
from repro_torch.distribution.sharding import LogicalMesh
from repro_torch.models.moe import _experts, route


def _local_moe(p: Any, x: torch.Tensor, cfg: ModelConfig, *, ep_group,
               split_tokens: bool, cells: int):
    """The block on the rank's shards: returns ``(y, aux share)``."""
    ep = cc.size(ep_group)
    router = p["router"]
    if split_tokens and ep > 1:
        # Tokens shard over every axis taking part in expert parallelism:
        # the rank keeps its tp chunk of the sequence.
        x = cc.chunk_of(cc.copy_to(x, ep_group), ep_group, dim=1)
        router = cc.copy_to(router, ep_group)
    b, s, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    xt = x.reshape(b * s, D)
    r = route(router, xt, cfg)
    C = r.capacity
    tok = torch.arange(b * s * K, device=x.device) // K
    # Scatter dispatch into (E, C + 1, D); row C is the overflow slot.
    ein = torch.zeros((E, C + 1, D), dtype=x.dtype, device=x.device)
    ein = ein.index_put((r.expert, r.slot), xt[tok])[:, :C]
    if ep > 1:
        # (E, C, D) -> (E/ep, C*ep, D): experts scatter, token slots gather.
        ein = cc.all_to_all(ein.reshape(ep, E // ep, C, D), ep_group)
        ein = ein.permute(1, 0, 2, 3).reshape(E // ep, ep * C, D)
    eout = _experts(p, ein, cfg, x.dtype)
    if ep > 1:
        eout = eout.reshape(E // ep, ep, C, D).permute(1, 0, 2, 3)
        eout = cc.all_to_all(eout, ep_group).reshape(E, C, D)
    rows = (eout[r.expert, r.slot.clamp_max(C - 1)].float()
            * r.gate.to(x.dtype).float()[:, None])
    y = rows.reshape(b * s, K, D).sum(dim=1).to(x.dtype).reshape(b, s, D)
    aux = r.aux_loss
    if split_tokens and ep > 1:
        y = cc.gather_rep(y, ep_group, dim=1)
        aux = cc.reduce_from(aux, ep_group)
    return y, aux / cells


def make_moe_sharded(cfg: ModelConfig, lmesh: LogicalMesh, *,
                     seq_sharded: bool = True, batch_shardable: bool = True):
    """Returns a drop-in replacement for ``models.moe.moe_apply`` over the
    rank's shards.

    ``seq_sharded=False`` for decode (seq=1 cannot shard over sp; every tp
    rank routes the same tokens); ``batch_shardable=False`` when
    global_batch < the dp axis size.
    """
    plan = lmesh.plan
    if plan.tp > 1 and cfg.num_experts % plan.tp != 0:
        raise ValueError(
            f"{cfg.name}: experts {cfg.num_experts} not divisible by tp={plan.tp}"
        )
    ep_group = lmesh.group("tp")
    cells = plan.sp * (plan.tp if seq_sharded else 1)
    if batch_shardable:
        for a in lmesh.dp:
            cells *= lmesh.size(a)
    split = seq_sharded and plan.tp > 1

    def moe_apply_sharded(p: Any, x: torch.Tensor, cfg_: ModelConfig):
        return _local_moe(p, x, cfg, ep_group=ep_group, split_tokens=split,
                          cells=cells)

    return moe_apply_sharded
