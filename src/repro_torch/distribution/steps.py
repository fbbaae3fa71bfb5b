"""Train, prefill and decode steps, on one card or sharded over a mesh.

``build_train_step(cfg, lmesh, shape, opt_cfg)`` keeps the reference's
signature (``src/repro/distribution/steps.py``) and semantics: a loop over
the step's microbatches adds each microbatch's gradients, cast to f32, into
one f32 buffer; the sum is divided by the microbatch count and AdamW
(``optim/optimizers.py``) updates the f32 master and the working params.
Each layer is rematerialized (``loss_fn(remat=True)``).  Under a profiler
each microbatch's forward and backward are ``train.forward`` and
``train.backward`` spans, AdamW ``train.optimizer`` (``runtime/tracing.py``);
the recomputed blocks, on the autograd engine's thread on a card, take the
waiting ``train.backward`` as their parent.

It returns ``(train_step, state_shape, batch_specs)``, not shardings:
``state_shape`` is the state's tree on the ``meta`` device (shapes and
dtypes, nothing allocated) and ``batch_specs`` maps each batch field to
``(shape, dtype)``.  ``train_step(state, batch)`` updates ``state`` in
place and returns it with ``{"loss", "lr", "grad_norm"}`` as 0-d tensors.

With ``lmesh=None`` the step runs on one device.  Each leaf's gradient is
added into the f32 buffer as soon as backward has produced it
(``Tensor.register_post_accumulate_grad_hook``) and then freed: the same
arithmetic as the reference's ``acc + g.astype(f32)`` without a whole bf16
gradient tree per microbatch.  The buffer lives with the step function
(``train_step.accumulator``), is zeroed at each step's start and serves as
AdamW's scratch.

With a :class:`~repro_torch.distribution.sharding.LogicalMesh` the state is
a tree of ``DTensor`` leaves placed by ``param_shardings`` (params, f32
master, m, v; the step counter replicated), made with
:func:`place_train_state`; the accumulator carries the same placements.
DTensor holds the placement; the math runs on each rank's local blocks
with explicit collectives (``distribution/collectives.py``), the way the
reference's ``shard_map`` regions do: DTensor's own sharding propagation
(torch 2.13) spent 60-150 s choosing a strategy for one matmul on a
three-axis mesh.  Every family runs tensor parallel, as the reference's
rules lay it out:

* Megatron-style column- and row-parallel products over ``tp`` (the
  models' ``constrain`` calls ``tp_in`` / ``tp_out``): attention on the
  rank's heads, the MLP on its block of ``d_ff``, the experts over ``tp``
  with an all-to-all (``moe_parallel.py``), the vocabulary over ``tp`` in
  the logits and the loss;
* the Mamba2 block on the rank's ``h / tp`` SSM heads (``in_z``, ``in_x``,
  ``in_dt``, ``conv_x``, ``A_log``, ``dt_bias``, ``D_skip``, ``norm_w``
  by heads, ``out_proj`` row-parallel); ``in_BC`` and its conv stay whole
  (one SSM group), their gradients, which cover the rank's heads only,
  summed over ``tp``; the gated norm's mean over ``d_inner`` is a sum of
  squares summed over ``tp`` (``norm_var``);
* the encoder-decoder's cross-attention column-parallel over a memory
  replicated over ``tp``;
* the sequence over ``sp`` with the k/v all-gather for the attention
  families (dense, MoE, VLM; a VLM rank takes its block of the prefix and
  the text together); the SSM, hybrid and audio layers run each ``sp``
  rank on the whole sequence.

FSDP weight blocks are all-gathered over ``data`` before the forward, the
gradients are reduce-scattered back to them (and all-reduced over the
batch axes where a weight is replicated), and AdamW's global norm is the
norm of the whole gradient.  The hand-written kernels take the rank's
plain tensors, as in the unsharded path.

``build_prefill_step`` and ``build_serve_step`` shard every family's
serving the same way, with the caches stored as ``cache_shardings`` says:
each rank keeps its cache blocks.  Where the cache's sequence is split over
ranks (``sp``, ``tp`` when kv heads are duplicated, ``data`` when the batch
cannot split), decode attention is flash-decoding across ranks: the decode
kernel's partial output (K2p, ``decode_attention_partial``) over the
rank's block, an all-reduce of the max and one of the rescaled ``(o, l)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig, padded_vocab
from repro_torch.distribution import collectives as cc
from repro_torch.distribution import sharding as shlib
from repro_torch.distribution.ctx import sharding_context
from repro_torch.distribution.moe_parallel import make_moe_sharded
from repro_torch.distribution.sharding import LogicalMesh, Sharding
from repro_torch.kernels.decode_attention.ops import decode_attention_partial
from repro_torch.models import encdec, hybrid, mamba2, transformer
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizers import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    opt_state_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import tracing


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Each batch field's ``(shape, dtype)``, leading ``(microbatches,
    per-microbatch batch)``, as the reference's ``train_batch_specs``."""
    n, mb = shape.microbatches, shape.global_batch // shape.microbatches
    s = shape.seq_len
    text = s - cfg.frontend_tokens if cfg.family == "vlm" else s
    specs = {
        "tokens": ((n, mb, text), torch.int32),
        "targets": ((n, mb, text), torch.int32),
        "mask": ((n, mb, text), torch.float32),
    }
    if cfg.family == "vlm":
        # Patch embeddings replace the first frontend_tokens positions.
        specs["prefix_embeds"] = ((n, mb, cfg.frontend_tokens, cfg.d_model),
                                  torch.bfloat16)
    if cfg.family == "audio":
        specs["src_embeds"] = ((n, mb, s, cfg.d_model), torch.bfloat16)
    return specs


def init_train_state(cfg: ModelConfig, seed: int = 0, *,
                     device="cuda") -> dict:
    """Seeded params (the model's ``init``) and their AdamW state."""
    params = get_model(cfg).init(seed, cfg, device=device)
    return {"params": params, "opt": adamw_init(params)}


def _model_module(cfg: ModelConfig):
    return {"audio": encdec, "ssm": mamba2, "hybrid": hybrid}.get(
        cfg.family, transformer)


def train_state_from_numpy(tree: dict, cfg: ModelConfig,
                           device="cuda") -> dict:
    """The reference's ``{"params", "opt"}`` train state (numpy leaves) as
    the port's (layer stacks unstacked)."""
    mod = _model_module(cfg)

    def convert(t, dev):
        return mod.params_from_numpy(t, cfg, dev)

    return {"params": convert(tree["params"], device),
            "opt": opt_state_from_numpy(tree["opt"], convert, device)}


# --------------------------------------------------------------------------- #
# Placement
# --------------------------------------------------------------------------- #
def _dp_size(lmesh: LogicalMesh) -> int:
    out = 1
    for a in lmesh.dp:
        out *= lmesh.size(a)
    return out


def _serve_weight_fsdp(cfg: ModelConfig, lmesh: LogicalMesh) -> bool:
    """ZeRO-inference: when tp-only weights exceed the HBM budget (16 GB
    v5e minus cache/temp headroom), shard serve weights over ``data`` too
    (phi3-medium at tp=2: 14.7 GB replicated -> 0.9 GB sharded)."""
    per_dev = 2.0 * cfg.num_params() / max(lmesh.plan.tp, 1)
    return per_dev > 12e9


def train_state_shardings(cfg: ModelConfig, lmesh: LogicalMesh,
                          state_shape: dict) -> dict:
    """The reference's state shardings: params, master, m and v by
    ``param_shardings(train=True)``, the step counter replicated."""
    pshard = shlib.param_shardings(state_shape["params"], cfg, lmesh,
                                   train=True)
    return {"params": pshard,
            "opt": {"master": pshard, "m": pshard, "v": pshard,
                    "step": lmesh.sharding()}}


def place(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` (full, the same on every rank) cut to
    this rank's block and wrapped as a ``DTensor`` with its sharding's
    placements; other leaves (a cache's ``pos``) pass through."""
    return tree_map(lambda t, s: s.distribute(t)
                    if isinstance(t, torch.Tensor) else t, tree, shardings)


def place_train_state(state: dict, cfg: ModelConfig, lmesh: LogicalMesh
                      ) -> dict:
    """A train state (``init_train_state`` or ``train_state_from_numpy``)
    placed on ``lmesh`` for ``build_train_step(cfg, lmesh, ...)``."""
    return place(state, train_state_shardings(cfg, lmesh, state))


def place_params(params: Any, cfg: ModelConfig, lmesh: LogicalMesh, *,
                 train: bool = False) -> Any:
    """Params (``init`` or ``params_from_numpy``) placed on ``lmesh``;
    serving (``train=False``) shards them over ``data`` only past the
    ``_serve_weight_fsdp`` budget, as the reference."""
    fsdp = train or _serve_weight_fsdp(cfg, lmesh)
    return place(params, shlib.param_shardings(params, cfg, lmesh,
                                               train=fsdp))


def gather(tree: Any) -> Any:
    """Every ``DTensor`` leaf as its full tensor (a collective: every rank
    calls it)."""
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def _local(x, sharding: Sharding):
    """This rank's block: a DTensor's local tensor, or the block of a full
    tensor that every rank holds."""
    if isinstance(x, DTensor):
        return x.to_local()
    return sharding.local(x)


# --------------------------------------------------------------------------- #
# The rank's view of one sharded step
# --------------------------------------------------------------------------- #
# Families whose layers run on a block of the sequence (the sp ranks hold
# different tokens, k and v all-gathered); the others' scans and
# cross-attention run each sp rank on the whole sequence.
_SEQ_SPLIT = ("dense", "moe", "vlm")


class _Shards:
    """Groups, coordinates and the ``constrain`` rules of one step."""

    def __init__(self, cfg: ModelConfig, lmesh: LogicalMesh, *, kind: str,
                 batch_shardable: bool = True):
        self.cfg, self.lmesh, self.kind = cfg, lmesh, kind
        plan = lmesh.plan
        self.batch_shardable = batch_shardable
        self.tp = plan.tp
        self.sp = plan.sp if (kind != "decode"
                              and cfg.family in _SEQ_SPLIT) else 1
        self.tp_group = lmesh.group("tp") if self.tp > 1 else None
        self.sp_group = lmesh.group("sp") if self.sp > 1 else None
        self.kv_shardable = plan.tp > 1 and cfg.num_kv_heads % plan.tp == 0
        # Axes whose ranks hold different tokens: their gradient partials sum.
        self.sum_axes = tuple(lmesh.dp if batch_shardable else ()) + (
            ("sp",) if self.sp > 1 else ())
        self.seq_start = 0
        H, KV = cfg.num_heads, cfg.num_kv_heads
        if self.tp > 1:
            t = lmesh.coord("tp")
            hl = H // self.tp
            self.q_heads = range(t * hl, (t + 1) * hl)
            self.kv_local = (range(t * KV // self.tp, (t + 1) * KV // self.tp)
                             if self.kv_shardable else range(KV))
            self.local_cfg = dataclasses.replace(
                cfg, num_heads=hl, num_kv_heads=len(self.kv_local))
            if cfg.family in ("ssm", "hybrid") and (
                    cfg.ssm_heads % self.tp or cfg.ssm_groups > 1):
                # in_BC stays whole for one group; more would need the
                # rank's groups picked out of B and C.
                raise ValueError(
                    f"{cfg.name}: tp={self.tp} needs ssm_heads "
                    f"({cfg.ssm_heads}) divisible by tp and one SSM group "
                    f"(has {cfg.ssm_groups})")
        else:
            self.q_heads, self.kv_local = range(H), range(KV)
            self.local_cfg = cfg

    # ---- groups ----
    def groups(self, axes) -> list:
        return [self.lmesh.group(a) for a in axes]

    def sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        for g in self.groups(axes):
            cc.all_reduce_(x, g)
        return x

    # ---- rules for the models' constrain calls ----
    def rules(self) -> dict:
        cfg, lm = self.cfg, self.lmesh
        rules: dict = dict(shlib.activation_rules(
            cfg, lm, kind=self.kind, batch_shardable=self.batch_shardable))
        if cfg.num_experts:
            rules["moe_impl"] = make_moe_sharded(
                cfg, lm, seq_sharded=self.kind != "decode",
                batch_shardable=self.batch_shardable)
        if self.kind == "train":
            rules["cross_entropy"] = self._cross_entropy
        D = cfg.d_model
        if self.tp > 1:
            tpg, tp = self.tp_group, self.tp
            rules["tp_in"] = lambda x: cc.copy_to(x, tpg)
            rules["tp_out"] = lambda x: cc.reduce_from(x, tpg)
            rules["act_btd"] = lambda x: (cc.gather_rep(x, tpg, -1)
                                          if x.shape[-1] != D else x)
            rules["unembed"] = self._unembed
            # The gated norm's mean over the whole d_inner: each rank's sum
            # of squares over its block, summed over tp.
            rules["norm_var"] = lambda xf: cc.psum(
                torch.sum(xf * xf, dim=-1, keepdim=True), tpg) / (
                    xf.shape[-1] * tp)
            if not self.kv_shardable:
                rules["kv_heads"] = self._kv_heads
        if self.sp > 1:
            rules["act_kv"] = lambda x: cc.gather_rs(x, self.sp_group, 1)
        rules["seq_offset"] = lambda: self.seq_start
        if self.kind != "train":
            rules.update(self._cache_rules())
        return rules

    def _kv_heads(self, k: torch.Tensor) -> torch.Tensor:
        """The kv heads of the rank's q heads (kv_dup > 1: every rank holds
        all kv heads, each q head h reads kv head h // (H / KV))."""
        G = self.cfg.num_heads // self.cfg.num_kv_heads
        idx = [h // G for h in self.q_heads]
        uniq = sorted(set(idx))
        hl = len(idx)
        if hl % len(uniq) == 0 and all(
                idx[i] == uniq[i // (hl // len(uniq))] for i in range(hl)):
            idx = uniq  # whole groups: q head i reads local kv i // (hl/n)
        return k.index_select(2, torch.tensor(idx, device=k.device))

    def _unembed(self, p, x):
        tpg = self.tp_group
        x = cc.copy_to(x, tpg)
        if "lm_head" in p:  # vocab-sharded logits
            return (x @ p["lm_head"]).float()
        # Tied: the embedding's feature block; partial logits summed.
        xs = cc.chunk_of(x, tpg, dim=-1)
        return cc.reduce_from(xs @ p["embedding"].T, tpg).float()

    def _vocab_parallel(self) -> bool:
        return self.tp > 1 and not self.cfg.tie_embeddings

    def _cross_entropy(self, logits, targets, mask, vocab_size):
        """Token mean over every rank's tokens: this rank's share (its
        summed nll over the global token count), which the step's sum
        over ``sum_axes`` completes."""
        logits = logits.float()
        den = self.sum_over(mask.sum().detach().clone(), self.sum_axes)
        v_local = logits.shape[-1]
        if self._vocab_parallel():
            tpg = self.tp_group
            start = self.lmesh.coord("tp") * v_local
            col = torch.arange(start, start + v_local, device=logits.device)
            logits = torch.where(col < vocab_size, logits, -1e30)
            m = logits.detach().amax(dim=-1)
            cc.all_reduce_(m, tpg, dist.ReduceOp.MAX)
            se = cc.reduce_from(torch.exp(logits - m[..., None]).sum(-1), tpg)
            lse = m + torch.log(se)
            t = targets.long() - start
            inside = (t >= 0) & (t < v_local)
            gold = torch.gather(logits, -1, t.clamp(0, v_local - 1)[..., None]
                                )[..., 0] * inside
            gold = cc.reduce_from(gold, tpg)
        else:
            if v_local > vocab_size:
                col = torch.arange(v_local, device=logits.device)
                logits = torch.where(col < vocab_size, logits, -1e30)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
        nll = (lse - gold) * mask
        return nll.sum() / torch.clamp_min(den, 1.0)

    # ---- serving caches ----
    def _cache_rules(self) -> dict:
        cfg, lm = self.cfg, self.lmesh
        seq_axes = shlib.cache_seq_axes(cfg, lm, self.batch_shardable)
        self.cache_axes = seq_axes or ()
        cache_sh = lm.sharding(None, None, seq_axes)

        def block(max_len):
            return cache_sh.block(2, max_len)

        def rows(max_len):
            self.max_len = max_len
            return block(max_len)[1]

        def fill(cache, k):
            start, size = block(self.max_len)
            n = max(0, min(k.shape[1] - start, size))
            if n:
                cache[:, :n] = k[:, start:start + n].to(cache.dtype)

        def write(cache, row, pos):
            start, size = block(self.max_len)
            if start <= pos < start + size:
                cache[:, pos - start] = row.to(cache.dtype)

        def last_position(x):
            if self.sp > 1:
                return cc.gather_rep(x[:, -1:], self.sp_group, 1)[:, -1]
            return x[:, -1]

        self.block = block
        rules = {"last_position": last_position}
        if seq_axes:
            rules.update(cache_rows=rows, cache_fill=fill, cache_write=write,
                         decode_attention=self._decode_attention,
                         cache_len=lambda: self.max_len)
        return rules

    def _decode_attention(self, q, k_cache, v_cache, pos, impl):
        """Attention over a cache whose sequence is split over ranks, the
        flash-decoding combine across them: K2p over the rank's block, the
        max of ``m`` all-reduced over the cache's axes (minor first), then
        one sum of ``l`` and ``o`` rescaled to that max, packed together;
        the division in f32.  Where kv heads are duplicated the sequence
        splits over ``tp`` too, and the tp ranks hold different query
        heads: each rank attends every head's query (all-gathered over
        ``tp``, ``b * H * d`` values) over its block, and keeps its heads of
        the combined output."""
        start, size = self.block(self.max_len)
        heads_split = "tp" in self.cache_axes
        if heads_split:
            q = cc.all_gather(q, self.tp_group, 1)
        b, d = q.shape[0], q.shape[-1]
        lengths = torch.full((b,), min(max(pos + 1 - start, 0), size),
                             dtype=torch.int32, device=q.device)
        o, m, l = decode_attention_partial(q, k_cache, v_cache, lengths,
                                           impl=impl)
        groups = self.groups(reversed(self.cache_axes))
        top = m.clone()
        for g in groups:
            cc.all_reduce_(top, g, dist.ReduceOp.MAX)
        w = torch.exp(m - top)
        packed = torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1)
        for g in groups:
            cc.all_reduce_(packed, g)
        out = packed[..., :d] / torch.clamp_min(packed[..., d:], 1e-37)
        if heads_split:
            out = cc.chunk_of(out, self.tp_group, 1)
        return out.to(q.dtype)

    # ---- params ----
    def local_param(self, leaf: torch.Tensor, sh: Sharding) -> torch.Tensor:
        """The param the rank's forward reads: its block, all-gathered over
        the FSDP ``data`` axis (a fresh tensor, or the DTensor's own
        block)."""
        local = leaf.to_local() if isinstance(leaf, DTensor) else sh.local(leaf)
        for a in sorted(self.gathered_axes(sh.spec)):
            dim = next(i for i, e in enumerate(sh.spec)
                       if a in shlib._names(e))
            local = cc.all_gather(local.detach(), self.lmesh.group(a), dim) \
                if self.lmesh.size(a) > 1 else local
        return local.detach()

    @staticmethod
    def gathered_axes(spec: tuple) -> set:
        """Mesh axes a param is all-gathered over before the forward."""
        return {a for e in spec for a in shlib._names(e)} & {"data"}

    def layout(self, params: Any) -> Any:
        """The tree the forward reads: fused projections cut to the rank's
        heads; weights replicated over tp whose gradients come back in tp
        partials (kv_dup's k and v, the SSM's in_BC and its conv, whose
        gradients cover the rank's heads only) summed in the backward."""
        if self.tp == 1:
            return params
        tpg, cfg = self.tp_group, self.cfg
        hd, H, KV = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads

        def cols(full, dim):
            q = [range(h * hd, (h + 1) * hd) for h in self.q_heads]
            k = [range((H + h) * hd, (H + h + 1) * hd) for h in self.kv_local]
            v = [range((H + KV + h) * hd, (H + KV + h + 1) * hd)
                 for h in self.kv_local]
            idx = [i for r in q + k + v for i in r]
            return full.index_select(dim, torch.tensor(idx,
                                                        device=full.device))

        def attn(p):
            p = dict(p)
            if "wqkv" in p:
                p["wqkv"] = cols(cc.gather_rs(p["wqkv"], tpg, 1), 1)
                if "bqkv" in p:
                    p["bqkv"] = cols(cc.gather_rs(p["bqkv"], tpg, 0), 0)
            elif not self.kv_shardable:
                for k in ("wk", "wv", "bk", "bv"):
                    if k in p:
                        p[k] = cc.copy_to(p[k], tpg)
            return p

        def mlp(p):
            p = dict(p)
            if "w_gate_up" in p:
                full = cc.gather_rs(p["w_gate_up"], tpg, 1)
                gate, up = torch.chunk(full, 2, dim=1)
                p["w_gate_up"] = torch.cat(
                    [cc.chunk_of(gate, tpg, 1), cc.chunk_of(up, tpg, 1)], 1)
            return p

        def layer(lp):
            lp = dict(lp)
            for k in ("attn", "cross"):
                if k in lp:
                    lp[k] = attn(lp[k])
            if "mlp" in lp:
                lp["mlp"] = mlp(lp["mlp"])
            for k in ("in_BC", "conv_BC_w", "conv_BC_b"):
                if k in lp:
                    lp[k] = cc.copy_to(lp[k], tpg)
            return lp

        out = dict(params)
        for k in ("layers", "mamba_layers", "encoder", "decoder"):
            if k in params:
                out[k] = [layer(lp) for lp in params[k]]
        if "shared_attn" in params:
            out["shared_attn"] = layer(params["shared_attn"])
        return out

    def reduce_grad(self, g: torch.Tensor, sh: Sharding) -> torch.Tensor:
        """A gathered param's summed gradient back to the param's block:
        summed over ``sum_axes`` (reduce-scattered over a gathered one),
        cut to the block over the other gathered axes."""
        gathered = self.gathered_axes(sh.spec)
        for a in self.sum_axes:
            if a not in gathered:
                cc.all_reduce_(g, self.lmesh.group(a))
        for a in sorted(gathered):
            dim = next(i for i, e in enumerate(sh.spec)
                       if a in shlib._names(e))
            grp = self.lmesh.group(a)
            g = (cc.reduce_scatter(g, grp, dim) if a in self.sum_axes
                 else cc.chunk_of(g, grp, dim).contiguous())
        return g

    def batch_local(self, batch: dict, shardings: dict) -> dict:
        """The rank's block of each batch field; sets ``seq_start``.  Where
        the sequence does not split (``self.sp == 1``) every sp rank takes
        it whole.  A VLM's sequence is the prefix, then the text: the rank
        takes its block of the two together."""
        vlm = self.cfg.family == "vlm"
        out = {}
        for k, v in batch.items():
            sh = shardings[k]
            if self.sp == 1 or vlm:
                sh = self.lmesh.sharding(*[
                    e if e is None or "sp" not in shlib._names(e) else None
                    for e in sh.spec])
            out[k] = _local(v, sh)
        if self.sp > 1:
            if vlm:
                out = self._prefix_block(out)
            else:
                self.seq_start = (self.lmesh.coord("sp")
                                  * out["tokens"].shape[-1])
        return out

    def _prefix_block(self, local: dict) -> dict:
        """The rank's block of ``cat(prefix_embeds, tokens)`` along the
        sequence: the prefix rows and the text rows (with their targets and
        mask) that fall in it."""
        F = local["prefix_embeds"].shape[-2]
        T = local["tokens"].shape[-1]
        if (F + T) % self.sp:
            raise ValueError(f"a sequence of {F} + {T} rows does not split "
                             f"over sp={self.sp}")
        size = (F + T) // self.sp
        start = self.seq_start = self.lmesh.coord("sp") * size
        p0, p1 = min(start, F), min(start + size, F)
        t0, t1 = max(start - F, 0), max(start + size - F, 0)
        out = dict(local)
        out["prefix_embeds"] = local["prefix_embeds"].narrow(-2, p0, p1 - p0)
        for k in ("tokens", "targets", "mask"):
            if k in local:
                out[k] = local[k].narrow(-1, t0, t1 - t0)
        return out


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #
def build_train_step(cfg: ModelConfig, lmesh, shape: ShapeConfig,
                     opt_cfg: AdamWConfig = AdamWConfig()):
    """``(train_step, state_shape, batch_specs)`` (see the module
    docstring); with a mesh, ``train_step.shardings`` holds the state's
    and the batch's shardings."""
    api = get_model(cfg)
    meta = torch.device("meta")
    pshape = api.init(0, cfg, device=meta)
    state_shape = {"params": pshape, "opt": adamw_init(pshape)}
    specs = train_batch_specs(cfg, shape)
    if lmesh is not None:
        if not isinstance(lmesh, LogicalMesh):
            raise TypeError(f"lmesh must be a LogicalMesh "
                            f"(derive_logical_mesh), got {type(lmesh)}")
        return (_sharded_train_step(cfg, lmesh, shape, opt_cfg, state_shape,
                                    specs), state_shape, specs)
    n = shape.microbatches

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        acc = train_step.accumulator
        if acc is None or any(a.shape != p.shape or a.device != p.device
                              for a, p in zip(tree_leaves(acc), leaves)):
            acc = train_step.accumulator = tree_map(
                lambda p: torch.empty(p.shape, dtype=torch.float32,
                                      device=p.device), params)
        for a in tree_leaves(acc):  # every step runs the same ops
            a.zero_()

        def fold(p, a):
            def hook(t):
                a.add_(t.grad)
                t.grad = None
            return p.register_post_accumulate_grad_hook(hook)

        hooks = [fold(p.requires_grad_(True), a)
                 for p, a in zip(leaves, tree_leaves(acc))]
        try:
            loss_sum = None
            for i in range(n):
                mb = {k: v[i] for k, v in batch.items()}
                with tracing.span("train.forward", microbatch=i):
                    loss, _ = api.loss_fn(params, mb, cfg)
                with tracing.span("train.backward", waits=True,
                                  microbatch=i):
                    loss.backward()
                loss = loss.detach()
                loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            for h in hooks:
                h.remove()
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        with torch.no_grad():
            for a in tree_leaves(acc):
                a.div_(n)
        with tracing.span("train.optimizer"):
            _, opt, om = adamw_update(opt_cfg, acc, state["opt"], params)
        state["opt"] = opt
        return state, {"loss": loss_sum / n, **om}

    train_step.accumulator = None
    return train_step, state_shape, specs


def _sharded_train_step(cfg, lmesh: LogicalMesh, shape: ShapeConfig,
                        opt_cfg: AdamWConfig, state_shape: dict,
                        specs: dict):
    api = get_model(cfg)
    n = shape.microbatches
    shards = _Shards(cfg, lmesh, kind="train")
    rules = shards.rules()
    state_sh = train_state_shardings(cfg, lmesh, state_shape)
    pshard = state_sh["params"]
    bshard = {k: v for k, v in shlib.batch_shardings(
        cfg, lmesh, kind="train").items() if k in specs}

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        p_leaves = tree_leaves(state["params"])
        shs = tree_leaves(pshard)
        if len(shs) != len(p_leaves):
            raise ValueError("state does not match the config's params")
        acc = train_step.accumulator
        if acc is None or any(
                a.to_local().shape != (p.to_local() if isinstance(p, DTensor)
                                       else p).shape
                for a, p in zip(tree_leaves(acc), p_leaves)):
            acc = train_step.accumulator = tree_map(
                lambda p, s: s.place(torch.empty(
                    _local(p, s).shape, dtype=torch.float32,
                    device=_local(p, s).device), p.shape),
                state["params"], pshard)
        a_leaves = [a.to_local() for a in tree_leaves(acc)]
        for a in a_leaves:
            a.zero_()
        # The forward's params: whole over their gathered axes; gradients
        # fold (f32) into a scratch of that shape.
        used = [shards.local_param(p, s) for p, s in zip(p_leaves, shs)]
        scratch = [a if u.shape == a.shape else
                   torch.zeros(u.shape, dtype=torch.float32, device=u.device)
                   for u, a in zip(used, a_leaves)]

        def fold(p, a):
            def hook(t):
                a.add_(t.grad)
                t.grad = None
            return p.register_post_accumulate_grad_hook(hook)

        hooks = [fold(u.requires_grad_(True), s)
                 for u, s in zip(used, scratch)]
        local_batch = shards.batch_local(batch, bshard)
        params_tree = _unflatten(state["params"], used)
        try:
            loss_sum = None
            with sharding_context(rules):
                for i in range(n):
                    mb = {k: v[i] for k, v in local_batch.items()}
                    with tracing.span("train.forward", microbatch=i):
                        loss, _ = api.loss_fn(shards.layout(params_tree), mb,
                                              shards.local_cfg)
                    with tracing.span("train.backward", waits=True,
                                      microbatch=i):
                        loss.backward()
                    loss = loss.detach()
                    loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            for h in hooks:
                h.remove()
            for u in used:
                u.requires_grad_(False)
                u.grad = None
        with torch.no_grad():
            for s, a, sh in zip(scratch, a_leaves, shs):
                g = shards.reduce_grad(s, sh)
                if g is not a:
                    a.copy_(g)
                a.div_(n)
            gnorm = _global_norm(a_leaves, shs, lmesh)
            opt = state["opt"]
            local_opt = {k: tree_map(lambda t: t.to_local(), opt[k])
                         for k in ("master", "m", "v")}
            local_opt["step"] = opt["step"].to_local().clone()
            local_params = tree_map(lambda t: t.to_local(), state["params"])
            with tracing.span("train.optimizer"):
                _, new_opt, om = adamw_update(
                    opt_cfg, _unflatten(state["params"], a_leaves), local_opt,
                    local_params, grad_norm=gnorm)
            opt["step"].to_local().copy_(new_opt["step"])
            loss = shards.sum_over(loss_sum / n, shards.sum_axes)
        return state, {"loss": loss, **om}

    train_step.accumulator = None
    train_step.shardings = (state_sh, bshard)
    return train_step


def _unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    return build(like)


def _global_norm(leaves: list, shs: list, lmesh: LogicalMesh) -> torch.Tensor:
    """The whole gradient's norm from the rank's blocks: each leaf's sum of
    squares summed over the axes its blocks split it along (one all-reduce
    per axis), then the leaves' sums added in tree order, as
    ``optimizers.global_norm`` adds them (bitwise equal on one rank)."""
    sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                      for g in leaves])
    axes = [{a for e in sh.spec for a in shlib._names(e)} for sh in shs]
    for a in lmesh.mesh.mesh_dim_names:
        group = lmesh.group(a)
        if group is None:
            continue
        split = torch.tensor([a in ax for ax in axes], device=sq.device)
        part = torch.where(split, sq, 0.0)
        cc.all_reduce_(part, group)
        sq = torch.where(split, part, sq)
    total = None
    for x in sq.unbind():
        total = x if total is None else total + x
    return torch.sqrt(total)


# --------------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------------- #
def serve_cache_shape(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """The serving cache's tree on the ``meta`` device."""
    api = get_model(cfg)
    b = shape.global_batch
    meta = torch.device("meta")
    if cfg.family == "audio":
        return api.init_cache(cfg, b, shape.seq_len, shape.seq_len,
                              device=meta)
    return api.init_cache(cfg, b, shape.seq_len, device=meta)


def _serve_params(shards: _Shards, params, pshard):
    used = [shards.local_param(p, s) for p, s in
            zip(tree_leaves(params), tree_leaves(pshard))]
    return shards.layout(_unflatten(params, used))


def _cache_in(caches, cshard):
    """The rank's cache blocks."""
    return tree_map(lambda v, sh: _local(v, sh)
                    if isinstance(v, torch.Tensor) else v, caches, cshard)


def _cache_out(cache, cshard, cshape):
    """The step's cache blocks as DTensors of the cache shardings."""
    return tree_map(lambda v, sh, meta: sh.place(v, meta.shape)
                    if isinstance(v, torch.Tensor) else v,
                    cache, cshard, cshape)


def _logits_out(shards: _Shards, logits, logit_shard: Sharding, b: int):
    """Last-position logits as a DTensor (batch over dp, vocab over tp):
    where every tp rank holds the whole vocabulary (tied embeddings) it
    keeps its block."""
    if logit_shard.shards(1) > 1 and logits.shape[-1] == padded_vocab(
            shards.cfg.vocab_size):
        logits = cc.chunk_of(logits, shards.lmesh.group("tp"),
                             -1).contiguous()
    return logit_shard.place(logits, (b, logits.shape[-1]
                                      * logit_shard.shards(1)))


def build_serve_step(cfg: ModelConfig, lmesh, shape: ShapeConfig):
    """One-token decode step: ``(params, caches, token) -> (logits,
    caches)``; returns ``(serve_step, (param, cache, token) shardings,
    (logit, cache) shardings, (params, cache, token) shapes)`` as the
    reference.  ``params`` and ``caches`` are DTensor trees (or full
    tensors that every rank holds); the logits come back as a DTensor
    (batch over dp, vocab over tp), the caches as DTensors of the cache
    shardings (the tensor-parallel families' share the rank's blocks,
    updated in place)."""
    api = get_model(cfg)
    bs = shape.global_batch % _dp_size(lmesh) == 0
    shards = _Shards(cfg, lmesh, kind="decode", batch_shardable=bs)
    rules = shards.rules()
    pshape = api.init(0, cfg, device=torch.device("meta"))
    pshard = shlib.param_shardings(pshape, cfg, lmesh,
                                   train=_serve_weight_fsdp(cfg, lmesh))
    cshape = serve_cache_shape(cfg, shape)
    cshard = shlib.cache_shardings(cfg, lmesh, cshape, batch_shardable=bs)
    tshard = shlib.batch_shardings(cfg, lmesh, kind="decode",
                                   batch_shardable=bs)["token"]
    logit_shard = lmesh.sharding(lmesh.dp if bs else None,
                                 "tp" if lmesh.plan.tp > 1 else None)
    shards.max_len = shape.seq_len

    def serve_step(params, caches, token):
        local_params = _serve_params(shards, params, pshard)
        cache = _cache_in(caches, cshard)
        with torch.no_grad(), sharding_context(rules):
            logits, cache = api.decode_step(local_params,
                                            _local(token, tshard),
                                            shards.local_cfg, cache)
        return (_logits_out(shards, logits, logit_shard, shape.global_batch),
                _cache_out(cache, cshard, cshape))

    token_spec = ((shape.global_batch,), torch.int32)
    return serve_step, (pshard, cshard, tshard), (logit_shard, cshard), (
        pshape, cshape, token_spec)


def build_prefill_step(cfg: ModelConfig, lmesh, shape: ShapeConfig):
    """Full-sequence prefill: ``(params, inputs...) -> (last logits,
    caches)`` with the reference's inputs (``src_embeds, tokens`` for the
    audio family, ``tokens, prefix_embeds`` for the VLM, else
    ``tokens``); returns ``(prefill_step, in shardings, out shardings,
    input shapes)`` as the reference (see :func:`build_serve_step` for the
    trees)."""
    api = get_model(cfg)
    shards = _Shards(cfg, lmesh, kind="prefill")
    rules = shards.rules()
    b, s = shape.global_batch, shape.seq_len
    pshape = api.init(0, cfg, device=torch.device("meta"))
    pshard = shlib.param_shardings(pshape, cfg, lmesh,
                                   train=_serve_weight_fsdp(cfg, lmesh))
    bsh = shlib.batch_shardings(cfg, lmesh, kind="prefill")
    logit_shard = lmesh.sharding(lmesh.dp,
                                 "tp" if lmesh.plan.tp > 1 else None)
    cshape = serve_cache_shape(cfg, shape)
    cshard = shlib.cache_shardings(cfg, lmesh, cshape)
    if cfg.family == "audio":
        names = ("src_embeds", "tokens")
        inputs = (((b, s, cfg.d_model), torch.bfloat16), ((b, s), torch.int32))
    elif cfg.family == "vlm":
        names = ("tokens", "prefix_embeds")
        inputs = (((b, s - cfg.frontend_tokens), torch.int32),
                  ((b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16))
    else:
        names = ("tokens",)
        inputs = (((b, s), torch.int32),)
    in_batch = tuple(bsh[n] for n in names)

    def prefill_step(params, *args):
        local_params = _serve_params(shards, params, pshard)
        local = shards.batch_local(dict(zip(names, args)), bsh)
        kw = ({"prefix_embeds": local["prefix_embeds"]}
              if cfg.family == "vlm" else {})
        lead = (local["src_embeds"],) if cfg.family == "audio" else ()
        with torch.no_grad(), sharding_context(rules):
            logits, cache = api.prefill(local_params, *lead, local["tokens"],
                                        shards.local_cfg, s, **kw)
        return (_logits_out(shards, logits, logit_shard, b),
                _cache_out(cache, cshard, cshape))

    return prefill_step, (pshard,) + in_batch, (logit_shard, cshard), (
        pshape,) + inputs
