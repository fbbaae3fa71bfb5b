"""Slot-based continuous-batching decode engine over a KV-cache arena.

The fixed-batch server (``launch.serve.BatchedServer``) couples every
request's latency to its batch-mates: a request that lands just after a
batch fires waits a full batch-fill interval, and off-peak traffic strands
sub-batch residuals.  Continuous batching decouples them:

* ``init_arena`` allocates a fixed-capacity KV-cache *arena* — one stacked
  ``(num_layers, slots, max_len, kv, head_dim)`` tensor per K and V — plus
  one per-slot ``lengths`` counter.  A slot IS a request's cache residency
  for its whole lifetime.
* ``arena_prefill`` runs the full-sequence forward for newly admitted
  prompts (the flash-attention kernel on a card) and scatters their K/V
  rows into freed slots, in place.  The call is padded to one shape;
  out-of-range slot ids mark padding rows whose writes drop
  (``kernels.decode_attention.ops`` slot helpers).
* ``arena_decode`` advances every active slot one token: per-slot RoPE
  positions, per-slot ragged cache writes, and ragged-``lengths`` attention
  through ``kernels.decode_attention`` (the decode kernel on a card).
  Slots at different sequence positions decode together.
* ``ContinuousBatchingEngine`` is the host-side slot manager: finished
  requests retire their slot at the iteration end, queued requests prefill
  into freed slots at the next iteration boundary.  Scheduling never needs
  token *values* (greedy decode to a fixed budget), so the decode loop runs
  without a host sync: token tensors are stacked and fetched once, at
  report time.
* ``ContinuousServer`` adapts the engine to DeviceFlow's delivery callback
  on the shared ``VirtualClock``.  Service time comes from a deterministic
  ``ServeCostModel`` charged identically to both serving modes, so latency
  comparisons measure *scheduling*, not host wall-clock noise.  Wall-clock
  timing of the card's work lives outside ``core`` (``chip_smoke.py``).

Stale-KV safety: a reused slot's rows beyond the new prompt keep the retired
request's K/V, but the slot's length counter is reset at prefill and only
ever covers rows the current occupant wrote — attention masks the rest.

An MoE config routes each layer's tokens through ``models/moe.py``; the
capacity counts every row of the call (idle slots and padding rows
included), as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.analysis.sanitizers import hot_path
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    scatter_decode_token,
    scatter_prefill_rows,
    slot_sources,
)
from repro_torch.models.layers import (
    _attend,
    _project_qkv,
    embed_apply,
    rmsnorm,
    rope,
    unembed_apply,
)
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import dtype_of, ffn_apply

__all__ = [
    "ServeCostModel",
    "RequestRecord",
    "IterationStats",
    "ServingReport",
    "ContinuousBatchingEngine",
    "ContinuousServer",
    "init_arena",
    "arena_prefill",
    "arena_decode",
]


# The encoder-decoder family has no serving path in either package (the
# reference's server calls its prefill without the source frames).
NO_ENCDEC_SERVING = (
    "family 'audio' has no serving path: {} needs source frames, which no "
    "request carries; drive models.encdec.prefill and decode_step directly")


# --------------------------------------------------------------------------- #
# Virtual-time cost model + request accounting
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ServeCostModel:
    """Deterministic virtual-time cost of one serving dispatch.

    A prefill over ``m`` prompts costs ``prefill_base_s + m *
    prefill_per_req_s``; one decode iteration over ``n`` active sequences
    costs ``decode_base_s + n * decode_per_slot_s``.  Charged from the same
    model to the fixed-batch and continuous servers, so their virtual-time
    latency difference is purely the batching policy.
    """

    prefill_base_s: float = 4e-3
    prefill_per_req_s: float = 1e-3
    decode_base_s: float = 1.5e-3
    decode_per_slot_s: float = 2.5e-4

    def prefill_s(self, n_requests: int) -> float:
        if n_requests <= 0:
            return 0.0
        return self.prefill_base_s + n_requests * self.prefill_per_req_s

    def decode_s(self, n_active: int) -> float:
        if n_active <= 0:
            return 0.0
        return self.decode_base_s + n_active * self.decode_per_slot_s


@dataclasses.dataclass
class RequestRecord:
    """One request's serving timeline + greedy-decoded tokens."""

    request_id: int
    arrival_t: float
    prompt: np.ndarray | None = None
    start_t: float | None = None  # admission (prefill begins)
    first_token_t: float | None = None  # prefill completes → first token
    finish_t: float | None = None
    slot: int | None = None
    decoded: int = 0  # decode-step tokens produced (excludes prefill token)
    tokens: list[int] = dataclasses.field(default_factory=list)

    @property
    def latency_s(self) -> float | None:
        return None if self.finish_t is None else self.finish_t - self.arrival_t

    @property
    def ttft_s(self) -> float | None:
        return (None if self.first_token_t is None
                else self.first_token_t - self.arrival_t)


@dataclasses.dataclass(frozen=True)
class IterationStats:
    """One engine iteration: when it ran, what it admitted/decoded."""

    t: float
    duration_s: float
    admitted: int
    n_active: int  # slots decoding this iteration (occupancy)
    queue_depth: int  # requests still waiting after admission


@dataclasses.dataclass
class ServingReport:
    """Latency/goodput rollup over a set of ``RequestRecord``s."""

    records: list[RequestRecord]
    horizon_s: float  # virtual span the run covered (goodput denominator)

    def finished(self) -> list[RequestRecord]:
        return [r for r in self.records if r.finish_t is not None]

    def _pct(self, values: list[float], q: float) -> float:
        return float(np.percentile(np.asarray(values), q)) if values else 0.0

    @property
    def p50_latency_s(self) -> float:
        return self._pct([r.latency_s for r in self.finished()], 50.0)

    @property
    def p99_latency_s(self) -> float:
        return self._pct([r.latency_s for r in self.finished()], 99.0)

    @property
    def p50_ttft_s(self) -> float:
        return self._pct([r.ttft_s for r in self.records
                          if r.first_token_t is not None], 50.0)

    @property
    def p99_ttft_s(self) -> float:
        return self._pct([r.ttft_s for r in self.records
                          if r.first_token_t is not None], 99.0)

    def goodput_rps(self, slo_s: float) -> float:
        """Finished requests meeting the latency SLO, per virtual second."""
        ok = sum(1 for r in self.finished() if r.latency_s <= slo_s)
        return ok / self.horizon_s if self.horizon_s > 0 else 0.0

    def summary(self, slo_s: float) -> dict:
        fin = self.finished()
        return {
            "requests": len(self.records),
            "finished": len(fin),
            "p50_latency_s": self.p50_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "p50_ttft_s": self.p50_ttft_s,
            "p99_ttft_s": self.p99_ttft_s,
            "goodput_rps": self.goodput_rps(slo_s),
            "slo_s": slo_s,
            "slo_attainment": (sum(1 for r in fin if r.latency_s <= slo_s)
                               / len(fin)) if fin else 0.0,
            "horizon_s": self.horizon_s,
        }


# --------------------------------------------------------------------------- #
# KV arena + arena ops
# --------------------------------------------------------------------------- #
def init_arena(cfg: ModelConfig, slots: int, max_len: int, *,
               device="cuda") -> dict:
    """Fixed-capacity KV arena: ``{"kv": {"k", "v"}, "lengths"}`` with
    ``(num_layers, slots, max_len, kv, hd)`` caches and one per-slot int32
    ``lengths`` counter (0 = empty/retired slot)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, slots, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
                   "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev)},
            "lengths": torch.zeros((slots,), dtype=torch.int32, device=dev)}


def _greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return torch.argmax(logits[:, : cfg.vocab_size], dim=-1).to(torch.int32)


def arena_prefill(params, tokens: torch.Tensor, slot_ids: torch.Tensor,
                  arena: dict, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, dict]:
    """Prefill admitted prompts into their arena slots.

    ``tokens`` is ``(m, s) int32`` and ``slot_ids`` ``(m,) int32``; rows with
    ``slot_ids[i] >= slots`` are padding (computed, then dropped), so every
    call has one shape however many requests joined this iteration.  The
    K/V rows land in the arena in place.  Returns ``(first greedy token (m,)
    int32, arena')`` — the prefill's last-position logits already yield each
    request's first token.
    """
    x = embed_apply(params["embed"], tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    kv = arena["kv"]
    for i, lp in enumerate(params["layers"]):
        hn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], hn, cfg)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        o = _attend(q, k, v, cfg, causal=True)
        x = x + o.reshape(b, s, -1) @ lp["attn"]["wo"]
        hn = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        scatter_prefill_rows(kv["k"][i], k, slot_ids)
        scatter_prefill_rows(kv["v"][i], v, slot_ids)
        x = x + ffn_apply(lp, hn, cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    tok = _greedy(unembed_apply(params["embed"], x[:, -1]), cfg)
    lengths = arena["lengths"]
    lengths = torch.where(slot_sources(slot_ids, lengths.shape[0]) >= 0, s,
                          lengths)
    return tok, {"kv": kv, "lengths": lengths}


def arena_decode(params, tok: torch.Tensor, active: torch.Tensor,
                 arena: dict, cfg: ModelConfig, *, attn_impl: str = "auto",
                 block_k: "int | None" = None) -> tuple[torch.Tensor, dict]:
    """One decode iteration across every arena slot.

    ``tok`` is ``(slots,) int32`` — each slot's last token; ``active`` is
    ``(slots,) bool``.  Active slots write K/V at their own cache position
    (in place) and attend over their own ragged length; inactive slots
    neither write nor advance (their held token is passed through).  Per-row
    math is the fixed-batch ``layers.attention_decode`` path's, which is
    what makes continuous batching token-identical to the fixed reference.
    ``attn_impl``/``block_k`` go to ``decode_attention`` (``"auto"``: the
    kernel on a card, the plain version on the CPU).
    """
    slots = tok.shape[0]
    lengths = arena["lengths"]
    kv = arena["kv"]
    max_len = kv["k"].shape[2]
    x = embed_apply(params["embed"], tok[:, None])  # (slots, 1, d)
    pos2d = lengths[:, None]  # per-slot RoPE position for the new token
    write_pos = torch.where(active, lengths, max_len)  # out of range: drops
    lens_att = lengths + active.to(torch.int32)
    for i, lp in enumerate(params["layers"]):
        hn = rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], hn, cfg)  # (slots, 1, heads, hd)
        q = rope(q, pos2d, cfg.rope_theta)
        k = rope(k, pos2d, cfg.rope_theta)
        kc = scatter_decode_token(kv["k"][i], k[:, 0], write_pos)
        vc = scatter_decode_token(kv["v"][i], v[:, 0], write_pos)
        o = decode_attention(q[:, 0].contiguous(), kc, vc, lens_att,
                             impl=attn_impl, block_k=block_k)
        x = x + o.reshape(slots, 1, -1) @ lp["attn"]["wo"]
        hn = rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn_apply(lp, hn, cfg)
    x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
    nxt = _greedy(unembed_apply(params["embed"], x[:, 0]), cfg)
    nxt = torch.where(active, nxt, tok)
    return nxt, {"kv": kv, "lengths": lengths + active.to(torch.int32)}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  Bound for a card it goes
    through a fresh pinned buffer without blocking the host (the caching
    host allocator keeps the buffer until the copy has run)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


# --------------------------------------------------------------------------- #
# Engine: host-side slot manager
# --------------------------------------------------------------------------- #
class ContinuousBatchingEngine:
    """Iteration-at-a-time continuous batching over the KV arena.

    Each ``step(t)``: (1) admit queued requests into free slots and prefill
    them (one padded call), (2) run one ``arena_decode`` over all active
    slots, (3) retire slots whose request hit its decode budget.  The loop
    never syncs token values — greedy decode to a fixed budget makes
    scheduling token-value-independent, so the device token tensors are
    stacked and fetched once at report time (``simulate_only=True`` skips
    model compute entirely for million-request capacity studies).
    """

    def __init__(self, cfg: "ModelConfig | None" = None, *, slots: int,
                 prompt_len: int, decode_tokens: int,
                 max_len: "int | None" = None, seed: int = 0,
                 cost_model: "ServeCostModel | None" = None,
                 attn_impl: str = "auto", block_k: "int | None" = None,
                 simulate_only: bool = False, params: Any = None,
                 device="cuda"):
        if slots < 1:
            raise ValueError("need at least one slot")
        if decode_tokens < 1:
            raise ValueError("decode_tokens must be >= 1")
        self.cfg = cfg
        self.slots = slots
        self.prompt_len = prompt_len
        self.decode_tokens = decode_tokens
        self.max_len = max_len or (prompt_len + decode_tokens + 1)
        self.cost = cost_model or ServeCostModel()
        self.simulate_only = simulate_only
        self.attn_impl = attn_impl
        self.block_k = block_k
        self.device = None
        if not simulate_only:
            if cfg is None:
                raise ValueError("cfg required unless simulate_only=True")
            if cfg.family in ("ssm", "hybrid"):
                # The arena holds attention K/V only (as in the reference,
                # which fails at its first step for these families).
                raise ValueError(
                    f"family {cfg.family!r} has no attention arena: serve "
                    f"{cfg.name} with launch.serve.BatchedServer")
            if cfg.family == "audio":
                raise ValueError(NO_ENCDEC_SERVING.format(cfg.name))
            api = get_model(cfg)
            if api.prefill is None or api.decode_step is None:
                raise ValueError(f"family {cfg.family!r} has no serving path")
            self.device = resolve_device(device)
            self.params = (params if params is not None
                           else api.init(seed, cfg, device=self.device))
            self.arena = init_arena(cfg, slots, self.max_len,
                                    device=self.device)
            self._tok = torch.zeros((slots,), dtype=torch.int32,
                                    device=self.device)
        self.queue: collections.deque[RequestRecord] = collections.deque()
        self.records: list[RequestRecord] = []
        self.slot_owner: list[RequestRecord | None] = [None] * slots
        self._free = list(range(slots))
        heapq.heapify(self._free)
        self.busy_until = 0.0
        self.iterations: list[IterationStats] = []
        # Deferred token materialization: (kind, owners, device (slots,) i32).
        self._events: list[tuple[str, list, torch.Tensor]] = []

    # -- request intake ------------------------------------------------------
    def submit(self, request_id: int, prompt: "np.ndarray | None",
               t: float) -> RequestRecord:
        if not self.simulate_only:
            prompt = np.asarray(prompt, np.int32)[: self.prompt_len]
        rec = RequestRecord(request_id=request_id, arrival_t=t, prompt=prompt)
        self.queue.append(rec)
        self.records.append(rec)
        return rec

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(o is not None for o in self.slot_owner)

    @property
    def n_active(self) -> int:
        return sum(o is not None for o in self.slot_owner)

    # -- one iteration -------------------------------------------------------
    @hot_path
    def step(self, t: float) -> float:
        """Run one iteration starting at virtual time ``t``; returns its
        duration (cost-model virtual seconds).

        ``@hot_path``: the loop must never sync the host per iteration —
        token materialization is deferred to :meth:`_materialize_tokens`
        (one sync for the whole run), and every host-to-card copy here goes
        through pinned memory without blocking.
        """
        admitted: list[RequestRecord] = []
        while self.queue and self._free:
            slot = heapq.heappop(self._free)
            rec = self.queue.popleft()
            rec.slot = slot
            rec.start_t = t
            self.slot_owner[slot] = rec
            admitted.append(rec)
        dur = 0.0
        if admitted:
            dur += self.cost.prefill_s(len(admitted))
            for rec in admitted:
                rec.first_token_t = t + dur
            if not self.simulate_only:
                toks = np.zeros((self.slots, self.prompt_len), np.int32)
                sids = np.full((self.slots,), self.slots, np.int32)
                for i, rec in enumerate(admitted):
                    toks[i, : len(rec.prompt)] = rec.prompt
                    sids[i] = rec.slot
                sids_dev = _to_device(sids, self.device)
                first, self.arena = arena_prefill(
                    self.params, _to_device(toks, self.device), sids_dev,
                    self.arena, self.cfg)
                src = slot_sources(sids_dev, self.slots)
                self._tok = torch.where(
                    src >= 0, first[src.clamp_min(0)], self._tok)
                self._events.append(("prefill", list(admitted), first))
        active = [o is not None for o in self.slot_owner]
        n_active = sum(active)
        if n_active:
            dur += self.cost.decode_s(n_active)
            if not self.simulate_only:
                act = _to_device(
                    np.fromiter(active, np.bool_, count=self.slots),
                    self.device)
                nxt, self.arena = arena_decode(
                    self.params, self._tok, act, self.arena, self.cfg,
                    attn_impl=self.attn_impl, block_k=self.block_k)
                self._tok = nxt
                self._events.append(("decode", list(self.slot_owner), nxt))
            end = t + dur
            for s, rec in enumerate(self.slot_owner):
                if rec is None:
                    continue
                rec.decoded += 1
                if rec.decoded >= self.decode_tokens:
                    rec.finish_t = end
                    self.slot_owner[s] = None
                    heapq.heappush(self._free, s)
        self.iterations.append(IterationStats(
            t=t, duration_s=dur, admitted=len(admitted),
            n_active=n_active, queue_depth=len(self.queue)))
        return dur

    # -- results -------------------------------------------------------------
    def _materialize_tokens(self) -> None:
        """One host sync for ALL buffered per-iteration token tensors."""
        if not self._events:
            return
        host = torch.stack([ev[2] for ev in self._events]).cpu().numpy()
        for (kind, owners, _), row in zip(self._events, host):
            if kind == "prefill":
                for i, rec in enumerate(owners):
                    rec.tokens.append(int(row[i]))
            else:
                for s, rec in enumerate(owners):
                    if rec is not None:
                        rec.tokens.append(int(row[s]))
        self._events.clear()

    def report(self, *, horizon_s: "float | None" = None) -> ServingReport:
        self._materialize_tokens()
        if horizon_s is None:
            horizon_s = max((r.finish_t for r in self.records
                             if r.finish_t is not None), default=0.0)
        return ServingReport(records=list(self.records), horizon_s=horizon_s)


# --------------------------------------------------------------------------- #
# VirtualClock adapter
# --------------------------------------------------------------------------- #
class ContinuousServer:
    """DeviceFlow delivery callback driving an engine on the shared clock.

    Arrivals enqueue into the engine; a self-rescheduling *tick* event runs
    one engine iteration whenever work is pending, so queued requests join
    at exactly the next iteration boundary and the engine idles only when
    the queue and every slot are empty.  Use as ``DeviceFlow(server)`` with
    ``server = ContinuousServer(engine, flow.clock)``.
    """

    def __init__(self, engine: ContinuousBatchingEngine, clock, *,
                 prompt_of: Callable[[Any], np.ndarray] | None = None):
        self.engine = engine
        self.clock = clock
        self.prompt_of = prompt_of
        self._armed = False

    def _prompt(self, message) -> np.ndarray | None:
        if self.engine.simulate_only:
            return None
        if self.prompt_of is not None:
            return self.prompt_of(message)
        payload = message.payload
        if hasattr(payload, "materialize"):  # UpdateHandle
            payload = payload.materialize()
        return np.asarray(payload["tokens"])

    def __call__(self, d) -> None:
        msgs = (d.batch.messages() if getattr(d, "batch", None) is not None
                else [d.message])
        for m in msgs:
            self.engine.submit(m.device_id, self._prompt(m), d.t)
        self._kick(d.t)

    def _kick(self, t: float) -> None:
        if self._armed:
            return
        self._armed = True
        self.clock.schedule(max(t, self.engine.busy_until), self._tick)

    def _tick(self) -> None:
        t = self.clock.now
        dur = self.engine.step(t)
        self.engine.busy_until = t + dur
        if self.engine.has_work:
            self.clock.schedule(self.engine.busy_until, self._tick)
        else:
            self._armed = False
