"""Cloud-side aggregation service (paper §II.A, §VI.C).

Implements the device-cloud collaborative objective
``min_w F(w) = sum_k p_k F_k(w; D_k)`` with FedAvg/FedProx aggregation, plus
the two aggregation *triggers* the paper evaluates (Fig. 9):

* **sample threshold** — aggregate as soon as the accumulated number of client
  samples reaches a threshold;
* **scheduled** — aggregate at fixed virtual-time intervals with whatever has
  arrived.

Beyond-paper: an **async buffered (FedBuff-style)** mode with staleness
discounting — the natural straggler-mitigation extension once DeviceFlow
exposes arrival times.

**Zero-copy aggregation.**  Pending rows of the round engine's
device-resident stacked buffers (``ArrivalBatch`` slices and
``updates.UpdateHandle`` payloads) are never materialized: ``aggregate``
groups them by buffer, scatters the staleness-discounted weights into one
per-row weight vector per buffer, and runs one ``fed_reduce`` weighted
reduction per leaf of each stacked buffer (the hand-written CUDA kernel on
the card, its plain version on the CPU).  Host payloads in the same
aggregation — the q_i benchmarking devices' materialized updates — add
their weighted sum as one extra term.  The per-message host path
(``weighted_average``/``fedavg_delta``) is kept as the correctness
reference and serves aggregations that hold host payloads only.

**Streaming chunk aggregation** (``streaming=True``): instead of holding
every pending message until the trigger fires and reducing in one shot, the
service accumulates per-buffer weight vectors as handle deliveries land and
launches a ``fed_reduce`` *partial* the moment a cohort chunk's
``UpdateBuffer`` is fully referenced — the launches are asynchronous on the
card, so reduction overlaps the remaining chunks' compute.  At trigger time
the partials (plus any incomplete chunks and host-path stragglers) fold into
the same server-delta update the one-shot fused path applies.

``donate_params=True`` updates the global params tensors *in place* (no new
allocation per aggregation).  The tensors stored on earlier
``AggregationEvent``s are then the same objects and show the newest values —
leave it off when history params are read back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.analysis.sanitizers import exempt, hot_path
from repro_torch.core.deviceflow import (
    ArrivalBatch,
    Delivery,
    Message,
    decode_arrival_batches,
    encode_arrival_batches,
)
from repro_torch.core.updates import UpdateHandle, materialize_handles
from repro_torch.kernels.fed_reduce.ops import fed_reduce

Params = dict  # dict[str, Tensor]


def _leaf(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def weighted_average(updates: list[Params], weights: list[float]) -> Params:
    """FedAvg: ``sum_k p_k w_k`` with ``p_k`` normalized weights."""
    if not updates:
        raise ValueError("no updates to aggregate")
    tot = float(sum(weights))
    if tot <= 0:
        raise ValueError("weights must sum to a positive value")
    ws = [w / tot for w in weights]
    out = {}
    for k in updates[0]:
        acc = _leaf(updates[0][k]) * ws[0]
        for u, w in zip(updates[1:], ws[1:]):
            acc = acc + _leaf(u[k]) * w
        out[k] = acc
    return out


def fedavg_delta(global_params: Params, updates: list[Params],
                 weights: list[float], *, server_lr: float = 1.0) -> Params:
    """Server update: ``w <- w + lr * avg_k p_k (w_k - w)`` (equivalent to
    FedAvg at lr=1 but supports server-side learning rates).  Host update
    dicts are moved to each global leaf's device explicitly."""
    avg = weighted_average(updates, weights)
    out = {}
    for k, g in global_params.items():
        a = _to_device(avg[k].to(g.dtype), g.device)
        out[k] = g + server_lr * (a - g)
    return out


def _apply_update(global_params: Params, sums: list[torch.Tensor],
                  inv_total: float, lr: float, in_place: bool) -> Params:
    # Server update over pre-reduced weighted sums (one per leaf, in sorted
    # key order): g + lr * (sum / total - g).  ``in_place`` writes into the
    # existing params tensors instead of allocating new ones.
    out = {}
    for key, s in zip(sorted(global_params), sums):
        g = global_params[key]
        new = (g + lr * (s.reshape(g.shape) * inv_total - g)).to(g.dtype)
        if in_place:
            g.copy_(new)
            new = g
        out[key] = new
    return {k: out[k] for k in global_params}


def _f32(v: float) -> float:
    # The reference hands the server update f32 scalars; rounding the Python
    # float to f32 first keeps the same operand bits.
    return float(np.float32(v))


@hot_path
def _fused_reduce_apply(global_params: Params, buf_leaves: tuple,
                        buf_scales: tuple, wvecs: tuple, inv_total: float,
                        lr: float, *, impl: str, in_place: bool,
                        extra: "list | None" = None, mesh=None) -> Params:
    # buf_leaves: one tuple of (rows, size) matrices per buffer, leaf order
    # matching sorted(global_params).  ``buf_scales``: per buffer, either
    # None (f32 wire) or one (rows,) f32 scale column per leaf (int8 wire) —
    # fed_reduce folds the scales into the weights, so quantized buffers
    # reduce without a dense f32 copy of the stack.  ``extra``: the host
    # payloads' weighted sum (one flat tensor per leaf), added last.
    # ``mesh`` (a fleet mesh with a ``dp`` axis, or None) splits every
    # reduction's rows over the fleet shards.
    weighted_sum = None  # list of (size,) f32 unnormalized weighted sums
    for leaves2d, scales, w in zip(buf_leaves, buf_scales, wvecs):
        parts = [fed_reduce(leaf, w,
                            scales=None if scales is None else scales[k],
                            impl=impl, mesh=mesh)
                 for k, leaf in enumerate(leaves2d)]
        weighted_sum = parts if weighted_sum is None else [
            a + b for a, b in zip(weighted_sum, parts)]
    if extra is not None:
        weighted_sum = extra if weighted_sum is None else [
            a + b for a, b in zip(weighted_sum, extra)]
    return _apply_update(global_params, weighted_sum, inv_total, lr,
                         in_place)


@hot_path
def _partial_reduce(buf_leaves: tuple, buf_scales, wvec: torch.Tensor,
                    *, impl: str, mesh=None) -> tuple:
    # One chunk's streaming partial: the weighted row-sum of every leaf of
    # one UpdateBuffer.  Launched the moment the chunk fully lands, so the
    # reduction runs (async) while later chunks are still computing.
    return tuple(
        fed_reduce(leaf, wvec,
                   scales=None if buf_scales is None else buf_scales[k],
                   impl=impl, mesh=mesh)
        for k, leaf in enumerate(buf_leaves))


@exempt  # an explicit host-to-card copy, legal in a hot path
def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``.  A host tensor bound for a card goes through
    pinned memory without blocking the host, so an aggregation never waits
    for the launch queue to drain."""
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _weights_to(buf, w: np.ndarray) -> torch.Tensor:
    """A host f32 weight vector (copied) as a tensor on the buffer's
    device."""
    return _to_device(torch.from_numpy(np.array(w, np.float32)), buf.device)


def _host_sum(global_params: Params, updates: list,
              weights: list[float]) -> list[torch.Tensor]:
    """The f32 weighted sum ``sum_k w_k u_k`` of host-path payloads (host
    dicts; stray handles are materialized), one flat tensor per leaf in
    sorted key order, each on its global leaf's device."""
    keys = sorted(global_params)
    hs = None
    for u, w in zip(updates, weights):
        if isinstance(u, UpdateHandle):
            u = u.materialize()
        leaves = [_leaf(u[k]).detach().cpu().to(torch.float32).reshape(-1)
                  * _f32(w) for k in keys]
        hs = leaves if hs is None else [a + b for a, b in zip(hs, leaves)]
    return [_to_device(h, global_params[k].device) for h, k in zip(hs, keys)]


def _fused_update(global_params: Params, batches: list, bvecs: list,
                  handles: list, weights: list[float], total: float, *,
                  server_lr: float, impl: str, donate: bool,
                  extra: "list | None" = None, mesh=None) -> Params:
    """One fused reduction over columnar batches *and* scalar handles: both
    scatter into the same per-buffer weight vectors (a batch is just the
    vectorized form of its rows' handles), then one ``fed_reduce`` per
    (buffer, leaf) and the server update."""
    groups: dict[int, tuple[Any, np.ndarray]] = {}

    def wvec(buf) -> np.ndarray:
        key = id(buf)
        if key not in groups:
            groups[key] = (buf, np.zeros(buf.num_rows, np.float32))
        return groups[key][1]

    for b, v in zip(batches, bvecs):
        np.add.at(wvec(b.buffer), b.rows, v)
    for h, w in zip(handles, weights):
        wvec(h.buffer)[h.row] += w
    buf_leaves = tuple(tuple(buf.leaves2d) for buf, _ in groups.values())
    buf_scales = tuple(_scales_of(buf) for buf, _ in groups.values())
    wvecs = tuple(_weights_to(buf, v) for buf, v in groups.values())
    return _fused_reduce_apply(global_params, buf_leaves, buf_scales, wvecs,
                               _f32(1.0 / total), _f32(server_lr),
                               impl=impl, in_place=donate, extra=extra,
                               mesh=mesh)


@dataclasses.dataclass
class _StreamChunk:
    """Accumulation state for one in-flight cohort chunk (one UpdateBuffer)."""

    buffer: Any  # updates.UpdateBuffer
    weights: np.ndarray  # per-row staleness-discounted weights (f32)
    hits: np.ndarray  # per-row delivery counts (uniform-weight fallback)
    clients: int = 0
    filled: int = 0  # distinct rows seen — O(1) completion test


def _scales_of(buf) -> "tuple | None":
    """A buffer's per-leaf scale columns as a tuple (None for the f32
    wire).  Quantized and f32 buffers may mix freely in one aggregation;
    each reduces with its own wire format."""
    scales = getattr(buf, "scales", None)
    return None if scales is None else tuple(scales)


def _signature(params: Params) -> tuple:
    keys = tuple(sorted(params))
    return keys, [tuple(params[k].shape) for k in keys]


def handles_align(global_params: Params, payloads: list) -> bool:
    """True when every payload is an ``UpdateHandle`` whose buffer layout
    matches ``global_params`` (same sorted keys, same leaf shapes) — the
    precondition for the fused zero-copy aggregation path.  Quantized
    (``wire="int8"``) buffers align exactly like f32 ones: ``shapes`` always
    describes what rows *materialize* to."""
    if not payloads or not all(isinstance(p, UpdateHandle) for p in payloads):
        return False
    keys, shapes = _signature(global_params)
    seen: set[int] = set()
    for p in payloads:
        if id(p.buffer) in seen:
            continue
        seen.add(id(p.buffer))
        if p.buffer.keys != keys or p.buffer.shapes != shapes:
            return False
    return True


def fused_fedavg_delta(
    global_params: Params,
    handles: list[UpdateHandle],
    weights: list[float],
    *,
    server_lr: float = 1.0,
    impl: str = "auto",
    donate: bool = False,
    mesh=None,
) -> Params:
    """``fedavg_delta`` over device-resident handle payloads, fused.

    Groups ``handles`` by their stacked update buffer, scatters ``weights``
    into one per-row f32 weight vector per buffer (rows not referenced weigh
    zero), reduces each buffer with one ``fed_reduce`` weighted row-sum per
    leaf, sums the per-buffer partials, and applies the server update —
    without ever materializing a per-device host dict.

    ``donate=True`` writes the new params into the old params tensors.
    ``mesh`` (a fleet mesh, ``make_fleet_mesh``) splits each reduction's
    rows over its ``dp`` shards.
    """
    if not handles:
        raise ValueError("no updates to aggregate")
    if not handles_align(global_params, handles):
        raise ValueError(
            "handle buffers do not align with global_params (key/shape "
            "mismatch) — materialize and use fedavg_delta instead")
    total = float(sum(weights))
    if total <= 0:
        raise ValueError("weights must sum to a positive value")
    return _fused_update(global_params, [], [], handles, weights, total,
                         server_lr=server_lr, impl=impl, donate=donate,
                         mesh=mesh)


@dataclasses.dataclass
class AggregationEvent:
    t: float
    round_idx: int
    num_clients: int
    num_samples: int
    global_params: Params
    # Mean shelf-queuing delay of the aggregated updates: delivery time minus
    # ``Message.created_t`` (stamped by DeviceFlow at submit from the fleet's
    # sampled round durations).  Zero only when updates arrive instantly.
    mean_latency_s: float = 0.0


class AggregationService:
    """The paper's *Cloud Service*: consumes DeviceFlow deliveries, fires
    aggregation on a trigger, tracks history for the GUI/metrics stream."""

    def __init__(
        self,
        global_params: Params,
        *,
        trigger: "Trigger",
        server_lr: float = 1.0,
        staleness_discount: Callable[[int], float] | None = None,
        on_aggregate: Callable[[AggregationEvent], None] | None = None,
        reduce_impl: str = "auto",
        donate_params: bool = False,
        streaming: bool = False,
        mesh=None,
    ):
        self.global_params = global_params
        self.trigger = trigger
        self.server_lr = server_lr
        self.staleness_discount = staleness_discount
        self.on_aggregate = on_aggregate
        # Zero-copy path knobs: ``reduce_impl`` selects the fed_reduce
        # implementation for handle payloads ("auto": the kernel for CUDA
        # tensors, the plain version for CPU ones); ``donate_params``
        # updates the global params in place each aggregation.
        self.reduce_impl = reduce_impl
        self.donate_params = donate_params
        # ``mesh`` (a fleet mesh with a ``dp`` axis, or None) shards the
        # fused aggregation's fed_reduce rows over the fleet shards.
        self.mesh = mesh
        # Streaming chunk aggregation (module docstring): aligned handle
        # payloads accumulate per-buffer weight vectors; each chunk's
        # fed_reduce partial launches as soon as its buffer is fully
        # referenced.  Non-handle payloads still take the pending-message
        # path and are folded in at trigger time.
        self.streaming = streaming
        self._pending: list[Message] = []
        # Columnar plane: pending ArrivalBatches ride whole (struct-of-array
        # columns, shared buffer) until the trigger fires — no per-row
        # objects.  ``_pending_batch_rows`` keeps client counts O(1).
        self._pending_batches: list[ArrivalBatch] = []
        self._pending_batch_rows = 0
        self._pending_samples = 0
        self._pending_latency = 0.0
        self._chunks: dict[int, _StreamChunk] = {}  # open, by id(buffer)
        self._fired: list[_StreamChunk] = []  # kept for uniform fallback
        self._partials: list[tuple[tuple, float]] = []  # (leaves, weight sum)
        self._stream_clients = 0
        self._g_sig = None  # cached (sorted keys, shapes) of global_params
        self.round_idx = 0
        self.history: list[AggregationEvent] = []

    # DeviceFlow delivery callback -----------------------------------------
    def __call__(self, d: Delivery) -> None:
        if d.batch is not None:
            self._on_batch(d.t, d.batch)
        else:
            m = d.message
            self._pending_samples += m.num_samples
            # created_t is None for messages delivered without passing
            # through a DeviceFlow Sorter (direct service calls): no
            # queuing, zero latency.
            if m.created_t is not None:
                self._pending_latency += max(0.0, d.t - m.created_t)
            if (self.streaming and isinstance(m.payload, UpdateHandle)
                    and self._stream_aligned(m.payload.buffer)):
                self._stream_add(m)
            else:
                self._pending.append(m)
        if self.trigger.should_fire(self, d.t):
            self.aggregate(d.t)

    def _on_batch(self, t: float, b: ArrivalBatch) -> None:
        """Columnar intake: one ArrivalBatch slice, all accounting
        vectorized — the hot path never touches per-row objects."""
        if b.buffer is None:
            raise ValueError(
                "AggregationService needs buffer-backed ArrivalBatches "
                "(metadata-only batches carry no model update)")
        self._pending_samples += b.total_samples
        stamped = ~np.isnan(b.created_t)
        if stamped.any():
            self._pending_latency += float(
                np.clip(t - b.created_t[stamped], 0.0, None).sum())
        if self.streaming and self._stream_aligned(b.buffer):
            self._stream_add_batch(b)
        else:
            self._pending_batches.append(b)
            self._pending_batch_rows += b.n

    # -- streaming accumulation --------------------------------------------
    def _weight(self, m: Message) -> float:
        w = float(m.num_samples)
        if self.staleness_discount is not None:
            w *= self.staleness_discount(max(0, self.round_idx - m.round_idx))
        return w

    def _weights_of(self, b: ArrivalBatch) -> np.ndarray:
        """Per-row aggregation weights of a batch (vectorized ``_weight``)."""
        w = b.num_samples.astype(np.float32)
        if self.staleness_discount is not None:
            w = w * np.float32(self.staleness_discount(
                max(0, self.round_idx - b.round_idx)))
        return w

    def _stream_aligned(self, buffer) -> bool:
        sig = self._g_sig
        if sig is None:
            sig = self._g_sig = _signature(self.global_params)
        return buffer.keys == sig[0] and buffer.shapes == sig[1]

    def _stream_add(self, m: Message) -> None:
        h = m.payload
        key = id(h.buffer)
        ch = self._chunks.get(key)
        if ch is None:
            ch = self._chunks[key] = _StreamChunk(
                h.buffer,
                np.zeros(h.buffer.num_rows, np.float32),
                np.zeros(h.buffer.num_rows, np.float32))
        ch.weights[h.row] += self._weight(m)
        if ch.hits[h.row] == 0.0:
            ch.filled += 1
        ch.hits[h.row] += 1.0
        ch.clients += 1
        self._stream_clients += 1
        if ch.filled == ch.buffer.num_rows:
            # The chunk has fully landed: launch its fed_reduce partial now —
            # the (async) reduction overlaps the remaining chunks' compute.
            self._fire_chunk(key)

    def _stream_add_batch(self, b: ArrivalBatch) -> None:
        """Vectorized ``_stream_add``: one scatter per batch slice."""
        key = id(b.buffer)
        ch = self._chunks.get(key)
        if ch is None:
            ch = self._chunks[key] = _StreamChunk(
                b.buffer,
                np.zeros(b.buffer.num_rows, np.float32),
                np.zeros(b.buffer.num_rows, np.float32))
        np.add.at(ch.weights, b.rows, self._weights_of(b))
        np.add.at(ch.hits, b.rows, np.float32(1.0))
        ch.filled = int(np.count_nonzero(ch.hits))
        ch.clients += b.n
        self._stream_clients += b.n
        if ch.filled == ch.buffer.num_rows:
            self._fire_chunk(key)

    def _fire_chunk(self, key: int) -> None:
        ch = self._chunks.pop(key)
        leaves = _partial_reduce(tuple(ch.buffer.leaves2d),
                                 _scales_of(ch.buffer),
                                 _weights_to(ch.buffer, ch.weights),
                                 impl=self.reduce_impl, mesh=self.mesh)
        self._partials.append((leaves, float(ch.weights.sum())))
        self._fired.append(ch)

    def tick(self, t: float) -> None:
        """Clock hook for scheduled triggers."""
        if self.trigger.should_fire_on_tick(self, t):
            self.aggregate(t)

    def aggregate(self, t: float) -> AggregationEvent | None:
        n_stream = self._stream_clients
        n_batch = self._pending_batch_rows
        if not self._pending and not n_stream and not n_batch:
            return None
        num_clients = len(self._pending) + n_stream + n_batch
        updates: list = []  # host-path payloads and their weights
        weights: list[float] = []
        if n_stream:
            updates = [m.payload for m in self._pending]
            weights = [self._weight(m) for m in self._pending]
            # Streaming mode: pending batches here have foreign buffer
            # layouts (aligned ones streamed into chunks on arrival) —
            # fold them in through the scalar adapter.
            for b in self._pending_batches:
                for m in b.messages():
                    updates.append(m.payload)
                    weights.append(self._weight(m))
            self.global_params = self._aggregate_streaming(updates, weights)
        else:
            # Partition: rows of buffers whose layout matches the global
            # params (columnar batches and scalar handles) reduce with
            # fed_reduce where the buffers live; every other payload (the
            # q_i benchmarking devices' host dicts, foreign layouts) joins
            # as one extra weighted term.
            aligned: list[ArrivalBatch] = []
            handles: list[UpdateHandle] = []
            hweights: list[float] = []
            for m in self._pending:
                if (isinstance(m.payload, UpdateHandle)
                        and self._stream_aligned(m.payload.buffer)):
                    handles.append(m.payload)
                    hweights.append(self._weight(m))
                else:
                    updates.append(m.payload)
                    weights.append(self._weight(m))
            for b in self._pending_batches:
                if self._stream_aligned(b.buffer):
                    aligned.append(b)
                else:
                    for m in b.messages():
                        updates.append(m.payload)
                        weights.append(self._weight(m))
            bvecs = [self._weights_of(b) for b in aligned]
            total = (float(sum(hweights)) + float(sum(weights))
                     + float(sum(v.sum() for v in bvecs)))
            if total <= 0.0:
                # An aggressive staleness_discount can zero every pending
                # weight; fall back to uniform weights, spanning every
                # plane, instead of crashing the delivery callback.
                hweights = [1.0] * len(handles)
                weights = [1.0] * len(updates)
                bvecs = [np.ones(b.n, np.float32) for b in aligned]
                total = float(len(handles) + len(updates)
                              + sum(b.n for b in aligned))
            if aligned or handles:
                self.global_params = _fused_update(
                    self.global_params, aligned, bvecs, handles, hweights,
                    total, server_lr=self.server_lr, impl=self.reduce_impl,
                    donate=self.donate_params, mesh=self.mesh,
                    extra=(_host_sum(self.global_params, updates, weights)
                           if updates else None))
            else:
                # Host reference path: only host payloads are pending.
                updates = [u.materialize() if isinstance(u, UpdateHandle)
                           else u for u in updates]
                self.global_params = fedavg_delta(
                    self.global_params, updates, weights,
                    server_lr=self.server_lr)
        ev = AggregationEvent(
            t=t,
            round_idx=self.round_idx,
            num_clients=num_clients,
            num_samples=self._pending_samples,
            global_params=self.global_params,
            mean_latency_s=self._pending_latency / num_clients,
        )
        self.history.append(ev)
        self._pending = []
        self._pending_batches = []
        self._pending_batch_rows = 0
        self._pending_samples = 0
        self._pending_latency = 0.0
        self._chunks = {}
        self._fired = []
        self._partials = []
        self._stream_clients = 0
        self.round_idx += 1
        if self.on_aggregate is not None:
            self.on_aggregate(ev)
        return ev

    def _aggregate_streaming(self, host_updates: list,
                             host_weights: list[float]) -> Params:
        """Fold fired partials + leftover chunks + host stragglers into the
        server update (same math as ``fused_fedavg_delta``)."""
        for key in list(self._chunks):  # chunks the dispatcher cut short
            self._fire_chunk(key)
        total = (sum(w for _, w in self._partials) + sum(host_weights))
        if total <= 0.0:
            # Uniform fallback: re-reduce every chunk with its delivery
            # counts.  Needs the chunk buffers, which are retained until
            # aggregation exactly for this case; a restored service has none
            # (see ``state_dict``) and keeps the params unchanged instead of
            # crashing the delivery callback.
            if not self._fired and not host_updates:
                return self.global_params
            self._partials = [
                (_partial_reduce(tuple(ch.buffer.leaves2d),
                                 _scales_of(ch.buffer),
                                 _weights_to(ch.buffer, ch.hits),
                                 impl=self.reduce_impl, mesh=self.mesh),
                 float(ch.hits.sum()))
                for ch in self._fired]
            host_weights = [1.0] * len(host_updates)
            total = (sum(w for _, w in self._partials) + sum(host_weights))
        summed = None
        for leaves, _ in self._partials:
            summed = (list(leaves) if summed is None
                      else [a + b for a, b in zip(summed, leaves)])
        if host_updates:
            # Host-path stragglers (non-handle payloads): their f32 weighted
            # sum joins the partials as one extra term.
            hs = _host_sum(self.global_params, host_updates, host_weights)
            summed = (hs if summed is None
                      else [a + b for a, b in zip(summed, hs)])
        return _apply_update(self.global_params, summed, _f32(1.0 / total),
                             _f32(self.server_lr), self.donate_params)

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """Resume-safe aggregation state.

        Open streaming chunks are flushed to partials first, and partial
        sums are copied to host arrays, so the result holds no live device
        references.  (A restored service cannot apply the uniform-weight
        fallback for pre-checkpoint partials — the chunk buffers are gone;
        it keeps the params unchanged in that edge case.)
        """
        for key in list(self._chunks):
            self._fire_chunk(key)

        def enc_msg(m: Message) -> dict:
            return {"task_id": m.task_id, "device_id": m.device_id,
                    "round_idx": m.round_idx, "num_samples": m.num_samples,
                    "created_t": m.created_t, "size_bytes": m.size_bytes,
                    "payload": materialize_handles(m.payload)}

        return {
            "round_idx": self.round_idx,
            "pending": [enc_msg(m) for m in self._pending],
            # Columnar plane: pending batches round-trip as struct-of-array
            # state (host columns + deduplicated buffer snapshots).
            "pending_batches": encode_arrival_batches(self._pending_batches),
            "pending_samples": self._pending_samples,
            "pending_latency": self._pending_latency,
            "stream_clients": self._stream_clients,
            "partials": [
                {"leaves": [l.detach().cpu().numpy() for l in leaves],
                 "weight": w}
                for leaves, w in self._partials],
        }

    def load_state_dict(self, d: dict) -> None:
        self.round_idx = int(d["round_idx"])
        self._pending = [Message(**m) for m in d["pending"]]
        self._pending_batches = decode_arrival_batches(
            d.get("pending_batches", {}))
        self._pending_batch_rows = sum(b.n for b in self._pending_batches)
        self._pending_samples = int(d["pending_samples"])
        self._pending_latency = float(d["pending_latency"])
        self._stream_clients = int(d.get("stream_clients", 0))
        devs = [g.device for _, g in sorted(self.global_params.items())]
        self._partials = [
            (tuple(torch.as_tensor(l, device=dev)
                   for l, dev in zip(p["leaves"], devs)),
             float(p["weight"]))
            for p in d.get("partials", ())]
        self._chunks = {}
        self._fired = []
        self._g_sig = None

    @property
    def pending_samples(self) -> int:
        return self._pending_samples

    @property
    def pending_clients(self) -> int:
        return (len(self._pending) + self._stream_clients
                + self._pending_batch_rows)


class Trigger:
    def should_fire(self, svc: AggregationService, t: float) -> bool:
        return False

    def should_fire_on_tick(self, svc: AggregationService, t: float) -> bool:
        return False


@dataclasses.dataclass
class SampleThresholdTrigger(Trigger):
    """Aggregate when accumulated edge training samples reach a threshold."""

    threshold: int

    def should_fire(self, svc: AggregationService, t: float) -> bool:
        return svc.pending_samples >= self.threshold


@dataclasses.dataclass
class ClientCountTrigger(Trigger):
    """Aggregate when K client updates have arrived (FedBuff buffer size)."""

    k: int

    def should_fire(self, svc: AggregationService, t: float) -> bool:
        return svc.pending_clients >= self.k


@dataclasses.dataclass
class ScheduledTrigger(Trigger):
    """Aggregate every ``period`` virtual seconds (paper: scheduled times)."""

    period: float
    _last: float = 0.0

    def should_fire_on_tick(self, svc: AggregationService, t: float) -> bool:
        if t - self._last >= self.period - 1e-9 and svc.pending_clients > 0:
            # Snap forward on the fixed grid rather than re-anchoring to the
            # tick's arrival time — aggregation stays on the paper's
            # "scheduled times" instead of drifting by the tick jitter.  The
            # max(1, ...) guards the fire-condition tolerance: a tick landing
            # a hair below the grid point must still advance the grid.
            self._last += self.period * max(1, math.floor(
                (t - self._last + 1e-9) / self.period))
            return True
        return False


def polynomial_staleness(alpha: float = 0.5) -> Callable[[int], float]:
    """FedBuff-style ``(1 + s)^-alpha`` staleness discount."""
    return lambda s: (1.0 + s) ** (-alpha)
