"""DeviceFlow — the device-behavior traffic controller (paper §V).

DeviceFlow sits between the simulated edge tiers and the cloud service.  From
the edge's viewpoint it is a cloud proxy; from the cloud's viewpoint it *is*
the device population.  Four modules (paper Fig. 4):

* **Sorter** — receives messages from the compute clusters and routes them to
  the correct **Shelf** by ``task_id``.
* **Shelf** — per-task FIFO buffer of pending messages.
* **Strategy** — stores the user-defined dispatch strategy per task.
* **Dispatcher** — per-shelf, independent; parses the strategy and emits
  messages to the downstream cloud service.  Dispatchers of different tasks
  never interfere.

Everything runs against a *virtual clock* (deterministic event-driven
simulation), which stands in for the paper's wall-clock
network component: identical ordering semantics, fully reproducible.

**Columnar message plane.**  At the fleet scales the roadmap targets (10^6
devices per round) one Python ``Message`` per device is the whole round
budget, so the hot path is struct-of-arrays: an ``ArrivalBatch`` carries one
cohort chunk's worth of arrivals as parallel numpy columns (``rows``,
``created_t``, ``nbytes``, ``num_samples``, ``device_ids``) plus ONE shared
``updates.UpdateBuffer`` reference — the ``UpdateHandle`` row index is
already the columnar key; a batch is its vectorization.  ``submit_batch`` /
``submit_arrivals`` merge batches (and scalar stragglers) into global
arrival order, the Shelf stores them as time-interleaved segments without
materializing per-row objects, and the Dispatcher threshold-triggers on row
counts and byte totals, delivering contiguous batch *slices* downstream.
The scalar ``Message`` API is kept as a thin adapter — ``submit`` /
``submit_many`` behave exactly as before, a 1-row batch delivery exposes
``Delivery.message``, and ``ArrivalBatch.messages()`` materializes per-row
views for compat consumers (fault injection, serve.py, tests).

Arrival-time contract (batched round engine): the simulation tiers sample
per-device round durations from ``DeviceFleet`` and hand them to the Sorter
as arrival times — ``submit(msg, t)`` stamps ``Message.created_t`` at submit
time so downstream latency/staleness accounting sees real queuing delay, and
the bulk paths (``submit_many``, ``submit_batch``) stamp only *unstamped*
rows (``created_t=None`` scalar / NaN column) with their own arrival time; a
producer stamp — including ``0.0`` — is always preserved.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from repro_torch.analysis import sanitizers
from repro_torch.core.strategies import (
    AccumulatedStrategy,
    DispatchStrategy,
    TimeIntervalStrategy,
    TimePointStrategy,
)


def payload_nbytes(payload: Any) -> int:
    """Best-effort wire size of a message payload.

    Tensors count ``element_size() * numel()``; anything else exposing
    ``nbytes`` (ndarray leaves, and ``updates.UpdateHandle`` — which reports
    its stacked-buffer *row* size, the bytes a physical device would
    actually upload) counts directly; containers sum their children; opaque
    objects count 0.
    """
    if isinstance(payload, torch.Tensor):
        return payload.element_size() * payload.numel()
    nb = getattr(payload, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(payload, dict):
        return sum(payload_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_nbytes(v) for v in payload)
    return 0


class _Weakrefable:
    # Base slot so the slotted Message below still supports weak references
    # (``weakref_slot=True`` needs 3.11; the base-class form works on 3.10).
    __slots__ = ("__weakref__",)


@dataclasses.dataclass(frozen=True, slots=True)
class Message(_Weakrefable):
    """One edge→cloud message (model update, metric packet, ...).

    Slotted: rounds emit one instance per simulated device, so per-instance
    ``__dict__``s are real memory at fleet scale.  ``size_bytes`` is
    auto-computed from the payload when not given, so DeviceFlow traffic
    accounting reflects real model-update sizes instead of defaulting to 0.

    ``created_t=None`` means *unstamped* — the Sorter stamps it at submit
    time.  (``0.0`` used to double as the sentinel, which silently
    re-stamped producer-stamped t=0 messages submitted later and corrupted
    latency accounting; a producer-stamped ``0.0`` is now preserved.)
    """

    task_id: int
    device_id: int
    round_idx: int
    payload: Any
    created_t: float | None = None
    num_samples: int = 1
    size_bytes: int = 0

    def __post_init__(self):
        if self.size_bytes == 0:
            object.__setattr__(
                self, "size_bytes", payload_nbytes(self.payload))


class ArrivalBatch(_Weakrefable):
    """Struct-of-arrays record of one cohort chunk's edge→cloud arrivals.

    Parallel numpy columns over ``n`` rows plus ONE shared ``buffer``
    reference (``updates.UpdateBuffer`` — or ``None`` for metadata-only
    traffic):

    * ``rows: int32[n]`` — row index of each arrival inside ``buffer``;
    * ``created_t: float64[n]`` — producer stamp; **NaN means unstamped**
      (the columnar equivalent of the scalar ``created_t=None`` sentinel)
      and is filled with the arrival time at submit;
    * ``nbytes: int64[n]`` — wire size per row (defaults to the buffer's
      ``row_nbytes``, so a quantized buffer — ``UpdateBuffer(wire="int8")``
      with its int8 leaves + per-leaf scale columns — reports its real
      ~4x-smaller wire footprint through ``Shelf.total_bytes_*`` without any
      caller involvement);
    * ``num_samples: int64[n]`` and ``device_ids: int64[n]`` — aggregation
      weight and global identity per row.

    Slicing (``islice`` / ``select``) returns cheap column views sharing the
    same buffer, so threshold dispatch never copies update payloads.
    ``message(i)`` / ``messages()`` are the scalar-``Message`` compat
    adapter: each row materializes as a ``Message`` whose payload is
    ``buffer.handle(rows[i])``.
    """

    __slots__ = ("task_id", "round_idx", "rows", "created_t", "nbytes",
                 "num_samples", "device_ids", "buffer")

    def __init__(self, task_id: int, round_idx: int, rows,
                 created_t=None, nbytes=None, num_samples=None,
                 device_ids=None, buffer: Any = None):
        self.task_id = int(task_id)
        self.round_idx = int(round_idx)
        self.rows = np.asarray(rows, np.int32)
        if self.rows.ndim != 1:
            raise ValueError("ArrivalBatch.rows must be 1-D")
        n = self.rows.shape[0]
        self.created_t = (np.full(n, np.nan) if created_t is None
                          else np.asarray(created_t, np.float64))
        if nbytes is None:
            per_row = int(getattr(buffer, "row_nbytes", 0) or 0)
            self.nbytes = np.full(n, per_row, np.int64)
        else:
            self.nbytes = np.asarray(nbytes, np.int64)
        self.num_samples = (np.ones(n, np.int64) if num_samples is None
                            else np.asarray(num_samples, np.int64))
        self.device_ids = (self.rows.astype(np.int64) if device_ids is None
                           else np.asarray(device_ids, np.int64))
        self.buffer = buffer
        for name in ("created_t", "nbytes", "num_samples", "device_ids"):
            if getattr(self, name).shape != (n,):
                raise ValueError(f"ArrivalBatch.{name} must have shape ({n},)")

    @classmethod
    def from_buffer(cls, task_id: int, round_idx: int, buffer, *,
                    rows=None, device_ids=None, num_samples=None,
                    created_t=None) -> "ArrivalBatch":
        """One arrival per buffer row (the cohort-chunk emission shape)."""
        if rows is None:
            rows = np.arange(buffer.num_rows, dtype=np.int32)
        return cls(task_id, round_idx, rows, created_t=created_t,
                   num_samples=num_samples, device_ids=device_ids,
                   buffer=buffer)

    # -- columnar views ----------------------------------------------------
    @property
    def n(self) -> int:
        return self.rows.shape[0]

    def __len__(self) -> int:
        return self.rows.shape[0]

    @property
    def total_bytes(self) -> int:
        return int(self.nbytes.sum())

    @property
    def total_samples(self) -> int:
        return int(self.num_samples.sum())

    def select(self, idx) -> "ArrivalBatch":
        """Row subset (new column arrays, same shared buffer)."""
        return ArrivalBatch(
            self.task_id, self.round_idx, self.rows[idx],
            created_t=self.created_t[idx], nbytes=self.nbytes[idx],
            num_samples=self.num_samples[idx],
            device_ids=self.device_ids[idx], buffer=self.buffer)

    def islice(self, lo: int, hi: int) -> "ArrivalBatch":
        """Contiguous row slice (column *views* — zero copies)."""
        return ArrivalBatch(
            self.task_id, self.round_idx, self.rows[lo:hi],
            created_t=self.created_t[lo:hi], nbytes=self.nbytes[lo:hi],
            num_samples=self.num_samples[lo:hi],
            device_ids=self.device_ids[lo:hi], buffer=self.buffer)

    def stamp(self, ts: np.ndarray) -> "ArrivalBatch":
        """Fill *unstamped* rows (NaN) with their arrival times; rows the
        producer stamped — including 0.0 — are preserved verbatim."""
        nan = np.isnan(self.created_t)
        if not nan.any():
            return self
        created = self.created_t.copy()
        created[nan] = np.asarray(ts, np.float64)[nan]
        return ArrivalBatch(
            self.task_id, self.round_idx, self.rows, created_t=created,
            nbytes=self.nbytes, num_samples=self.num_samples,
            device_ids=self.device_ids, buffer=self.buffer)

    # -- scalar compat adapter ---------------------------------------------
    def message(self, i: int) -> Message:
        """Row ``i`` as a scalar ``Message`` (payload = buffer row handle)."""
        ct = float(self.created_t[i])
        payload = (self.buffer.handle(int(self.rows[i]))
                   if self.buffer is not None else None)
        return Message(
            self.task_id, int(self.device_ids[i]), self.round_idx, payload,
            created_t=None if np.isnan(ct) else ct,
            num_samples=int(self.num_samples[i]),
            size_bytes=int(self.nbytes[i]))

    def messages(self) -> list[Message]:
        return [self.message(i) for i in range(self.n)]

    def __repr__(self) -> str:
        return (f"ArrivalBatch(task_id={self.task_id}, "
                f"round_idx={self.round_idx}, n={self.n}, "
                f"bytes={self.total_bytes})")

    # -- checkpointing -----------------------------------------------------
    def state_dict(self, buffer_table: "_BufferTable | None" = None) -> dict:
        buf = (None if self.buffer is None else
               buffer_table.add(self.buffer) if buffer_table is not None
               else self.buffer.state_dict())
        return {"task_id": self.task_id, "round_idx": self.round_idx,
                "rows": np.array(self.rows),
                "created_t": np.array(self.created_t),
                "nbytes": np.array(self.nbytes),
                "num_samples": np.array(self.num_samples),
                "device_ids": np.array(self.device_ids),
                "buffer": buf}

    @classmethod
    def from_state_dict(cls, d: dict,
                        buffers: "list | None" = None) -> "ArrivalBatch":
        buf = d["buffer"]
        if isinstance(buf, int):
            buf = buffers[buf]
        elif isinstance(buf, dict):
            from repro_torch.core.updates import UpdateBuffer
            buf = UpdateBuffer.from_state_dict(buf)
        return cls(d["task_id"], d["round_idx"], d["rows"],
                   created_t=d["created_t"], nbytes=d["nbytes"],
                   num_samples=d["num_samples"], device_ids=d["device_ids"],
                   buffer=buf)


class _BufferTable:
    """Deduplicating UpdateBuffer encoder: batches sharing one buffer keep
    sharing it across a state_dict round-trip (one stored copy, restored to
    one live object — aggregation re-groups them correctly)."""

    def __init__(self):
        self._idx: dict[int, int] = {}
        self.encoded: list = []

    def add(self, buffer) -> int:
        key = id(buffer)
        if key not in self._idx:
            self._idx[key] = len(self.encoded)
            self.encoded.append(buffer.state_dict())
        return self._idx[key]

    @staticmethod
    def decode(encoded: list) -> list:
        from repro_torch.core.updates import UpdateBuffer
        return [UpdateBuffer.from_state_dict(d) for d in encoded]


def encode_arrival_batches(batches: "Sequence[ArrivalBatch]") -> dict:
    """Columnar-state helper: encode batches with shared-buffer dedup."""
    table = _BufferTable()
    return {"batches": [b.state_dict(table) for b in batches],
            "buffers": table.encoded}


def decode_arrival_batches(d: dict) -> "list[ArrivalBatch]":
    buffers = _BufferTable.decode(d.get("buffers", []))
    return [ArrivalBatch.from_state_dict(b, buffers)
            for b in d.get("batches", [])]


class _BatchGroup:
    """Time-interleaved shelf segment over columnar batches (plus any scalar
    stragglers submitted in the same call).

    ``src[j]`` is the source index of the j-th pending row in global arrival
    order; ``take`` pops rows in that order and returns at most one
    contiguous ``islice`` per batch source — dispatch-group membership is
    exactly what per-message submits in time order would produce, at
    O(sources) per dispatch instead of O(rows).
    """

    __slots__ = ("sources", "src", "cursors", "pos")

    def __init__(self, sources: list, src):
        self.sources = list(sources)  # ArrivalBatch | list[Message], sorted
        self.src = np.asarray(src, np.int32)
        self.cursors = [0] * len(self.sources)
        self.pos = 0

    def remaining(self) -> int:
        return len(self.src) - self.pos

    def take(self, k: int) -> list:
        seg = self.src[self.pos:self.pos + int(k)]
        self.pos += len(seg)
        out: list = []
        counts = np.bincount(seg, minlength=len(self.sources))
        for s_idx in np.flatnonzero(counts):
            source = self.sources[s_idx]
            lo = self.cursors[s_idx]
            hi = lo + int(counts[s_idx])
            self.cursors[s_idx] = hi
            if isinstance(source, ArrivalBatch):
                out.append(source.islice(lo, hi))
            else:
                out.extend(source[lo:hi])
        return out

    def state_dict(self, buffer_table: _BufferTable) -> dict:
        sources = [
            {"__batch__": s.state_dict(buffer_table)}
            if isinstance(s, ArrivalBatch) else {"__msgs__": list(s)}
            for s in self.sources]
        return {"sources": sources, "src": np.array(self.src),
                "cursors": list(self.cursors), "pos": self.pos}

    @classmethod
    def from_state_dict(cls, d: dict, buffers: list) -> "_BatchGroup":
        sources = [
            ArrivalBatch.from_state_dict(s["__batch__"], buffers)
            if "__batch__" in s else list(s["__msgs__"])
            for s in d["sources"]]
        g = cls(sources, d["src"])
        g.cursors = list(d["cursors"])
        g.pos = int(d["pos"])
        return g


def _item_rows(item) -> int:
    """Pending-row count of one shelf/dispatch item."""
    if isinstance(item, ArrivalBatch):
        return item.n
    if isinstance(item, _BatchGroup):
        return item.remaining()
    return 1


class Delivery:
    """A message — or a columnar batch slice — delivered to the cloud
    service at virtual time ``t``.

    Exactly one of ``message`` / ``batch`` is set at construction.  As the
    scalar compat adapter, a single-row batch delivery also answers
    ``.message`` (materialized lazily), so per-message consumers written
    against realtime strategies (threshold 1 ⇒ every delivery is one row)
    keep working unchanged.
    """

    __slots__ = ("t", "batch", "_message")

    def __init__(self, t: float, message: Message | None = None,
                 batch: ArrivalBatch | None = None):
        if (message is None) == (batch is None):
            raise ValueError("Delivery takes exactly one of message/batch")
        self.t = float(t)
        self.batch = batch
        self._message = message

    @property
    def message(self) -> Message | None:
        if self._message is None and self.batch is not None and self.batch.n == 1:
            self._message = self.batch.message(0)
        return self._message

    @property
    def task_id(self) -> int:
        return (self.batch.task_id if self.batch is not None
                else self._message.task_id)

    @property
    def num_messages(self) -> int:
        return self.batch.n if self.batch is not None else 1

    def __repr__(self) -> str:
        what = self.batch if self._message is None else self._message
        return f"Delivery(t={self.t}, {what!r})"


class Shelf:
    """FIFO buffer of pending messages for one task.

    Holds scalar ``Message`` items and ``_BatchGroup`` columnar segments in
    one arrival-ordered deque; ``len()`` and every counter are in *rows*
    (message-equivalents), so threshold strategies and conservation checks
    see identical semantics on both planes.
    """

    def __init__(self, task_id: int):
        self.task_id = task_id
        self._buf: deque = deque()  # Message | _BatchGroup
        self._rows = 0  # pending rows, O(1) (groups make len(_buf) wrong)
        self.total_received = 0
        self.total_dispatched = 0
        self.total_dropped = 0
        # Real traffic accounting (edge->cloud model-update bytes): payloads
        # report their wire size via Message.size_bytes — handle payloads
        # count the stacked-buffer row, not the reference; batches sum their
        # ``nbytes`` column.
        self.total_bytes_received = 0
        self.total_bytes_dispatched = 0

    def put(self, msg: Message) -> None:
        self._buf.append(msg)
        self._rows += 1
        self.total_received += 1
        self.total_bytes_received += msg.size_bytes

    def put_many(self, msgs: Iterable[Message]) -> int:
        msgs = list(msgs)
        self._buf.extend(msgs)
        self._rows += len(msgs)
        self.total_received += len(msgs)
        self.total_bytes_received += sum(m.size_bytes for m in msgs)
        return len(msgs)

    def put_group(self, group: _BatchGroup) -> int:
        n = group.remaining()
        nbytes = sum(
            s.total_bytes if isinstance(s, ArrivalBatch)
            else sum(m.size_bytes for m in s)
            for s in group.sources)
        self._buf.append(group)
        self._rows += n
        self.total_received += n
        self.total_bytes_received += nbytes
        return n

    def take(self, n: int) -> list:
        """Pop up to ``n`` rows in arrival order.  Returns a mixed list of
        ``Message`` items and contiguous ``ArrivalBatch`` slices."""
        out: list = []
        need = int(n)
        while need > 0 and self._buf:
            head = self._buf[0]
            if isinstance(head, _BatchGroup):
                before = head.remaining()
                out.extend(head.take(need))
                took = before - head.remaining()
                need -= took
                self._rows -= took
                if head.remaining() == 0:
                    self._buf.popleft()
            else:
                out.append(self._buf.popleft())
                need -= 1
                self._rows -= 1
        return out

    def __len__(self) -> int:
        return self._rows

    # -- checkpointing hooks (runtime/fault tolerance) ---------------------
    def state_dict(self) -> dict:
        table = _BufferTable()
        buf = [{"__group__": e.state_dict(table)}
               if isinstance(e, _BatchGroup) else e
               for e in self._buf]
        return {
            "task_id": self.task_id,
            "buf": buf,
            "buffers": table.encoded,
            "received": self.total_received,
            "dispatched": self.total_dispatched,
            "dropped": self.total_dropped,
            "bytes_received": self.total_bytes_received,
            "bytes_dispatched": self.total_bytes_dispatched,
        }

    @classmethod
    def from_state_dict(cls, d: dict) -> "Shelf":
        s = cls(d["task_id"])
        buffers = _BufferTable.decode(d.get("buffers", []))
        s._buf = deque(
            _BatchGroup.from_state_dict(e["__group__"], buffers)
            if isinstance(e, dict) and "__group__" in e else e
            for e in d["buf"])
        s._rows = sum(_item_rows(e) for e in s._buf)
        s.total_received = d["received"]
        s.total_dispatched = d["dispatched"]
        s.total_dropped = d["dropped"]
        s.total_bytes_received = d.get("bytes_received", 0)
        s.total_bytes_dispatched = d.get("bytes_dispatched", 0)
        return s


class Dispatcher:
    """Per-shelf dispatcher executing one strategy.  Independent per task."""

    def __init__(
        self,
        shelf: Shelf,
        strategy: DispatchStrategy,
        deliver: Callable[[Delivery], None],
        *,
        seed: int = 0,
    ):
        self.shelf = shelf
        self.strategy = strategy
        self.deliver = deliver
        self.rng = np.random.default_rng(seed ^ (shelf.task_id * 0x9E3779B9))
        self._cycle = 0  # accumulated-strategy threshold cursor

    # -- real-time accumulated path ----------------------------------------
    def on_message(self, t: float) -> None:
        """Called by the Sorter after every shelf insertion.

        Drains in a loop: with bulk restores or a shrinking ``threshold_at``
        schedule the shelf can sit multiple thresholds above the waterline —
        a single-batch dispatch would strand that backlog forever.
        """
        if not isinstance(self.strategy, AccumulatedStrategy):
            return
        while len(self.shelf) >= (thr := self.strategy.threshold_at(self._cycle)):
            batch = self.shelf.take(thr)
            self._cycle += 1
            self._send(t, batch, self.strategy.failure_prob, 0)

    def on_messages(self, ts: np.ndarray, t_base: float) -> None:
        """Bulk-insert hook: ``len(ts)`` rows (already shelved, arrival
        order) landed at times ``ts``; dispatch once per threshold crossing.

        Equivalent to calling ``on_message(ts[j])`` after each insertion, but
        O(dispatch events) instead of O(rows) Python work — the batch plane
        rides this unchanged because it only reasons about *counts*.
        Pre-existing backlog above the threshold drains at ``t_base``.
        """
        if not isinstance(self.strategy, AccumulatedStrategy):
            return
        k = len(ts)
        pre = len(self.shelf) - k  # rows buffered before this bulk insert
        arrived = consumed = 0
        while True:
            thr = self.strategy.threshold_at(self._cycle)
            avail = pre + arrived - consumed
            if avail < thr:
                need = thr - avail
                if arrived + need > k:
                    break  # not enough arrivals left to cross the threshold
                arrived += need
                t_evt = float(ts[arrived - 1])
            else:
                t_evt = float(ts[arrived - 1]) if arrived > 0 else t_base
            batch = self.shelf.take(thr)
            self._cycle += 1
            consumed += thr
            self._send(t_evt, batch, self.strategy.failure_prob, 0)

    # -- rule-based path -----------------------------------------------------
    def on_round_complete(self, t: float, clock: "VirtualClock") -> None:
        """Called when a task round completes; schedules rule-based dispatch."""
        strat = self.strategy
        if isinstance(strat, TimeIntervalStrategy):
            strat = strat.discretize(len(self.shelf))
        if not isinstance(strat, TimePointStrategy):
            return
        base = t if strat.relative else 0.0
        for p in strat.points:
            clock.schedule(
                base + p.t,
                lambda pt=p, bt=base: self._dispatch_point(bt + pt.t, pt),
            )

    def _dispatch_point(self, t: float, p) -> None:
        batch = self.shelf.take(p.count)
        self._send(t, batch, p.failure_prob, p.random_discard)

    def _send(
        self, t: float, batch: list, failure_prob: float, random_discard: int
    ) -> None:
        # ``batch`` is a mixed list of Message items and ArrivalBatch slices.
        # Scalar items keep the historical draw-for-draw RNG consumption
        # (restored dispatchers replay identical timelines); batch items
        # draw vectorized masks — one ``random(n)`` per slice.
        if random_discard > 0 and batch:
            n_rows = sum(_item_rows(it) for it in batch)
            k = min(random_discard, n_rows)
            drop = np.zeros(n_rows, bool)
            drop[self.rng.choice(n_rows, size=k, replace=False)] = True
            kept: list = []
            base = 0
            dropped = 0
            for it in batch:
                if isinstance(it, ArrivalBatch):
                    keep = ~drop[base:base + it.n]
                    base += it.n
                    dropped += int(it.n - keep.sum())
                    if keep.all():
                        kept.append(it)
                    elif keep.any():
                        kept.append(it.select(np.flatnonzero(keep)))
                else:
                    if drop[base]:
                        dropped += 1
                    else:
                        kept.append(it)
                    base += 1
            self.shelf.total_dropped += dropped
            batch = kept
        for it in batch:
            if isinstance(it, ArrivalBatch):
                if failure_prob > 0.0 and it.n:
                    keep = self.rng.random(it.n) >= failure_prob
                    self.shelf.total_dropped += int(it.n - keep.sum())
                    if not keep.any():
                        continue
                    if not keep.all():
                        it = it.select(np.flatnonzero(keep))
                self.shelf.total_dispatched += it.n
                self.shelf.total_bytes_dispatched += it.total_bytes
                self.deliver(Delivery(t=t, batch=it))
                continue
            if failure_prob > 0.0 and self.rng.random() < failure_prob:
                self.shelf.total_dropped += 1
                continue
            self.shelf.total_dispatched += 1
            self.shelf.total_bytes_dispatched += it.size_bytes
            self.deliver(Delivery(t=t, message=it))

    # -- checkpointing hooks -----------------------------------------------
    def state_dict(self) -> dict:
        """Dispatch-progress state: the accumulated-strategy threshold cursor
        and the failure/discard RNG stream (so restores don't replay it)."""
        return {"cycle": self._cycle, "rng": self.rng.bit_generator.state}

    def load_state_dict(self, d: dict) -> None:
        self._cycle = int(d["cycle"])
        self.rng.bit_generator.state = d["rng"]


class VirtualClock:
    """Deterministic event loop over virtual seconds."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._tie = itertools.count()
        self.now = 0.0

    def schedule(self, t: float, fn: Callable[[], None]) -> None:
        if t < self.now - 1e-12:
            # A past timestamp means some component computed an event time
            # from stale state; clamping keeps production runs monotone,
            # the sanitizer makes the stale computation fail loudly.
            if sanitizers.enabled():
                raise sanitizers.ClockMonotonicityError(
                    f"schedule at t={t!r} is in the virtual past "
                    f"(now={self.now!r})")
            t = self.now
        heapq.heappush(self._heap, (t, next(self._tie), fn))

    def run_until(self, t_end: float = float("inf")) -> None:
        while self._heap and self._heap[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            fn()
        self.now = max(self.now, min(t_end, self.now) if t_end == float("inf") else t_end)

    def next_time(self) -> float | None:
        """Timestamp of the earliest pending event (None when idle)."""
        return self._heap[0][0] if self._heap else None

    def run_one(self) -> bool:
        """Execute only the earliest pending event; False when idle.

        Single-stepping hook for event-boundary logic (the task engine's
        admission checks run between events, not between rounds).
        """
        if not self._heap:
            return False
        t, _, fn = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        fn()
        return True

    def advance(self, dt: float) -> None:
        """Run every event inside the next ``dt`` virtual seconds and leave
        ``now`` at the end of the window (serial round accounting)."""
        if dt < 0:
            raise ValueError("cannot advance the clock backwards")
        self.run_until(self.now + dt)

    def pending(self) -> int:
        return len(self._heap)


class DeviceFlow:
    """Facade wiring Sorter → Shelf → Dispatcher → cloud service."""

    def __init__(
        self,
        deliver: Callable[[Delivery], None],
        *,
        clock: VirtualClock | None = None,
        seed: int = 0,
    ):
        self.clock = clock or VirtualClock()
        self._deliver = deliver
        self._shelves: dict[int, Shelf] = {}
        self._dispatchers: dict[int, Dispatcher] = {}
        self._strategies: dict[int, DispatchStrategy] = {}
        self._seed = seed

    # -- Strategy module ------------------------------------------------------
    def register_task(self, task_id: int, strategy: DispatchStrategy) -> None:
        if task_id in self._shelves:
            raise ValueError(f"task {task_id} already registered with DeviceFlow")
        shelf = Shelf(task_id)
        self._shelves[task_id] = shelf
        self._strategies[task_id] = strategy
        self._dispatchers[task_id] = Dispatcher(
            shelf, strategy, self._deliver, seed=self._seed
        )

    # -- Sorter ----------------------------------------------------------------
    def submit(self, msg: Message, t: float | None = None) -> None:
        """Sorter entry point: route by task_id, trigger accumulated dispatch.

        Stamps ``Message.created_t`` at submit time (when not pre-stamped by
        the producer) so delivery latency ``Delivery.t - created_t`` reflects
        real shelf queuing delay.
        """
        t = self.clock.now if t is None else t
        try:
            shelf = self._shelves[msg.task_id]
        except KeyError:
            raise KeyError(
                f"message for unregistered task {msg.task_id}"
            ) from None
        if msg.created_t is None:
            msg = dataclasses.replace(msg, created_t=t)
        shelf.put(msg)
        self._dispatchers[msg.task_id].on_message(t)

    def submit_many(self, msgs: Iterable[Message],
                    ts: "np.ndarray | Sequence[float] | None" = None) -> None:
        """Bulk Sorter fast path: route once per task, not once per message.

        ``ts`` (optional) gives per-message arrival times — e.g. the fleet-
        sampled round durations from the simulation tiers.  Within each task
        messages are shelved in arrival-time order and the accumulated
        dispatcher fires once per threshold crossing, timestamped at the
        message that crossed it — identical semantics to per-message
        ``submit`` in time order, minus the per-message Python overhead.
        """
        msgs = list(msgs)
        if not msgs:
            return
        now = self.clock.now
        if ts is None:
            ts_arr = np.full(len(msgs), now, dtype=float)
        else:
            ts_arr = np.asarray(ts, dtype=float)
            if ts_arr.shape != (len(msgs),):
                raise ValueError("ts must align 1:1 with msgs")
        by_task: dict[int, list[int]] = {}
        for i, m in enumerate(msgs):
            by_task.setdefault(m.task_id, []).append(i)
        for tid, idxs in by_task.items():
            try:
                shelf = self._shelves[tid]
            except KeyError:
                raise KeyError(f"message for unregistered task {tid}") from None
            order = sorted(idxs, key=lambda i: ts_arr[i])
            stamped = []
            for i in order:
                m, t = msgs[i], float(ts_arr[i])
                if m.created_t is None:
                    m = dataclasses.replace(m, created_t=t)
                stamped.append(m)
            shelf.put_many(stamped)
            self._dispatchers[tid].on_messages(ts_arr[order], t_base=now)

    # -- columnar Sorter fast path -------------------------------------------
    def submit_batch(self, batch: ArrivalBatch,
                     ts: "np.ndarray | Sequence[float] | None" = None) -> None:
        """Submit one columnar ``ArrivalBatch`` (one cohort chunk).

        ``ts`` gives per-row arrival times (defaults to ``clock.now`` for
        every row).  Rows are shelved in arrival order without materializing
        per-row objects; unstamped rows (``created_t`` NaN) are stamped with
        their own arrival time — producer stamps, including 0.0, survive.
        """
        self.submit_arrivals([batch], ts=ts)

    def submit_batches(self, batches: "Iterable[ArrivalBatch]",
                       ts: "np.ndarray | Sequence[float] | None" = None
                       ) -> None:
        """Bulk columnar submit: all batches merge into one globally
        arrival-ordered shelf segment per task (``ts`` concatenates the
        per-batch row times, in batch order)."""
        self.submit_arrivals(list(batches), ts=ts)

    def submit_arrivals(self, items: "Sequence[ArrivalBatch | Message]",
                        ts: "np.ndarray | Sequence[float] | None" = None
                        ) -> None:
        """Mixed-plane Sorter entry: columnar batches and scalar messages in
        one call, globally merged by arrival time per task.

        Dispatch-group membership and threshold-crossing timestamps match
        per-message submits in time order exactly; only O(items + dispatch
        events) Python work is done, never O(rows).
        """
        items = [it for it in items if _item_rows(it)]
        if not items:
            return
        sizes = [_item_rows(it) for it in items]
        n_total = sum(sizes)
        now = self.clock.now
        if ts is None:
            ts_arr = np.full(n_total, now, dtype=float)
        else:
            ts_arr = np.asarray(ts, dtype=float)
            if ts_arr.shape != (n_total,):
                raise ValueError(
                    f"ts must align 1:1 with the {n_total} submitted rows")
        offsets = np.concatenate(([0], np.cumsum(sizes)))
        by_task: dict[int, list[int]] = {}
        for i, it in enumerate(items):
            by_task.setdefault(it.task_id, []).append(i)
        for tid, idxs in by_task.items():
            try:
                shelf = self._shelves[tid]
            except KeyError:
                raise KeyError(f"message for unregistered task {tid}") from None
            sources: list = []
            parts_ts: list[np.ndarray] = []
            for i in idxs:
                it = items[i]
                tpart = ts_arr[offsets[i]:offsets[i + 1]]
                if isinstance(it, ArrivalBatch):
                    order = np.argsort(tpart, kind="stable")
                    tpart = tpart[order]
                    sources.append(it.select(order).stamp(tpart))
                else:
                    if it.created_t is None:
                        it = dataclasses.replace(it, created_t=float(tpart[0]))
                    sources.append([it])
                parts_ts.append(tpart)
            cat_ts = np.concatenate(parts_ts)
            src_of = np.concatenate(
                [np.full(len(tp), j, np.int32)
                 for j, tp in enumerate(parts_ts)])
            order = np.argsort(cat_ts, kind="stable")
            shelf.put_group(_BatchGroup(sources, src_of[order]))
            self._dispatchers[tid].on_messages(cat_ts[order], t_base=now)

    # -- round boundaries --------------------------------------------------------
    def round_complete(self, task_id: int, t: float | None = None) -> None:
        t = self.clock.now if t is None else t
        self._dispatchers[task_id].on_round_complete(t, self.clock)

    # -- introspection -------------------------------------------------------------
    def shelf(self, task_id: int) -> Shelf:
        return self._shelves[task_id]

    def run(self, t_end: float = float("inf")) -> None:
        self.clock.run_until(t_end)

    def conservation_ok(self, task_id: int) -> bool:
        """Invariant: received == dispatched + dropped + still-pending.
        All four terms count *rows*, so the invariant spans both planes
        (scalar messages and columnar batch rows) uniformly."""
        s = self._shelves[task_id]
        return s.total_received == s.total_dispatched + s.total_dropped + len(s)

    # -- checkpointing ----------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            tid: {"shelf": s.state_dict(),
                  "dispatcher": self._dispatchers[tid].state_dict()}
            for tid, s in self._shelves.items()
        }

    def load_state_dict(self, d: dict) -> None:
        for tid, sd in d.items():
            # Accept both the nested format and legacy shelf-only dicts.
            shelf_sd = sd["shelf"] if "shelf" in sd else sd
            shelf = Shelf.from_state_dict(shelf_sd)
            self._shelves[tid] = shelf
            if tid in self._strategies:
                disp = Dispatcher(
                    shelf, self._strategies[tid], self._deliver, seed=self._seed
                )
                if "dispatcher" in sd:
                    disp.load_state_dict(sd["dispatcher"])
                self._dispatchers[tid] = disp
