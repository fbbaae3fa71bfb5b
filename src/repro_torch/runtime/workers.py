"""Multi-process fleet execution: sharded worker pool, zero-copy transport.

The platform otherwise runs in ONE Python process on one ``VirtualClock``.
This module is the coordinator/worker control plane that splits *cohort
execution* across N worker processes while the coordinator keeps everything
stateful and time-authoritative (``TaskEngine``, ``DeviceFlow``,
``AggregationService``, fleet sampling, arrival stamping) in one place:

* **Workers compute, the coordinator decides.**  A round's cohort chunks —
  the exact ``(lo, hi)`` ranges and per-chunk rng seeds the single-process
  engine would have run — are dispatched to workers (chunk ``i`` goes to
  worker ``i % N``, a stable fleet-shard assignment that keeps int8
  error-feedback residuals with "their" devices across rounds).  Each
  worker runs the tiers' cohort functions (``run_cohort_zero_copy`` /
  ``run_cohort_quantized``) on tiers rebuilt from a picklable
  :class:`WorkerSpec` factory, on the coordinator's device: on a card,
  every worker opens its own CUDA context on it.

* **Zero-copy columnar transport.**  Results come back as the *existing*
  struct-of-arrays wire format: the chunk's ``UpdateBuffer`` leaves (int8 or
  f32, plus scale columns) are written into a ``multiprocessing
  .shared_memory`` segment in a canonical layout both sides compute from the
  update spec, and only a slim ``(call, chunk, shm_name, rows)`` header
  crosses the pipe — no pickling of model data.  On the CPU the coordinator
  wraps the segment's views in an ordinary ``UpdateBuffer``; on a card it
  copies them onto the simulation's device first, so aggregation launches
  ``fed_reduce`` on card tensors exactly as inline rounds do.  Byte
  accounting (``row_nbytes`` → ``Shelf.total_bytes_*``) is untouched.

* **Recycled segment ring.**  Workers keep a free-list of segments and reuse
  one as soon as the coordinator releases it.  On the CPU release is
  GC-driven: a ``weakref.finalize`` on each coordinator-side
  ``UpdateBuffer`` sends ``("free", name)`` back to the owning worker once
  the buffer is collected (aggregation consumed the round and dropped its
  handles).  Lifetime rule: anything read out of such a buffer must be
  *copied* before the buffer is dropped — ``materialize`` /
  ``materialize_row`` already copy.  On a card the segment is released as
  soon as its rows are copied to the device (at the end of the call).

* **Graceful worker death.**  A worker dying mid-round (EOF on its pipe)
  does not hang the round barrier: its still-pending chunks are re-assigned
  to the survivors through ``runtime.fault_tolerance.redispatch_chunks`` and
  the failure is recorded on ``pool.failures``.  Re-dispatched int8 chunks
  restart their error-feedback residual from zero (the residual died with
  the worker) — the same semantics as a fresh device joining the fleet.

Determinism: the coordinator draws each chunk's seed by walking the exact
single-process chunk plan (one ``fork`` of the round generator per chunk)
and reassembles results in chunk order before submission, so a
multi-process round is **bit-identical** to the single-process columnar
round — dispatch-group membership, ``created_t`` stamps, byte counters and
the reduced delta (``tests/test_torch_workers.py``).  With
``stream_chunks=True`` too: the reference emits in *completion* order there,
to overlap streaming partial reduction with still-running shards, but the
port keeps chunk order (the workers share one card, and the coordinator's
dispatcher sets the pace), so streamed pooled rounds stay bit-identical.

``HybridSimulation(workers=N, worker_spec=WorkerSpec(factory, ...))``
selects this path; see ``examples/quickstart.py`` section 11.
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback
import weakref
from multiprocessing import connection as mp_connection
from multiprocessing import shared_memory
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.analysis import sanitizers
from repro_torch.core.updates import np_dtype
from repro_torch.device import resolve_device
from repro_torch.runtime.fault_tolerance import WorkerFailure, redispatch_chunks

_ALIGN = 64  # segment field alignment (cache line; numpy view friendly)


class WorkerPoolError(RuntimeError):
    """Raised when the pool cannot make progress (all workers dead, a
    worker raised, or the round barrier timed out)."""


def _align(off: int) -> int:
    return (off + _ALIGN - 1) & ~(_ALIGN - 1)


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to a segment another process created.

    The resource tracker is one process shared by the whole tree and its
    cache is a *set*: the attach-side ``register`` is a no-op while the
    creator's entry exists, and the creator's eventual ``unlink`` clears it
    exactly once.  Unregistering here would instead erase the creator's
    entry and make its unlink crash the tracker — so: attach, and leave the
    tracker alone.
    """
    return shared_memory.SharedMemory(name=name)


def _view(buf, offset: int, shape: tuple, dtype: Any) -> np.ndarray:
    return np.ndarray(shape, np_dtype(dtype), buffer=buf, offset=offset)


def segment_layout(shapes: Sequence[tuple], dtypes: Sequence[Any],
                   rows: int, wire: str) -> tuple[list, int]:
    """Canonical shared-memory layout of one chunk's ``UpdateBuffer``.

    Both sides compute this independently from the update spec — the pipe
    header never carries shapes or dtypes.  Layout: every leaf as its
    ``(rows, size)`` wire matrix (int8 for the quantized wire), then — int8
    only — one f32 ``(rows,)`` scale column per leaf, each field aligned to
    64 bytes.  Returns ``([(offset, shape, dtype), ...], total_bytes)`` with
    leaf fields first, scale fields after, in leaf order.
    """
    entries: list[tuple[int, tuple, np.dtype]] = []
    off = 0
    for shape, dt in zip(shapes, dtypes):
        size = int(np.prod(shape)) if shape else 1
        leaf_dt = np.dtype(np.int8) if wire == "int8" else np_dtype(dt)
        off = _align(off)
        entries.append((off, (rows, size), leaf_dt))
        off += rows * size * leaf_dt.itemsize
    if wire == "int8":
        for _ in shapes:
            off = _align(off)
            entries.append((off, (rows,), np.dtype(np.float32)))
            off += rows * 4
    return entries, max(_align(off), _ALIGN)


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Picklable recipe for rebuilding the simulation tiers inside a worker.

    ``factory(**kwargs)`` must be a *module-level* callable (spawn pickles it
    by reference) returning ``(logical_tier, {grade: device_tier})`` built
    exactly like the coordinator's tiers — same local_train, dtypes, cohort
    sizes and device — so worker-computed chunks are bit-identical to
    inline ones.  Workers compute on the pool's device, and a worker whose
    tiers sit elsewhere raises.  ``env`` entries are applied to ``os.environ`` before the
    factory runs in the child (e.g. to pin host threads per worker).
    """

    factory: Callable[..., tuple]
    kwargs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    env: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def build(self) -> tuple:
        logical, tiers = self.factory(**dict(self.kwargs))
        return logical, dict(tiers)


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """One cohort chunk of a round: the same (range, seed) the inline engine
    would run.  ``kind`` selects the tier: ``"logical"`` or a grade name.
    ``seed`` is the int the chunk's generator fork drew: the worker rebuilds
    ``torch.Generator().manual_seed(seed)`` and draws the chunk's per-device
    seeds from it, as the inline chunk does."""

    index: int
    kind: str
    lo: int
    hi: int
    seed: int
    id_offset: int = 0

    @property
    def rows(self) -> int:
        return self.hi - self.lo


def _tree_desc(tree: Mapping, offset: int) -> tuple[dict, int, list]:
    """Describe a dict of tensors or arrays for shared-memory transport:
    the sorted keys and per-leaf (offset, shape, dtype) entries.  Returns
    (desc, next_offset, leaves)."""
    keys = sorted(tree)
    leaves = [tree[k] for k in keys]
    entries = []
    for leaf in leaves:
        dt = np_dtype(leaf.dtype)
        shape = tuple(int(s) for s in leaf.shape)
        offset = _align(offset)
        entries.append((offset, shape, str(dt)))
        offset += int(np.prod(shape)) * dt.itemsize if shape else dt.itemsize
    return {"keys": keys, "leaves": entries}, offset, leaves


def _tree_from_desc(desc: dict, buf) -> dict:
    """Rebuild the dict as numpy views over a shared-memory buffer."""
    return {k: _view(buf, off, shape, dts)
            for k, (off, shape, dts) in zip(desc["keys"], desc["leaves"])}


def _update_spec(buf) -> tuple:
    return (tuple(buf.keys), [tuple(s) for s in buf.shapes],
            [str(d) for d in buf.dtypes])


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------
class _WorkerState:
    """Everything a worker process owns: lazily-built tiers, error-feedback
    residuals for "its" device rows, and the recycled ring of result
    segments."""

    def __init__(self, worker_id: int, spec: WorkerSpec, delay_s: float):
        self.worker_id = worker_id
        self.spec = spec
        self.delay_s = delay_s  # test hook: interleaving jitter per chunk
        self.logical = None
        self.tiers: dict = {}
        self._ef: dict = {}
        self._free: list[shared_memory.SharedMemory] = []
        self._created: dict[str, shared_memory.SharedMemory] = {}
        self._park_close: list = []  # input segs with still-exported views
        self.fail_after: int | None = None  # test hook: die after N chunks
        self._sent = 0
        self.busy_s = 0.0  # host seconds spent running chunks

    def _tier(self, kind: str, device: torch.device):
        if self.logical is None:
            self.logical, self.tiers = self.spec.build()
            for name, t in (("logical", self.logical), *self.tiers.items()):
                if t.device != device:
                    raise WorkerPoolError(
                        f"worker {self.worker_id}: the factory built tier "
                        f"{name!r} on {t.device}, but the worker computes "
                        f"on {device}")
        return self.logical if kind == "logical" else self.tiers[kind]

    def _acquire(self, nbytes: int) -> shared_memory.SharedMemory:
        for i, seg in enumerate(self._free):
            if seg.size >= nbytes:
                return self._free.pop(i)
        seg = shared_memory.SharedMemory(create=True, size=nbytes)
        self._created[seg.name] = seg
        return seg

    def release(self, name: str) -> None:
        seg = self._created.get(name)
        if seg is not None and all(s.name != name for s in self._free):
            self._free.append(seg)

    def _drain_parked(self) -> None:
        still = []
        for seg in self._park_close:
            try:
                seg.close()
            except BufferError:
                still.append(seg)
        self._park_close = still

    def run(self, conn, call_id: int, input_desc: dict,
            chunks: list[ChunkSpec], common: dict) -> None:
        from repro_torch.core.simulation import device_seeds

        t0 = time.perf_counter()
        self._drain_parked()
        device = torch.device(common["device"])
        seg = _attach_shm(input_desc["name"])
        try:
            params_np = _tree_from_desc(input_desc["params"], seg.buf)
            batches_np = _tree_from_desc(input_desc["batches"], seg.buf)
            # Params go to the device once per call (copied out of the
            # segment); each chunk's rows are copied at its cohort call.
            params = {k: torch.from_numpy(v).to(device, copy=True)
                      for k, v in params_np.items()}
            del params_np
            wire = common["wire"]
            for c in chunks:
                if self.fail_after is not None and self._sent >= self.fail_after:
                    os._exit(1)  # test hook: simulated mid-round crash
                tier = self._tier(c.kind, device)
                chunk = {k: torch.from_numpy(v[c.lo:c.hi]).to(device,
                                                              copy=True)
                         for k, v in batches_np.items()}
                rngs = device_seeds(torch.Generator().manual_seed(c.seed),
                                    c.rows)
                if wire == "int8":
                    ef_key = (common["task_id"], c.kind,
                              c.id_offset + c.lo, c.id_offset + c.hi)
                    buf, metrics, res = tier.run_cohort_quantized(
                        params, chunk, rngs,
                        residual=self._ef.get(ef_key),
                        error_feedback=common["error_feedback"])
                    if common["error_feedback"]:
                        self._ef[ef_key] = res
                else:
                    buf, metrics = tier.run_cohort_zero_copy(
                        params, chunk, rngs)
                del chunk
                if _update_spec(buf) != tuple(common["specs"][c.kind]):
                    raise WorkerPoolError(
                        f"chunk {c.index}: update spec {_update_spec(buf)} "
                        f"differs from the coordinator's "
                        f"{common['specs'][c.kind]}")
                entries, total = segment_layout(
                    buf.shapes, buf.dtypes, buf.num_rows, wire)
                out = self._acquire(total)
                arrays = list(buf.leaves2d) + list(buf.scales or ())
                for (off, shape, dt), src in zip(entries, arrays):
                    dst = torch.from_numpy(_view(out.buf, off, shape, dt))
                    dst.copy_(src)
                    del dst
                if self.delay_s:
                    time.sleep(self.delay_s)
                conn.send(("batch", call_id, c.index, out.name,
                           buf.num_rows,
                           {k: v.cpu().numpy() for k, v in metrics.items()}))
                self._sent += 1
        finally:
            try:
                del batches_np
            except NameError:
                pass
            try:
                seg.close()
            except BufferError:  # a view outlived the call; retry later
                self._park_close.append(seg)
            self.busy_s += time.perf_counter() - t0

    def stats(self) -> dict:
        """The worker's device, its peak allocated bytes there (on a card),
        its segment count and the host seconds it spent running chunks."""
        dev = None if self.logical is None else self.logical.device
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev is not None and dev.type == "cuda" else None)
        return {"device": None if dev is None else str(dev),
                "peak_allocated_bytes": peak,
                "segments": len(self._created), "busy_s": self.busy_s}

    def cleanup(self) -> None:
        for seg in self._created.values():
            try:
                seg.close()
            except BufferError:
                pass
            try:
                seg.unlink()
            except FileNotFoundError:
                pass


def _worker_main(worker_id: int, conn, spec: WorkerSpec,
                 delay_s: float) -> None:
    os.environ.update(dict(spec.env))
    state = _WorkerState(worker_id, spec, delay_s)
    try:
        conn.send(("ready", worker_id))
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break  # coordinator gone
            tag = msg[0]
            if tag == "stop":
                break
            elif tag == "free":
                state.release(msg[1])
            elif tag == "poison":
                state.fail_after = msg[1]
            elif tag == "stats":
                conn.send(("stats", worker_id, state.stats()))
            elif tag == "run":
                _, call_id, input_desc, chunks, common = msg
                try:
                    state.run(conn, call_id, input_desc, chunks, common)
                except Exception:
                    conn.send(("error", call_id, -1, traceback.format_exc()))
    finally:
        state.cleanup()


# ---------------------------------------------------------------------------
# Coordinator side
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _WorkerHandle:
    worker_id: int
    proc: Any
    conn: Any
    alive: bool = True
    announced: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _Seg:
    shm: shared_memory.SharedMemory
    owner: int


class FleetWorkerPool:
    """Coordinator handle on N spawned cohort workers.

    ``device`` is where the workers compute and where pooled results land
    (the simulation's device; the default ``"cuda"`` raises without a card
    unless ``"cpu"`` is passed).
    Processes start lazily on the first :meth:`run_chunks` (spawn context —
    forking a process that has initialized CUDA is unsafe) and are daemons,
    so a crashed coordinator never strands them.  See the module docstring
    for the transport/recycling/fault model.
    """

    def __init__(self, spec: WorkerSpec, num_workers: int, *,
                 device="cuda",
                 chunk_timeout_s: float = 600.0,
                 start_timeout_s: float = 120.0,
                 debug_delay_s: Sequence[float] | None = None):
        if num_workers < 1:
            raise ValueError("need at least one worker")
        self.device = resolve_device(device)
        self.spec = spec
        self.num_workers = int(num_workers)
        self.chunk_timeout_s = float(chunk_timeout_s)
        self.start_timeout_s = float(start_timeout_s)
        self._debug_delay_s = tuple(debug_delay_s or ())
        self._workers: list[_WorkerHandle] = []
        self._segments: dict[str, _Seg] = {}  # held by a live UpdateBuffer
        self._to_close: list[shared_memory.SharedMemory] = []
        self._dead_owner_names: set[str] = set()
        self._call_counter = 0
        self._closed = False
        self.failures: list = []
        self.stats = {"calls": 0, "chunks": 0, "segments_created": 0,
                      "segment_reuses": 0, "redispatched_chunks": 0,
                      "bytes_shipped": 0, "input_bytes": 0}

    # -- lifecycle ---------------------------------------------------------
    @property
    def started(self) -> bool:
        return bool(self._workers)

    def start(self) -> None:
        if self._workers or self._closed:
            return
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        for wid in range(self.num_workers):
            parent, child = ctx.Pipe()
            delay = (self._debug_delay_s[wid % len(self._debug_delay_s)]
                     if self._debug_delay_s else 0.0)
            proc = ctx.Process(target=_worker_main,
                               args=(wid, child, self.spec, delay),
                               daemon=True, name=f"fleet-worker-{wid}")
            proc.start()
            child.close()
            self._workers.append(_WorkerHandle(wid, proc, parent))
        deadline = time.monotonic() + self.start_timeout_s
        for h in self._workers:
            remaining = max(0.1, deadline - time.monotonic())
            if not h.conn.poll(remaining):
                self.close()
                raise WorkerPoolError(
                    f"worker {h.worker_id} did not report ready within "
                    f"{self.start_timeout_s}s")
            tag = h.conn.recv()
            if tag[0] != "ready":  # pragma: no cover - defensive
                self.close()
                raise WorkerPoolError(f"bad handshake from {h.worker_id}")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for h in self._workers:
            if h.alive:
                try:
                    h.conn.send(("stop",))
                except (BrokenPipeError, OSError):
                    pass
        for h in self._workers:
            h.proc.join(timeout=5.0)
            if h.proc.is_alive():  # pragma: no cover - defensive
                h.proc.terminate()
                h.proc.join(timeout=5.0)
            try:
                h.conn.close()
            except OSError:
                pass
            h.alive = False
        # Names the (now exited) workers no longer own: make sure nothing
        # lingers in /dev/shm.  Held mappings stay valid for live buffers.
        for name, seg in self._segments.items():
            try:
                seg.shm.unlink()
            except FileNotFoundError:
                pass
        self._drain_closes()
        if sanitizers.enabled() and self._to_close:
            # A segment that cannot unmap at teardown means an exported
            # view outlived its UpdateBuffer — the lifetime rule in this
            # module's docstring.  Unlinked above, so /dev/shm is clean;
            # the mapping itself leaks until the view dies.
            names = sorted(shm.name for shm in self._to_close)
            raise sanitizers.SegmentLeakError(
                f"{len(names)} shared-memory segment(s) still pinned at "
                f"pool teardown (views outlived their buffers): {names}")

    def __enter__(self) -> "FleetWorkerPool":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- segment bookkeeping ----------------------------------------------
    def _drain_closes(self) -> None:
        still = []
        for shm in self._to_close:
            try:
                shm.close()
            except BufferError:
                still.append(shm)
        self._to_close = still

    def _release_segment(self, name: str) -> None:
        """The coordinator is done with segment ``name`` (its buffer was
        collected, or its rows were copied to the card): hand it back to
        its worker's free ring."""
        entry = self._segments.pop(name, None)
        if entry is None:
            return
        if not self._closed and name not in self._dead_owner_names:
            h = self._workers[entry.owner]
            if h.alive:
                try:
                    h.conn.send(("free", name))
                except (BrokenPipeError, OSError):
                    pass
        # The buffer's views die right after this callback; close then.
        self._to_close.append(entry.shm)

    def _reap_worker_segments(self, h: _WorkerHandle) -> None:
        """A worker died: unlink every segment it ever announced.  Held
        mappings (live buffers) stay readable — unlink only drops the name."""
        for name in h.announced:
            self._dead_owner_names.add(name)
            entry = self._segments.get(name)
            try:
                shm = entry.shm if entry is not None else _attach_shm(name)
                shm.unlink()
                if entry is None:
                    shm.close()
            except (FileNotFoundError, OSError):
                pass

    # -- round execution ---------------------------------------------------
    def _write_input(self, params: Mapping, batches: Mapping) -> tuple:
        """One input segment holding ``params`` and the grade's stacked
        ``batches``; card leaves are copied off the card here."""
        off = 0
        p_desc, off, p_leaves = _tree_desc(params, off)
        b_desc, off, b_leaves = _tree_desc(batches, off)
        shm = shared_memory.SharedMemory(create=True, size=max(off, _ALIGN))
        try:
            for desc, leaves in ((p_desc, p_leaves), (b_desc, b_leaves)):
                for (o, shape, dts), leaf in zip(desc["leaves"], leaves):
                    dst = _view(shm.buf, o, shape, dts)
                    if isinstance(leaf, torch.Tensor):
                        torch.from_numpy(dst).copy_(leaf.detach())
                    else:
                        np.copyto(dst, np.asarray(leaf))
                    del dst
        except BaseException:
            shm.close()
            shm.unlink()
            raise
        self.stats["input_bytes"] += int(off)
        return shm, {"name": shm.name, "params": p_desc, "batches": b_desc}

    def _wrap_result(self, h: _WorkerHandle, seg_name: str, rows: int,
                     chunk: ChunkSpec, spec: tuple, wire: str,
                     to_free: list):
        """A worker's result segment as an ordinary ``UpdateBuffer``.

        On the CPU its leaves are zero-copy views of the segment and a GC
        finalizer recycles the segment back to the worker.  On a card the
        rows are copied onto the pool's device, so aggregation reduces them
        with the kernel, and the segment is released (``to_free``) once the
        call ends — after the copy, which returns only when the segment may
        be reused."""
        from repro_torch.core.updates import UpdateBuffer

        keys, shapes, dtypes = spec
        if rows != chunk.rows:  # pragma: no cover - defensive
            raise WorkerPoolError(
                f"worker {h.worker_id} returned {rows} rows for chunk "
                f"{chunk.index} ({chunk.rows} expected)")
        if seg_name in h.announced:
            self.stats["segment_reuses"] += 1
        else:
            h.announced.add(seg_name)
            self.stats["segments_created"] += 1
        entries, total = segment_layout(shapes, dtypes, rows, wire)
        shm = _attach_shm(seg_name)
        self._segments[seg_name] = _Seg(shm, h.worker_id)
        self.stats["bytes_shipped"] += int(total)
        fields = [torch.from_numpy(_view(shm.buf, off, shape, dt))
                  for off, shape, dt in entries]
        if self.device.type != "cpu":
            fields = [f.to(self.device) for f in fields]
            to_free.append(seg_name)
        n_leaves = len(shapes)
        buf = UpdateBuffer(
            fields[:n_leaves], keys, shapes, dtypes, wire=wire,
            scales=fields[n_leaves:] if wire == "int8" else None)
        if self.device.type == "cpu":
            weakref.finalize(buf, self._release_segment, seg_name)
        return buf

    def _on_worker_death(self, h: _WorkerHandle, call_id: int,
                         input_desc: dict, common: dict,
                         expected: dict, pending: dict) -> None:
        h.alive = False
        try:
            h.conn.close()
        except OSError:
            pass
        h.proc.join(timeout=1.0)
        self._reap_worker_segments(h)
        lost = sorted(pending.pop(h.worker_id, set()) & set(expected))
        survivors = [w.worker_id for w in self._workers if w.alive]
        assignment = redispatch_chunks(lost, survivors) if lost else {}
        for wid, idxs in assignment.items():
            self._workers[wid].conn.send(
                ("run", call_id, input_desc, [expected[i] for i in idxs],
                 common))
            pending.setdefault(wid, set()).update(idxs)
        self.stats["redispatched_chunks"] += len(lost)
        self.failures.append(WorkerFailure(
            worker_id=h.worker_id, chunks=tuple(lost),
            survivors=tuple(survivors)))

    def run_chunks(self, *, task_id: int, round_idx: int, params: Mapping,
                   batches: Mapping, chunks: Sequence[ChunkSpec],
                   specs_by_kind: Mapping[str, tuple], wire: str = "f32",
                   error_feedback: bool = True) -> list:
        """Execute one grade's cohort chunks across the pool.

        Ships ``params`` + the grade's stacked ``batches`` once through a
        per-call input segment, dispatches every chunk to its worker, and
        gathers ``(UpdateBuffer, metrics)`` per chunk — returned in CHUNK
        order (the bit-identical reassembly).  ``specs_by_kind`` gives each
        tier's update spec ``(keys, shapes, dtypes)``, from which both sides
        compute the segment layout.
        """
        if self._closed:
            raise WorkerPoolError("pool is closed")
        self.start()
        self._drain_closes()
        chunks = list(chunks)
        if not chunks:
            return []
        call_id = self._call_counter
        self._call_counter += 1
        self.stats["calls"] += 1
        alive = [h for h in self._workers if h.alive]
        if not alive:
            raise WorkerPoolError("no live workers")
        input_shm, input_desc = self._write_input(params, batches)
        specs = {kind: (tuple(k), [tuple(s) for s in sh],
                        [str(np_dtype(d)) for d in dt])
                 for kind, (k, sh, dt) in specs_by_kind.items()}
        common = {"task_id": int(task_id), "round_idx": int(round_idx),
                  "wire": wire, "error_feedback": bool(error_feedback),
                  "device": str(self.device), "specs": specs}
        to_free: list[str] = []
        try:
            # Stable fleet-shard assignment: chunk i -> worker i % N keeps
            # each row range (and its EF residual) with the same worker
            # across rounds; a dead worker's chunks fall to survivors.
            assign: dict[int, list[ChunkSpec]] = {}
            for c in chunks:
                h = self._workers[c.index % self.num_workers]
                if not h.alive:
                    h = alive[c.index % len(alive)]
                assign.setdefault(h.worker_id, []).append(c)
            pending: dict[int, set] = {}
            for wid, cs in assign.items():
                self._workers[wid].conn.send(
                    ("run", call_id, input_desc, cs, common))
                pending[wid] = {c.index for c in cs}
            expected = {c.index: c for c in chunks}
            results: dict[int, tuple] = {}
            deadline = time.monotonic() + self.chunk_timeout_s
            while expected:
                conns = {h.conn: h for h in self._workers if h.alive}
                if not conns:
                    raise WorkerPoolError(
                        f"all workers dead with {len(expected)} chunks "
                        f"outstanding")
                ready = mp_connection.wait(list(conns), timeout=1.0)
                if not ready:
                    for h in list(conns.values()):
                        if not h.proc.is_alive():
                            self._on_worker_death(h, call_id, input_desc,
                                                  common, expected, pending)
                    if time.monotonic() > deadline:
                        raise WorkerPoolError(
                            f"round barrier timed out with {len(expected)} "
                            f"chunks outstanding")
                    continue
                for conn in ready:
                    h = conns[conn]
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError):
                        self._on_worker_death(h, call_id, input_desc,
                                              common, expected, pending)
                        continue
                    tag = msg[0]
                    if tag == "batch":
                        _, cid, index, seg_name, rows, metrics = msg
                        if cid != call_id or index not in expected:
                            continue  # stale duplicate (redispatch race)
                        c = expected.pop(index)
                        pending.get(h.worker_id, set()).discard(index)
                        buf = self._wrap_result(
                            h, seg_name, rows, c, specs_by_kind[c.kind],
                            wire, to_free)
                        metrics = {k: torch.from_numpy(v).to(self.device)
                                   for k, v in metrics.items()}
                        results[index] = (buf, metrics)
                        self.stats["chunks"] += 1
                    elif tag == "error":
                        raise WorkerPoolError(
                            f"worker {h.worker_id} raised:\n{msg[3]}")
            return [results[c.index] for c in chunks]
        finally:
            for name in to_free:
                self._release_segment(name)
            self._drain_closes()
            try:
                input_shm.close()
            except BufferError:  # pragma: no cover - defensive
                self._to_close.append(input_shm)
            try:
                input_shm.unlink()
            except FileNotFoundError:  # pragma: no cover - defensive
                pass

    # -- test / fault-injection hooks -------------------------------------
    def poison_worker(self, worker_id: int, fail_after_chunks: int) -> None:
        """Arrange for ``worker_id`` to crash (``os._exit``) after computing
        ``fail_after_chunks`` more chunks — the deterministic kill-a-worker
        fault injection used by the death-handling tests."""
        self.start()
        self._workers[worker_id].conn.send(("poison", fail_after_chunks))

    def worker_stats(self, timeout_s: float = 30.0) -> dict[int, dict]:
        """Each live worker's device, peak allocated bytes there (on a
        card), segment count and host seconds spent running chunks; call
        it between rounds."""
        out = {}
        for h in self._workers:
            if not h.alive:
                continue
            h.conn.send(("stats",))
            deadline = time.monotonic() + timeout_s
            while h.worker_id not in out:
                if not h.conn.poll(max(0.0, deadline - time.monotonic())):
                    raise WorkerPoolError(
                        f"worker {h.worker_id} did not report its stats")
                msg = h.conn.recv()
                if msg[0] == "stats":  # anything else is a stale result
                    out[h.worker_id] = msg[2]
        return out

    @property
    def alive_workers(self) -> list[int]:
        return [h.worker_id for h in self._workers if h.alive]
