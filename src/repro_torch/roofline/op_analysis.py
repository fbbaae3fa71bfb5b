"""Op-level roofline analyzer: a step's flops, bytes and collectives.

The twin of ``repro.roofline.hlo_analysis``.  The reference parses the
optimized HLO of a compiled program and multiplies loop bodies by their
trip counts; the port runs eagerly, so :func:`analyze` runs the program
once under a ``TorchDispatchMode`` and counts every aten op as it runs:
layers and microbatches are counted as executed, and no trip count is
needed.  It returns the keys of ``analyze_hlo`` (``flops``, ``bytes``,
``collective_bytes``, ``collective_count``) and three more: ``kernels``
(``{name: {"calls", "flops", "bytes"}}``), ``temp_bytes`` and
``output_bytes`` (below).

Counting rules:

* **Flops** are ``torch.utils.flop_counter``'s formulas for the matmul,
  convolution and attention ops (``mm``, ``addmm``, ``bmm``, ...): like the
  reference, dot flops only, two per multiply-add.
* **Bytes** of an aten op are its tensor operands (read) plus its tensor
  outputs (written), each counted whole, as the reference counts an HLO
  op's operands plus its outputs.  View and metadata ops move nothing and
  are skipped (``_SKIP_BYTES``, as ``_SKIP_BYTES_OPS`` skips bitcasts),
  and so are allocations without a fill (``empty``).  The in-place rule:
  an in-place op (``add_``) reads its mutated operand and writes it, so it
  counts twice; ``copy_`` reads only its source and writes its target; an
  ``out=`` target counts once, as written.
* **Collectives**: the c10d ops (``allreduce_``, ``allgather_``,
  ``reduce_scatter_``, ``alltoall_`` and their ``_base`` forms) and the
  functional collectives map to the reference's five names
  (:data:`COLLECTIVES`); each adds its operand bytes to
  ``collective_bytes`` and one to ``collective_count``, and its operands and
  outputs to ``bytes``, as the reference adds them.
* **Kernels** are counted once, by formula.  A hand-written kernel's
  wrapper, when an analyzer is armed (one truthiness check of
  :data:`ARMED` when not), records its call's work by the formulas below
  (:func:`kernel_call`) and runs with op counting suspended: the aten ops
  inside it are not counted again, whether they are the plain version on
  the CPU, the allocations around a launch on the card, or the ``meta``
  route.  So a step counts the same work whichever route ran each kernel.
  The formulas are those of the kernels' bounds (``chip_smoke.py`` prints
  them beside each kernel's time): the bytes each must move (inputs read
  once, outputs written once) and the flops it must do for this call's
  shapes (and, for ``decode_attention``, the rows its lengths select).
* **Memory**: ``temp_bytes`` is the peak of the bytes held by storages the
  program allocated while it ran (a kernel call's outputs only, not its
  scratch), beyond what existed before; ``output_bytes`` the distinct
  storages of the returned tensors.  A ``DTensor`` counts as its local
  block: the analyzer sees one rank's program.

:func:`roofline_terms` and :func:`dominant_term` turn the counts into the
reference's three terms with the H100 SXM's data-sheet rates.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

__all__ = [
    "analyze", "kernel_call", "ARMED", "Work", "COLLECTIVES",
    "fed_reduce_work", "decode_attention_work", "decode_rows",
    "causal_pairs", "flash_attention_work", "flash_attention_bwd_work",
    "ssd_scan_work", "ssd_scan_bwd_work", "causal_conv_work",
    "causal_conv_bwd_work", "bound", "roofline_terms",
    "dominant_term", "PEAK_FLOPS", "F32_FLOPS", "HBM_BW", "NVLINK_BW",
]

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# The analyzers running now, innermost last.  A kernel wrapper tests it
# once per call; it is empty unless :func:`analyze` is running.
ARMED: list = []


# --------------------------------------------------------------------------- #
# Per-kernel work
# --------------------------------------------------------------------------- #
class Work(NamedTuple):
    """What one kernel call must do: ``flops`` and ``bytes`` moved."""

    flops: int
    bytes: int


def fed_reduce_work(n: int, d: int, itemsize: int, scaled: bool) -> Work:
    """K1 on an ``(n, d)`` stack: the stack read once, the weights (and the
    scales) read, the f32 sum written; 2 n d flops of the weighted sum plus
    the n products that fold the scales into the weights."""
    return Work(2 * n * d + (n if scaled else 0),
                n * d * itemsize + 4 * n * (2 if scaled else 1) + 4 * d)


def decode_attention_work(b: int, h: int, kv: int, d: int, itemsize: int,
                          rows: int, partial: bool = False) -> Work:
    """K2: ``rows`` cache rows (summed over the batch: what the lengths
    select) read once from K and V, q read and the output written, the
    int32 lengths read; 4 d flops per (row, query head).  K2p
    (``partial``) writes its f32 state instead: o (b, h, d), m and l."""
    out = b * h * (d + 2) * 4 if partial else b * h * d * itemsize
    return Work(4 * rows * h * d,
                2 * rows * kv * d * itemsize + b * h * d * itemsize + out
                + 4 * b)


def decode_rows(lengths: torch.Tensor, s: int) -> int:
    """The cache rows ``lengths`` select (each clamped to ``[0, s]``),
    summed.  A meta tensor has no values: its rows are known only where it
    was made by ``torch.full`` under the armed analyzer, which records the
    fill; anything else raises."""
    if lengths.device.type == "meta":
        for an in reversed(ARMED):
            fill = an.fills.get(lengths)
            if fill is not None:
                return lengths.numel() * min(max(int(fill), 0), s)
        raise ValueError("decode_attention on the meta device counts the rows "
                         "its lengths select; make them with torch.full under "
                         "the analyzer")
    with _suspended():  # the count is the analyzer's own work
        return int(lengths.clamp(0, s).sum())


def causal_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs attention must score: the causal triangle with
    its offset, cut at the key length (query i sees ``min(sk, q_offset + i
    + 1)`` keys)."""
    if not causal:
        return sq * sk
    m = min(max(sk - q_offset, 0), sq)  # rows that see fewer than sk keys
    return m * (q_offset + 1) + m * (m - 1) // 2 + (sq - m) * sk


def flash_attention_work(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                         itemsize: int, causal: bool, q_offset: int,
                         lse: bool = False) -> Work:
    """K3: q, k, v read once and the output (and the f32 log-sum-exp when
    asked) written; 4 d flops per scored pair per head (Q K^T and P V)."""
    return Work(4 * d * h * b * causal_pairs(sq, sk, causal, q_offset),
                2 * (b * sq * h + b * sk * kv) * d * itemsize
                + (4 * b * h * sq if lse else 0))


def flash_attention_bwd_work(b: int, sq: int, sk: int, h: int, kv: int,
                             d: int, itemsize: int, causal: bool,
                             q_offset: int) -> Work:
    """K3b: q, o, dO read and dQ written, k, v read and dK, dV written, the
    log-sum-exp read and D written in f32; 10 d flops per scored pair per
    head (S, dP, dV, dQ and dK)."""
    pairs = causal_pairs(sq, sk, causal, q_offset) * b * h
    return Work(10 * d * pairs,
                (4 * b * sq * h + 4 * b * sk * kv) * d * itemsize
                + 2 * b * h * sq * 4)


def ssd_scan_work(b: int, l: int, h: int, p: int, g: int, n: int, q: int,
                  itemsize: int) -> Work:
    """K4: x, dt, A, B, C read once, y and the f32 state written once; per
    head and chunk, C.B and M.x over the causal triangle, C.S^T and the
    state update."""
    moved = (2 * b * l * h * p * itemsize + 4 * b * l * h + 4 * h
             + 2 * b * l * g * n * itemsize + 4 * b * h * p * n)
    chunks = -(-l // q)
    return Work(2 * b * h * chunks * (q * (q + 1) // 2 * (n + p)
                                      + 2 * q * p * n), moved)


def ssd_scan_bwd_work(b: int, l: int, h: int, p: int, g: int, n: int, q: int,
                      itemsize: int, dstate: bool) -> Work:
    """K4b: x, dy, B, C, dt, A and the state's cotangent read once; dx, dB,
    dC, ddt and dA written once; in multiply-adds, per (batch, group,
    chunk) C B^T (q(q+1)/2 n); per (batch, head, chunk) the state entering
    the chunk and the cotangent leaving it, dS_out B, S_in^T dy and dS_out^T
    x (q p n each), dy x^T and M^T dy (q(q+1)/2 p each) and the two
    q(q+1)/2 n products of dB and dC; two flops per multiply-add."""
    nc = -(-l // q)
    tri = q * (q + 1) // 2
    moved = (3 * b * l * h * p * itemsize + 4 * b * l * g * n * itemsize
             + 8 * b * l * h + 8 * h + (4 * b * h * p * n if dstate else 0))
    fma = (b * g * nc * tri * n
           + b * h * nc * (2 * tri * p + 2 * tri * n + 5 * q * p * n))
    return Work(2 * fma, moved)


def causal_conv_work(b: int, l: int, c: int, width: int, itemsize: int
                     ) -> Work:
    """Mamba2's depthwise causal conv + bias + SiLU: x read once, y written
    once, w and the bias read; the conv's ``width`` multiply-adds per output
    (a grouped convolution's flops, as ``flop_counter`` counts them)."""
    return Work(2 * width * b * l * c,
                (2 * b * l * c + (width + 1) * c) * itemsize)


def causal_conv_bwd_work(b: int, l: int, c: int, width: int, itemsize: int
                         ) -> Work:
    """Its backward: x and dy read once, dx written once, w and the bias
    read and their gradients written; ``width`` multiply-adds per element
    for dx and as many for dw."""
    return Work(4 * width * b * l * c,
                (3 * b * l * c + 2 * (width + 1) * c) * itemsize)


# --------------------------------------------------------------------------- #
# Roofline terms (H100 SXM data-sheet rates)
# --------------------------------------------------------------------------- #
PEAK_FLOPS = 989e12  # H100 SXM bf16 dense tensor-core peak, FLOP/s
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12  # H100 SXM HBM3, bytes/s
NVLINK_BW = 450e9  # H100 SXM NVLink 4, bytes/s per direction

# Effective on-wire multiplier per collective kind (ring algorithms):
# all-reduce = reduce-scatter + all-gather ~ 2x payload.
_COLL_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def bound(work: Work, flops_per_s: float = PEAK_FLOPS) -> dict:
    """The least time the card could take for ``work``: the larger of its
    bytes over the HBM rate and its flops over ``flops_per_s``."""
    bytes_ms = work.bytes / HBM_BW * 1e3
    ops_ms = work.flops / flops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": work.bytes, "flops": work.flops}


def roofline_terms(analysis: dict) -> dict:
    coll = sum(v * _COLL_FACTOR.get(k, 1.0)
               for k, v in analysis["collective_bytes"].items())
    return {
        "compute_s": analysis["flops"] / PEAK_FLOPS,
        "memory_s": analysis["bytes"] / HBM_BW,
        "collective_s": coll / NVLINK_BW,
    }


def dominant_term(terms: dict) -> str:
    return max(
        (("compute", terms["compute_s"]), ("memory", terms["memory_s"]),
         ("collective", terms["collective_s"])),
        key=lambda kv: kv[1],
    )[0]


# --------------------------------------------------------------------------- #
# The analyzer
# --------------------------------------------------------------------------- #
_aten = torch.ops.aten
# Ops that move no bytes: metadata, aliases and fill-less allocations.
_SKIP_BYTES = {
    _aten.detach, _aten.alias, _aten._unsafe_view, _aten.lift_fresh,
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._local_scalar_dense, _aten.set_,
    _aten.resize_, _aten.record_stream,
}
# (namespace, op) -> (reference name, index of the operand argument): the
# c10d ops ``torch.distributed``'s calls dispatch, and the functional
# collectives ``DTensor`` redistributes with.  The reference's fifth kind,
# collective-permute, the port's steps never issue.
_COLLECTIVE_OPS = {
    ("c10d", "allreduce_"): ("all-reduce", 0),
    ("c10d", "allgather_"): ("all-gather", 1),
    ("c10d", "_allgather_base_"): ("all-gather", 1),
    ("c10d", "reduce_scatter_"): ("reduce-scatter", 1),
    ("c10d", "_reduce_scatter_base_"): ("reduce-scatter", 1),
    ("c10d", "alltoall_"): ("all-to-all", 1),
    ("c10d", "alltoall_base_"): ("all-to-all", 1),
    ("_c10d_functional", "all_reduce"): ("all-reduce", 0),
    ("_c10d_functional", "all_gather_into_tensor"): ("all-gather", 0),
    ("_c10d_functional", "reduce_scatter_tensor"): ("reduce-scatter", 0),
    ("_c10d_functional", "all_to_all_single"): ("all-to-all", 0),
}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (the rank's own bytes), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or outputs (nested tuples, lists
    and dicts), each as its local block."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(_local(tree))
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage_key(t: torch.Tensor):
    """``(id, storage)`` of the storage under ``t`` (None for a wrapper
    without one)."""
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    return st._cdata, st


class _Counts:
    """One :func:`analyze` run's running totals and its memory tracker."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.collective_bytes: dict = defaultdict(int)
        self.collective_count: dict = defaultdict(int)
        self.kernels: dict = {}
        self.fills = WeakIdKeyDictionary()  # meta torch.full -> fill value
        self.suspended = 0
        self._live: dict = {}  # storage id -> (bytes, weakref), while alive
        self.live = 0
        self.peak = 0

    # ---- memory ----
    def _freed(self, key) -> None:
        nbytes, _ = self._live.pop(key, (0, None))
        self.live -= nbytes

    def allocated(self, outputs: list, inputs: list) -> None:
        """Track the storages of ``outputs`` (tensors) that alias none of
        ``inputs`` (new allocations) until they are freed."""
        new = []
        for t in outputs:
            ks = _storage_key(t)
            if ks is not None and ks[0] not in self._live:
                new.append(ks)
        if not new:
            return
        seen = set()
        for t in inputs:
            ks = _storage_key(t)
            if ks is not None:
                seen.add(ks[0])
        for key, st in new:
            if key in seen or key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = (nbytes, weakref.ref(
                st, lambda _r, k=key: self._freed(k)))
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    # ---- ops ----
    def count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        coll = _COLLECTIVE_OPS.get((func.namespace, packet.__name__))
        outs = _tensors(out)
        if coll is not None:
            kind, idx = coll
            b = _nbytes(_tensors(args[idx])) if len(args) > idx else 0
            self.collective_bytes[kind] += b
            self.collective_count[kind] += 1
            self.bytes += b + _nbytes(outs)
            return
        if packet in flop_registry:
            largs, lkwargs = tree_map(
                lambda t: _local(t) if isinstance(t, torch.Tensor) else t,
                (args, kwargs))
            self.flops += int(flop_registry[packet](*largs, **lkwargs,
                                                    out_val=out))
        if func.is_view:
            return
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        self.allocated(outs, ins)
        if packet in _SKIP_BYTES:
            return
        if packet is _aten.full and out.device.type == "meta":
            self.fills[out] = args[1]
        if packet is _aten.copy_:
            read = _nbytes(_tensors(args[1:]))
        elif "out" in kwargs:
            read = _nbytes(_tensors(args)) + _nbytes(_tensors(
                {k: v for k, v in kwargs.items() if k != "out"}))
        else:
            read = _nbytes(ins)
        self.bytes += read + _nbytes(outs)

    def add_kernel(self, name: str, work: Work) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(work.flops)
        k["bytes"] += int(work.bytes)
        self.flops += int(work.flops)
        self.bytes += int(work.bytes)


class _Mode(TorchDispatchMode):
    def __init__(self, counts: _Counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.counts.suspended:
            self.counts.count(func, args, kwargs, out)
        return out


def kernel_call(name: str, work: Work, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` — a kernel wrapper's route — as one call of
    kernel ``name`` doing ``work``: every armed analyzer adds ``work`` and
    counts none of the ops inside, then tracks the call's outputs as new
    allocations."""
    armed = list(ARMED)
    for c in armed:
        c.add_kernel(name, work)
    with _suspended():
        out = fn(*args, **kwargs)
    for c in armed:
        if not c.suspended:
            c.allocated(_tensors(out), _tensors((args, kwargs)))
    return out


@contextlib.contextmanager
def _suspended():
    """Every armed analyzer counts no op while the block runs."""
    armed = list(ARMED)
    for c in armed:
        c.suspended += 1
    try:
        yield
    finally:
        for c in armed:
            c.suspended -= 1


def analyze(fn: Callable, *args, **kwargs) -> tuple[Any, dict]:
    """Runs ``fn(*args, **kwargs)`` once under the analyzer; returns its
    output and ``{"flops", "bytes", "collective_bytes",
    "collective_count", "kernels", "temp_bytes", "output_bytes"}`` (see
    the module docstring)."""
    counts = _Counts()
    ARMED.append(counts)
    try:
        with _Mode(counts):
            out = fn(*args, **kwargs)
    finally:
        ARMED.remove(counts)
    storages = {}
    for t in _tensors(out):
        ks = _storage_key(t)
        if ks is not None:
            storages[ks[0]] = ks[1].nbytes()
    return out, {
        "flops": counts.flops,
        "bytes": counts.bytes,
        "collective_bytes": dict(counts.collective_bytes),
        "collective_count": dict(counts.collective_count),
        "kernels": {k: dict(v) for k, v in sorted(counts.kernels.items())},
        "temp_bytes": counts.peak,
        "output_bytes": sum(storages.values()),
    }

