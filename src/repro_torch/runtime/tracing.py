"""Spans of the port's host work, on the host clock a device trace is mapped
to (``time.perf_counter()``).

``span(name, **attrs)`` is a context manager around one piece of host work;
``spanned(name)`` wraps a function in one.  Tracing is on only while a torch
profiler runs: ``torch.autograd.profiler._is_profiler_enabled``, the flag
PyTorch keeps for fast Python checks.  Off, ``span`` returns one shared
no-op object, so an untraced run pays one flag read per span.  Nothing
enters the profiler's own trace (no ``record_function``, no NVTX range):
a GPU-side projection of a user annotation is a device event, and the
benchmark counts every device event of its window as a kernel.

The port opens ``train.step``, ``train.batch``, ``train.forward``,
``train.backward`` and ``train.optimizer`` (``launch/train.py``,
``distribution/steps.py``), ``model.block`` around each layer of a model
(a recomputation included) and ``model.moe`` around a ``hybrid_moe``
layer's FFN half inside it (``models/granite_hybrid.py``), and
``serve.batch``, ``serve.gather``, ``serve.prefill``, ``serve.decode`` and
``serve.readback`` (``launch/serve.py``).

Each closed span is one :class:`Span` in a bounded buffer (the last
``CAPACITY``), read with :func:`records`:

* ``start`` and ``end`` on ``time.perf_counter()``, ``thread``
  (``threading.get_ident()``), ``id``;
* ``parent``: the id of the span open on the same thread when it opened.
  A span opened on a thread with none open takes the innermost open span
  that waits for other threads (``waits=True``): ``train.backward`` waits
  for the autograd engine's device thread, where the recomputed blocks run;
* ``attrs``: the keywords given.  ``requests`` passes down to every span
  opened under it, so all spans of a request carry its id;
* ``syncs``: host syncs.  While a unit span (``unit=True``: one training
  step, one served batch) is open, CUDA sync debugging is set to "warn" and
  each synchronizing-operation warning is charged to the innermost open
  span of the thread that raised it, then swallowed.  The mode is left
  alone where it is not 0 when the unit opens (the sanitizer's
  ``@hot_path`` sets "error").
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65536
SYNC_MESSAGE = "called a synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class Span:
    id: int
    name: str
    start: float
    end: float
    thread: int
    parent: "int | None"
    attrs: dict
    syncs: int


_records: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_open: dict = {}       # thread ident -> its open spans, innermost last
_waiting: list = []    # open spans that wait for other threads


def records() -> list:
    """The buffer's spans, oldest first (each appended when it closes)."""
    return list(_records)


def reset() -> None:
    """Empties the buffer."""
    _records.clear()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Open:
    __slots__ = ("id", "name", "attrs", "waits", "unit", "thread", "parent",
                 "start", "syncs", "_counting")

    def __init__(self, name: str, waits: bool, unit: bool, attrs: dict):
        self.id, self.name, self.attrs = next(_ids), name, attrs
        self.waits, self.unit, self.syncs = waits, unit, 0

    def __enter__(self):
        self.thread = threading.get_ident()
        stack = _open.setdefault(self.thread, [])
        up = stack[-1] if stack else (_waiting[-1] if _waiting else None)
        self.parent = up
        if up is not None and "requests" in up.attrs:
            self.attrs.setdefault("requests", up.attrs["requests"])
        stack.append(self)
        if self.waits:
            _waiting.append(self)
        self._counting = _count_syncs() if self.unit else None
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._counting is not None:
            _stop_counting(self._counting)
        if self.waits:
            _waiting.remove(self)
        _open[self.thread].remove(self)
        _records.append(Span(
            self.id, self.name, self.start, end, self.thread,
            None if self.parent is None else self.parent.id, self.attrs,
            self.syncs))
        return False


def span(name: str, *, waits: bool = False, unit: bool = False, **attrs):
    """A span named ``name`` while a profiler runs, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Open(name, waits, unit, attrs)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Open(name, False, False, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


# --------------------------------------------------------------------------- #
# Host syncs
# --------------------------------------------------------------------------- #
def _get_sync_mode() -> "int | None":
    """CUDA sync debugging's mode, or None without a card."""
    return torch.cuda.get_sync_debug_mode() \
        if torch.cuda.is_available() else None


def _set_sync_mode(mode: int) -> None:
    torch.cuda.set_sync_debug_mode(mode)


def _charge() -> None:
    """One host sync, charged to the innermost open span of this thread
    (on a thread with none open, to the span waiting for it)."""
    stack = _open.get(threading.get_ident())
    target = stack[-1] if stack else _waiting[-1] if _waiting else None
    if target is not None:
        target.syncs += 1


def _count_syncs():
    """Sync warnings on and counted; the handle to stop them, or None
    where the mode was not 0 (or there is no card)."""
    if _get_sync_mode() != 0:
        return None
    saved = warnings.catch_warnings()
    saved.__enter__()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_MESSAGE):
            _charge()
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    _set_sync_mode(1)
    return saved


def _stop_counting(saved) -> None:
    _set_sync_mode(0)
    saved.__exit__(None, None, None)
