"""Opt-in runtime sanitizers for the port's hot paths.

Enable with ``SIMDC_SANITIZE=1`` in the environment.  Everything here is a
no-op when disabled, so the hot paths pay only a truthiness check per call.

* ``@hot_path`` marks the zero-copy round pipeline and the fused aggregation
  dispatch (and the R003 lint, which forbids host syncs in their bodies).
  Under sanitize, on a CUDA machine, it runs the function with
  ``torch.cuda.set_sync_debug_mode("error")``, so any operation that
  synchronizes the host with the card (``.item()``, a device-to-host copy,
  ``nonzero``) raises at the offending op instead of silently serializing
  the launch stream.
* ``exempt`` runs a function with the sync check off: *user* callbacks
  (payload transforms) and the platform's *explicit* host<->card copies
  (materializing benchmarking rows, uploading host weight vectors).  As in
  the reference, where ``transfer_guard("disallow")`` rejects only implicit
  transfers, an explicit copy stays legal inside a hot path.
* :func:`poison_recycled` — ``HybridSimulation(recycle_buffers=True)``
  writes round k+1's chunk update into round k's retired ``UpdateBuffer``
  leaves (``out=`` targets), so a round-k handle read after round k+1
  silently reads the next round's rows.  Under sanitize the retired buffer
  is poisoned as its leaves are handed out: its class is swapped so any
  leaf access raises :class:`UseAfterRecycleError` (the twin of the
  reference's ``poison_donated``).  Probe with ``__simdc_recycled__``
  (class attr) without touching the leaves.
* :class:`ClockMonotonicityError` — ``VirtualClock.schedule`` normally
  clamps past timestamps to ``now``; under sanitize it raises.
* :class:`SegmentLeakError` — ``FleetWorkerPool.close()`` raises it under
  sanitize when a shared-memory segment is still pinned by a view that
  outlived its ``UpdateBuffer``.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch

__all__ = [
    "enabled", "force", "override", "hot_path", "exempt",
    "SanitizerError", "UseAfterRecycleError", "ClockMonotonicityError",
    "SegmentLeakError", "poison_recycled",
]

_ENV = "SIMDC_SANITIZE"
_FORCED: bool | None = None


def enabled() -> bool:
    """True when sanitizers are active (env var or :func:`force`)."""
    if _FORCED is not None:
        return _FORCED
    return os.environ.get(_ENV, "").strip().lower() not in (
        "", "0", "false", "off", "no")


def force(value: bool | None) -> None:
    """Override the env var (``None`` restores env-driven behavior)."""
    global _FORCED
    _FORCED = value


@contextlib.contextmanager
def override(value: bool):
    """Temporarily force sanitizers on/off (tests)."""
    prev = _FORCED
    force(value)
    try:
        yield
    finally:
        force(prev)


class SanitizerError(RuntimeError):
    """Base class for every runtime sanitizer failure."""


class UseAfterRecycleError(SanitizerError):
    """A recycled ``UpdateBuffer``'s leaves were read after they were handed
    to the next round as ``out=`` targets."""


class ClockMonotonicityError(SanitizerError):
    """An event was scheduled in the virtual past."""


class SegmentLeakError(SanitizerError):
    """A worker-pool shared-memory segment outlived pool teardown."""


@contextlib.contextmanager
def _sync_debug_mode(mode: str):
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def hot_path(fn):
    """Mark ``fn`` as a launch hot path (lint rule R003) and, when
    sanitizers are enabled, run it with CUDA sync debugging set to
    ``"error"`` so host syncs raise at the offending op."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not enabled():
            return fn(*args, **kwargs)
        with _sync_debug_mode("error"):
            return fn(*args, **kwargs)

    wrapper.__simdc_hot_path__ = True
    return wrapper


def exempt(fn):
    """Wrap a user callback or an explicit host<->card copy so it runs with
    the hot-path sync check off.  ``None`` passes through."""
    if fn is None:
        return None

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not enabled():
            return fn(*args, **kwargs)
        with _sync_debug_mode("default"):
            return fn(*args, **kwargs)

    return wrapper


# --------------------------------------------------------------------------
# use-after-recycle poisoning

_POISONED: dict[type, type] = {}


def _poisoned_class(cls: type) -> type:
    def _dead(self, *_args, **_kwargs):
        raise UseAfterRecycleError(
            f"{cls.__name__} was recycled (its 2-D leaves now hold the next "
            "round's rows); consume a round's handles before the next round "
            "runs, or turn recycle_buffers off")

    # An empty-__slots__ subclass keeps the instance layout identical, so
    # __class__ assignment is legal; the property shadows the parent's
    # leaves2d slot descriptor, so every leaf access (materialize,
    # state_dict, handle, ...) raises at the attribute read.
    return type(f"_Recycled{cls.__name__}", (cls,), {
        "__slots__": (),
        "__simdc_recycled__": True,
        "leaves2d": property(_dead, _dead, _dead),
    })


def poison_recycled(buf):
    """Swap ``buf``'s class so leaf access raises UseAfterRecycleError.

    Idempotent; returns ``buf``.  Only called on the recycle path when
    :func:`enabled`, so production runs never pay for it.
    """
    cls = type(buf)
    if getattr(cls, "__simdc_recycled__", False):
        return buf
    poisoned = _POISONED.get(cls)
    if poisoned is None:
        poisoned = _POISONED[cls] = _poisoned_class(cls)
    buf.__class__ = poisoned
    return buf
