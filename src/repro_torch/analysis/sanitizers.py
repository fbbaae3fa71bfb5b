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
    "SanitizerError", "ClockMonotonicityError", "SegmentLeakError",
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
