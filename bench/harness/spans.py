"""The benchmark's door to the port's spans (``repro_torch.runtime.tracing``),
as ``program.py`` is to its counters: the device's idle time in a profiled
window put down to the span the host was in.

The port records spans only while a profiler runs, so the ``--trace 1``
window has them and no other run pays for more than a flag read.  The
window's spans are the last ``t.units`` unit spans (``train.step``,
``serve.batch``: those of the profiler's last try) and every span under
them, on any thread.  They are anchored on the window: the harness waits
for the card and calls straight into the port, so the first unit span
opens when the window starts on the kernels' clock, to microseconds.  Each
part of each idle gap on the device goes to the deepest span open on any
thread at that instant (depth counted through parents across threads), or
to no span.  The split of the window's whole idle time is printed to
standard error once per window: by span path, the unit's own time, and
outside any port span.

A reader gets None, with the reason on standard error, where the port keeps
no spans (an older port), where the buffer holds fewer unit spans than the
window, where a span maps past the window's end, or where the window holds
a number of unit spans other than ``t.units``.
"""
from __future__ import annotations

import collections
import dataclasses
import importlib
import sys

from harness.trace import merged

OUTSIDE = ()  # the path of idle time under no port span
_ULP = 1e-9   # the rounding of a time moved by the anchor's offset


@dataclasses.dataclass
class Split:
    """A window's idle seconds by span path (root unit first) and the host
    syncs counted under its units."""

    idle: dict        # path tuple -> idle seconds; OUTSIDE for no span
    syncs: int
    units: int
    idle_s: float     # the window's whole idle time


def _why(msg: str) -> None:
    print(f"spans: {msg}", file=sys.stderr)


def port_records() -> "list | None":
    """The port's span buffer, or None where the port keeps none."""
    try:
        tracing = importlib.import_module("repro_torch.runtime.tracing")
    except ImportError:
        return None
    return tracing.records()


def idle_gaps(window) -> list:
    """``(start, end)`` of each stretch of the window with no device
    operation, on the kernels' clock."""
    gaps, cur = [], window.start_s
    for s, e in merged(window.kernels):
        if e <= window.start_s or s >= window.end_s:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if window.end_s > cur:
        gaps.append((cur, window.end_s))
    return gaps


def attribute(window, units: int, unit: str, records) -> "Split | None":
    """The window's idle time put down to the spans of ``records`` (see the
    module docstring), or None with the reason on standard error."""
    roots = sorted((r for r in records if r.name == unit),
                   key=lambda r: r.start)
    if len(roots) < units:
        _why(f"{len(roots)} {unit} spans recorded for a window of {units}")
        return None
    roots = roots[-units:]
    offset = window.start_s - roots[0].start
    chosen = {r.id: r for r in roots}
    children = collections.defaultdict(list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append(r)
    todo = list(chosen)
    while todo:
        for c in children.get(todo.pop(), ()):
            chosen[c.id] = c
            todo.append(c.id)
    late = [r for r in chosen.values()
            if r.end + offset > window.end_s + _ULP]
    if late:
        _why(f"{len(late)} spans (first {late[0].name}) map past the "
             f"window's end")
        return None
    inside = sum(1 for r in records if r.name == unit
                 and r.start + offset >= window.start_s - _ULP
                 and r.end + offset <= window.end_s + _ULP)
    if inside != units:
        _why(f"the window holds {inside} {unit} spans, not {units}")
        return None
    paths: dict = {}

    def path(r):
        if r.id not in paths:
            up = chosen.get(r.parent)
            paths[r.id] = (path(up) if up is not None else ()) + (r.name,)
        return paths[r.id]

    for r in chosen.values():
        path(r)
    rank = {i: (len(paths[i]), r.start) for i, r in chosen.items()}
    # Span boundaries in time order; at one instant, closes before opens.
    events = sorted([(r.start + offset, 1, r.id) for r in chosen.values()]
                    + [(r.end + offset, 0, r.id) for r in chosen.values()])
    idle: dict = collections.defaultdict(float)
    live: set = set()
    k = 0
    gaps = idle_gaps(window)
    for gs, ge in gaps:
        cur = gs
        while True:
            while k < len(events) and events[k][0] <= cur:
                _, opens, i = events[k]
                (live.add if opens else live.discard)(i)
                k += 1
            nxt = min(events[k][0], ge) if k < len(events) else ge
            idle[paths[max(live, key=rank.__getitem__)] if live
                 else OUTSIDE] += nxt - cur
            if nxt >= ge:
                break
            cur = nxt
    return Split(idle=dict(idle),
                 syncs=sum(r.syncs for r in chosen.values()), units=units,
                 idle_s=sum(e - s for s, e in gaps))


def report(split: Split, unit: str) -> None:
    """The split of the window's idle time, to standard error."""
    print(f"spans: the window's idle time {1e3 * split.idle_s:.6f} ms over "
          f"{split.units} {unit} spans, by the deepest open span:",
          file=sys.stderr)
    for p, s in sorted(split.idle.items(), key=lambda kv: -kv[1]):
        name = " > ".join(p) if p else "(outside any port span)"
        print(f"spans:   {1e3 * s:12.6f} ms  {name}", file=sys.stderr)
    print(f"spans: host syncs under {unit}: {split.syncs}", file=sys.stderr)


_cache: dict = {}


def split(t, unit: str) -> "Split | None":
    """The port's spans over ``t``'s window, worked out and reported once
    per window."""
    key = (id(t.window), unit)
    if key in _cache and _cache[key][0] is t.window:
        return _cache[key][1]
    records = port_records()
    if records is None:
        _why("the port keeps no spans")
        out = None
    else:
        out = attribute(t.window, t.units, unit, records)
        if out is not None:
            report(out, unit)
    _cache[key] = (t.window, out)
    return out


def idle_ms_per_unit(t, unit: str, under) -> "float | None":
    """Idle ms per unit put down to the span paths for which ``under(path)``
    holds."""
    s = split(t, unit)
    if s is None:
        return None
    return 1e3 * sum(v for p, v in s.idle.items() if under(p)) / s.units


def syncs_per_unit(t, unit: str) -> "float | None":
    s = split(t, unit)
    return None if s is None else s.syncs / s.units


def recomputed(path: tuple) -> bool:
    """A block the backward recomputes: ``model.block`` opened under
    ``train.backward``."""
    return path[-2:] == ("train.backward", "model.block")
