"""What the per-layer metrics' readers share (``metrics/<name>.py`` holds
each metric's own choices: its kernels' names, its formulas)."""
from __future__ import annotations

import sys

from yardstick import work


def _why(msg: str) -> None:
    print(msg, file=sys.stderr)


def launches_per_unit(t) -> float:
    """Device operations in the profiled window per step or batch."""
    return len(t.window.kernels) / t.units


def busy_ms_per_unit(t) -> float:
    """Device busy ms (the union of the operations' intervals) per step or
    batch of the profiled window."""
    return 1e3 * t.window.busy_s / t.units


def idle_percent(t) -> float:
    """The share of a step's or batch's wall, timed without the profiler,
    in which no operation ran on the device, in %: one minus the device's
    busy time per unit in the profiled window over that wall.  (Under the
    profiler the host launches more slowly, so the profiled window's own
    idle share, ``device.busy_s`` against ``device.window_s``, reads
    higher.)"""
    return 100.0 * (1.0 - t.window.busy_s / t.units / t.unit_wall_s)


def mfu_percent(t) -> "float | None":
    """Model flops of a step or batch over its wall (timed without the
    profiler) times the card's bf16 peak, in %."""
    if t.peaks is None:
        _why("mfu: the card is not in yardstick/peaks.json")
        return None
    return 100.0 * t.model_flops_per_unit / t.unit_wall_s / \
        t.peaks["bf16_flops_per_s"]


def roofline_percent(t, parts) -> "float | None":
    """The least time the card could take for the calls of ``parts`` (by
    the yardstick's formulas at the cell's shapes) over the device time of
    the kernels whose names match, in %.

    ``parts``: ``(shape key, counter of all calls, counter of the calls on
    the route the names belong to, kernel names, formula)``.  The cell's
    shapes give, under each key, each call's shape with its calls per unit:
    the window's calls have to be that many, every one on that route, and
    every name must have been launched once per call; otherwise nothing is
    reported."""
    if t.peaks is None:
        _why("roofline: the card is not in yardstick/peaks.json")
        return None
    bound, spent = 0.0, 0.0
    for shape_key, all_calls, route_calls, names, formula in parts:
        calls, routed = t.counters.get(all_calls, 0), t.counters.get(
            route_calls, 0)
        shapes = [(s, n * t.units) for s, n in t.shapes.get(shape_key, ())]
        due = sum(n for _, n in shapes)
        if calls == 0 or calls != routed or calls != due:
            _why(f"roofline: {calls} {all_calls} calls, {routed} of them on "
                 f"the route of {names}, {due} due by the cell's shapes")
            return None
        for name in names:
            ks = [k for k in t.window.kernels if name in k[0]]
            if len(ks) != calls:
                _why(f"roofline: {len(ks)} launches named {name} for "
                     f"{calls} calls")
                return None
            spent += sum(e - s for _, s, e in ks)
        _why(f"roofline: {calls} {all_calls} calls, each launching "
             f"{', '.join(names)}")
        for shape, n in shapes:
            bound += n * work.bound_s(formula(**shape),
                                      t.peaks["bf16_flops_per_s"],
                                      t.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / spent
