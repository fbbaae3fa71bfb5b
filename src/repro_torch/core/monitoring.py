"""Platform monitoring (paper §III.C: "users can monitor various
computational metrics, edge device performance, and updates to cloud
services throughout the task execution process via the GUI").

Headless equivalent: a structured metrics bus.  Every platform component
emits ``MetricEvent``s; sinks subscribe (the tests use an in-memory sink; a
deployment would attach a TSDB writer).  ``TaskMonitor`` aggregates the
per-task view the paper's GUI shows: round progress, tier split, device
telemetry, shelf depth, aggregation history.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class MetricEvent:
    t: float  # virtual time (wall time only outside the simulation domain)
    source: str  # "logical" | "device" | "deviceflow" | "cloud" | "runner"
    task_id: int
    kind: str  # e.g. "round_start", "telemetry", "dispatch", "aggregation"
    values: dict[str, Any]


class MetricsBus:
    """Metrics fan-out with an *injected* clock.

    Simulation components must stamp events on the simulated timeline, so
    the bus never reads wall time itself (simcheck R002): pass a zero-arg
    ``clock`` callable, or build one from a ``VirtualClock`` with
    :meth:`on_virtual_clock` (``MetricsBus.on_virtual_clock(engine.clock)``
    when driven from ``TaskEngine``/``DeviceFlow``).  Explicitly wall-clock
    producers (checkpoint manifests, dryrun timing) stamp their own ``t``
    and go through :meth:`emit` directly.
    """

    def __init__(self, clock: Callable[[], float] | None = None) -> None:
        self._sinks: list[Callable[[MetricEvent], None]] = []
        self.clock = clock

    @classmethod
    def on_virtual_clock(cls, clock) -> "MetricsBus":
        """A bus stamping events from a ``VirtualClock`` (``clock.now``)."""
        return cls(clock=lambda: clock.now)

    def subscribe(self, sink: Callable[[MetricEvent], None]) -> None:
        self._sinks.append(sink)

    def emit(self, event: MetricEvent) -> None:
        for s in self._sinks:
            s(event)

    def emit_now(self, source: str, task_id: int, kind: str, **values) -> None:
        if self.clock is None:
            raise RuntimeError(
                "MetricsBus.emit_now needs an injected clock — construct "
                "with MetricsBus(clock=...) or "
                "MetricsBus.on_virtual_clock(engine.clock); simulation "
                "metrics must not read wall time (simcheck R002)")
        self.emit(MetricEvent(self.clock(), source, task_id, kind, values))


class InMemorySink:
    """Test/GUI sink: per-(task, kind) ring buffers + latest snapshot."""

    def __init__(self, maxlen: int = 10000):
        self.events: dict[tuple[int, str], collections.deque] = (
            collections.defaultdict(lambda: collections.deque(maxlen=maxlen)))

    def __call__(self, e: MetricEvent) -> None:
        self.events[(e.task_id, e.kind)].append(e)

    def latest(self, task_id: int, kind: str) -> MetricEvent | None:
        buf = self.events.get((task_id, kind))
        return buf[-1] if buf else None

    def series(self, task_id: int, kind: str, key: str) -> list:
        return [e.values.get(key) for e in self.events.get((task_id, kind), ())]


class TaskMonitor:
    """The per-task dashboard state the paper's GUI renders."""

    def __init__(self, bus: MetricsBus, task_id: int):
        self.task_id = task_id
        self.sink = InMemorySink()
        bus.subscribe(lambda e: self.sink(e) if e.task_id == task_id else None)

    def summary(self) -> dict:
        rounds = self.sink.series(self.task_id, "round_complete", "round_idx")
        aggs = self.sink.series(self.task_id, "aggregation", "num_clients")
        power = self.sink.series(self.task_id, "telemetry", "power_mah")
        shelf = self.sink.latest(self.task_id, "dispatch")
        return {
            "rounds_completed": len(rounds),
            "aggregations": len(aggs),
            "clients_aggregated": int(sum(a or 0 for a in aggs)),
            "mean_device_power_mah": (
                sum(power) / len(power) if power else None),
            "shelf_pending": (shelf.values.get("pending") if shelf else None),
        }

    def to_json(self) -> str:
        return json.dumps(self.summary())


def wire_aggregation_service(bus: MetricsBus, svc, task_id: int) -> None:
    """Attach a cloud-service aggregation feed to the bus."""
    prev = svc.on_aggregate

    def hook(ev):
        bus.emit(MetricEvent(ev.t, "cloud", task_id, "aggregation", {
            "round_idx": ev.round_idx,
            "num_clients": ev.num_clients,
            "num_samples": ev.num_samples,
        }))
        if prev is not None:
            prev(ev)

    svc.on_aggregate = hook
