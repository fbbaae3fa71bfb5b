"""The share of an untraced batch's wall in which no operation ran on the card:
one minus the device's busy time per batch in the profiled window over the
batch's wall timed without the profiler."""
from harness import readers

READS = "the device trace and the host clock around untraced batches"
UNIT = "%"
LAYER = "device"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(t):
    return readers.idle_percent(t)
