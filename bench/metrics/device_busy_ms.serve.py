"""Device busy time per batch in the profiled window (the union of the
operations' intervals), in ms: the steady part of the batch's wall, which
the host's speed does not move."""
from harness import readers

READS = "the device trace"
UNIT = "ms"
LAYER = "device"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(t):
    return readers.busy_ms_per_unit(t)
