"""Device operations per batch in the profiled window (BatchedServer)."""
from harness import readers

READS = "the device trace"
UNIT = "launches"
LAYER = "serving front end"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(t):
    return readers.launches_per_unit(t)
