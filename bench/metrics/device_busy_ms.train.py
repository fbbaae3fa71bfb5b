"""Device busy time per step in the profiled window (the union of the
operations' intervals), in ms: the steady part of the step's wall, which
the host's speed does not move."""
from harness import readers

READS = "the device trace"
UNIT = "ms"
LAYER = "device"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return readers.busy_ms_per_unit(t)
