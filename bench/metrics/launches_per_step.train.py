"""Device operations per step in the profiled window (make_cloud_step)."""
from harness import readers

READS = "the device trace"
UNIT = "launches"
LAYER = "training step"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return readers.launches_per_unit(t)
