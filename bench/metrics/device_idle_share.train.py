"""The share of an untraced step's wall in which no operation ran on the card:
one minus the device's busy time per step in the profiled window over the
step's wall timed without the profiler."""
from harness import readers

READS = "the device trace and the host clock around untraced steps"
UNIT = "%"
LAYER = "device"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return readers.idle_percent(t)
