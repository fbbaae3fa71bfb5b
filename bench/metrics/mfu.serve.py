"""The configuration's model flops per batch (no recomputation;
yardstick/flops.py) over the batch's host wall times the card's bf16 peak."""
from harness import readers

READS = "the host clock around untraced batches"
UNIT = "%"
LAYER = "model"
MOVES = "serve_p95_ms"
SOURCE = "host_clock"


def read(t):
    return readers.mfu_percent(t)
