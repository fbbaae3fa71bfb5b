"""The configuration's model flops per step (no recomputation;
yardstick/flops.py) over the step's host wall times the card's bf16 peak."""
from harness import readers

READS = "the host clock around untraced steps"
UNIT = "%"
LAYER = "model"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(t):
    return readers.mfu_percent(t)
