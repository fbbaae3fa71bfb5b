"""Device idle ms per step under ``train.optimizer`` (AdamW over every
leaf; harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "ms"
LAYER = "training step"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return spans.idle_ms_per_unit(t, "train.step",
                                  lambda p: "train.optimizer" in p)
