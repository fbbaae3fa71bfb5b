"""Device idle ms per step under ``train.forward``: the forward of each
microbatch, its blocks included (each idle gap of the profiled step put
down to the deepest port span open on any thread; harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "ms"
LAYER = "model"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return spans.idle_ms_per_unit(t, "train.step",
                                  lambda p: "train.forward" in p)
