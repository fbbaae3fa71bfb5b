"""Device idle ms per step under ``model.moe``: the MoE FFN of each layer
(routing, dispatch, the held experts' grouped products, combine and the
shared expert), in the forward and in the blocks the backward recomputes
alike (each idle gap of the profiled step put down to the deepest port span
open on any thread; harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "ms"
LAYER = "model"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return spans.idle_ms_per_unit(t, "train.step",
                                  lambda p: "model.moe" in p)
