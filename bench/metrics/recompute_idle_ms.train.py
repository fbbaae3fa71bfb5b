"""Device idle ms per step under the blocks the backward recomputes: a
``model.block`` span whose parent is ``train.backward`` (harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "ms"
LAYER = "model"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return spans.idle_ms_per_unit(t, "train.step", spans.recomputed)
