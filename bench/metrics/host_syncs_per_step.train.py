"""Host syncs per step: the synchronizing CUDA operations the port counts
under ``train.step`` (the batch's copies to the card among them;
harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "syncs"
LAYER = "training step"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(t):
    return spans.syncs_per_unit(t, "train.step")
