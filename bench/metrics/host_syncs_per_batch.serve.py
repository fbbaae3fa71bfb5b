"""Host syncs per batch: the synchronizing CUDA operations the port counts
under ``serve.batch`` (harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "syncs"
LAYER = "serving front end"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(t):
    return spans.syncs_per_unit(t, "serve.batch")
