"""Device idle ms per batch under ``serve.prefill``: the prefill of the
batch's prompts and its greedy pick, its blocks included
(harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "ms"
LAYER = "model"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(t):
    return spans.idle_ms_per_unit(t, "serve.batch",
                                  lambda p: "serve.prefill" in p)
