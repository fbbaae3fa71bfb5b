"""Device idle ms per batch under ``serve.decode``: each generated token's
decode step and greedy pick (harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "ms"
LAYER = "model"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(t):
    return spans.idle_ms_per_unit(t, "serve.batch",
                                  lambda p: "serve.decode" in p)
