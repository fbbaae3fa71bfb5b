"""Device idle ms per batch under ``serve.batch`` outside its prefill and
decode: the prompts' gather, the tokens' read-back and the records
(harness/spans.py)."""
from harness import spans

READS = "the device trace and the port's spans"
UNIT = "ms"
LAYER = "serving front end"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"


def read(t):
    return spans.idle_ms_per_unit(
        t, "serve.batch",
        lambda p: p[:1] == ("serve.batch",) and "serve.prefill" not in p
        and "serve.decode" not in p)
