"""Mamba2's causal conv + bias + SiLU over x and over B,C in the profiled
batches' prefills: the least time their work takes on the card over the
device time of its forward kernel (one launch a call; the decode steps run
their own one-token conv, which no kernel computes)."""
from harness import readers
from yardstick import work

READS = "the device trace (kernels by name) and the port's launch counters"
UNIT = "%"
LAYER = "kernels"
MOVES = "serve_p95_ms"
SOURCE = "device_trace"

# (shape key, counter of all calls, counter of the calls on the route,
#  the route's kernel names, each launched once per call, the formula)
PARTS = (
    ("causal_conv", "causal_conv.launches", "causal_conv.launches",
     ("causal_conv_fwd_kernel",), work.causal_conv_work),
)


def read(t):
    return readers.roofline_percent(t, PARTS)
