"""Mamba2's causal conv + bias + SiLU, forward and backward, over x and over
B,C in the profiled steps: the least time their work takes on the card (the
yardstick's formulas at each call's shape) over the device time of its
kernels.  A forward call is one launch, a backward call two; a call that ran
anything but the kernels leaves the counted calls short of the cell's."""
from harness import readers
from yardstick import work

READS = "the device trace (kernels by name) and the port's launch counters"
UNIT = "%"
LAYER = "kernels"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"

# (shape key, counter of all calls, counter of the calls on the route,
#  the route's kernel names, each launched once per call, the formula)
PARTS = (
    ("causal_conv", "causal_conv.launches", "causal_conv.launches",
     ("causal_conv_fwd_kernel",), work.causal_conv_work),
    ("causal_conv_bwd", "causal_conv.bwd_launches",
     "causal_conv.bwd_launches",
     ("causal_conv_bwd_kernel", "causal_conv_wsum_kernel"),
     work.causal_conv_bwd_work),
)


def read(t):
    return readers.roofline_percent(t, PARTS)
