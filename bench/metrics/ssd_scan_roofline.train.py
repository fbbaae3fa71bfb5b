"""The SSD scan's forward (K4) and backward (K4b) calls of the profiled steps:
the least time their work takes on the card (the yardstick's formulas at the
cell's shapes) over the device time of their kernels."""
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
    ("ssd_scan", "ssd_scan.launches", "ssd_scan.tc_launches",
     ("ssd_scan_tc_kernel",), work.ssd_scan_work),
    ("ssd_scan_bwd", "ssd_scan.bwd_launches", "ssd_scan.tc_bwd_launches",
     ("ssd_bwd_tc_local_kernel", "ssd_bwd_tc_state_kernel",
      "ssd_bwd_tc_chunk_kernel", "ssd_bwd_tc_dbdc_kernel",
      "ssd_bwd_group_kernel", "ssd_bwd_da_kernel"),
     work.ssd_scan_bwd_work),
)


def read(t):
    return readers.roofline_percent(t, PARTS)
