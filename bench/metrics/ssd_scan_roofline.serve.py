"""The SSD scan's forward (K4) calls of the profiled batches' prefills: the
least time their work takes on the card over the device time of its kernel."""
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
    ("ssd_scan", "ssd_scan", "ssd_scan_tc", ("ssd_scan_tc_kernel",),
     work.ssd_scan_work),
)


def read(t):
    return readers.roofline_percent(t, PARTS)
