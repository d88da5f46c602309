"""The SSD chunk-scan kernel's least time from shapes over its device time
in the profiled prefill batches."""

from portbench.roofline import shares

LAYER = "kernels"
UNIT = "%"
MOVES = "serve_tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    return shares.roofline(ctx, "ssd_scan")
