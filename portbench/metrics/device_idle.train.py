"""Share of the profiled training steps in which no operation ran on the
card."""

from portbench.roofline import shares

LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "device_trace"


def read(ctx):
    return shares.idle(ctx)
