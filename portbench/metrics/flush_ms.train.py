"""Milliseconds of every Recorder.flush() the training window calls,
summed: the harness's span around each call."""

from portbench.roofline import shares

LAYER = "streaming flush"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    return shares.span_ms(ctx, "flush")
