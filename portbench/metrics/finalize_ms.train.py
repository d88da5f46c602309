"""Milliseconds of the training window's session exit (the finalize that
writes the merged trace)."""

from portbench.roofline import shares

LAYER = "finalize"
UNIT = "ms"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    return shares.span_ms(ctx, "finalize")
