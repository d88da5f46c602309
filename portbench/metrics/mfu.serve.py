"""Model operations of the window's prefill batches (the head at the last
position) over the window and the card's bf16 peak."""

from portbench.roofline import shares

LAYER = "serve engine, prefill"
UNIT = "%"
MOVES = "serve_tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    return shares.mfu(ctx)
