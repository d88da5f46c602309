"""Model operations of the window's training steps (three forward passes,
no recompute) over the window and the card's bf16 peak."""

from portbench.roofline import shares

LAYER = "train step"
UNIT = "%"
MOVES = "train_tokens_per_s"
SOURCE = "host_clock"


def read(ctx):
    return shares.mfu(ctx)
