"""Traced API layers.  Import order fixes function ids; keep it stable."""

from . import posix  # noqa: F401  (layer: posix)
from . import shardio  # noqa: F401  (layer: shardio -- the MPI-IO analogue)
from . import framework  # noqa: F401  (layer: frame -- step/fetch/ckpt events)
