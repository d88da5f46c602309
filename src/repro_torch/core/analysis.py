"""Trace analyses enabled by full-parameter traces (paper Section 4).

Counter-based profilers cannot answer these; Recorder traces can, because
every call keeps its offsets, sizes, flags, call depth, thread id and
entry/exit times:

  io_summary        per-file bytes/calls/bandwidth, metadata-call ratio
  size_histogram    request-size distribution (the paper's "small request"
                    Montage finding)
  call_chains       cross-layer cause-and-effect (who triggers each write)
  overlap_ratio     asynchronous-I/O overlap between threads (Section 2.2)
  consistency_pairs conflicting (overlapping, cross-rank) write extents --
                    the file-system consistency-semantics study [27, 28]

All five run on :class:`repro_torch.core.traceview.TraceView` -- the
compressed-domain columnar query layer -- so the aggregates are
grammar-weighted sums over distinct signatures (O(|grammar| + |CST|)) and
the sequential analyses cost one stream walk per *unique CFG* instead of a
per-record Python iteration per rank.  Results are value-identical to the
record-iterator path (property-tested in ``tests/test_traceview.py``),
with one deliberate fix: ``consistency_pairs`` now reports ALL overlapping
cross-rank pairs via an active-interval sweep, where the seed's
adjacent-pair scan dropped conflicts between non-adjacent spans.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

from .reader import TraceReader
from .traceview import _DATA_FUNCS, TraceView, sweep_conflicts  # noqa: F401

Readable = Union[TraceReader, TraceView]


def _view(reader: Readable) -> TraceView:
    return reader if isinstance(reader, TraceView) else reader.view()


def io_summary(reader: Readable) -> Dict[str, Any]:
    """Aggregate transfer sizes, call mix, and per-rank bandwidth."""
    return _view(reader).io_summary()


def size_histogram(reader: Readable,
                   edges=(512, 4096, 65536, 1 << 20)) -> Dict[str, int]:
    """Request-size distribution of data calls."""
    return _view(reader).size_histogram(edges)


def call_chains(reader: Readable, targets=_DATA_FUNCS,
                rank: int = 0) -> Dict[str, int]:
    """Cross-layer call chains ending in a data op (uses call depth).

    Records are emitted at call COMPLETION (children before parents), so
    the stream is post-order; the view streams it in reverse straight from
    the grammar -- parents first, without materializing the forward record
    list -- and the depth-indexed stack reconstructs each ancestry chain."""
    return _view(reader).call_chains(targets, rank=rank)


def overlap_ratio(reader: Readable, rank: int = 0) -> float:
    """Fraction of traced I/O time where >= 2 threads were inside calls
    simultaneously (asynchronous-I/O overlap, paper Section 2.2)."""
    return _view(reader).overlap_ratio(rank)


def consistency_pairs(reader: Readable) -> List[Dict[str, Any]]:
    """Cross-rank overlapping write extents per file handle id: the cases
    whose ordering a file system's consistency model must define.

    Uses an active-interval sweep (:func:`traceview.sweep_conflicts`), so a
    long extent is checked against EVERY later overlapping span -- the
    seed's adjacent-pair scan missed e.g. rank 0 writing [0, 100) against
    rank 2 writing [30, 40) whenever rank 1 wrote in between.
    """
    return _view(reader).consistency_pairs()
