"""Intra-process I/O pattern recognition (paper Section 3.2.1).

Offsets of repeated calls often follow ``offset_i = i*a + b``.  Recorder
checks, at interception time, whether the current offset extends the active
arithmetic run for this call's *pattern key* (function, thread, handle, and
all non-offset arguments).  If it does, the offset is encoded as the pair
``(a, b)`` so that every call of the run shares one call signature; otherwise
the concrete offset is stored and a new run begins.

Encoding protocol (mirrored exactly by the trace reader):

  i == 0           -> concrete offset ``b`` (starts a run)
  i >= 1, matches  -> ``IterPattern(a, b)`` with ``a = off_1 - off_0``
  mismatch         -> concrete offset, run restarts at i == 0

Calls with multiple OFFSET-role arguments are tracked jointly (a shared run
index with per-component strides), so e.g. ``(offset, whence)`` pairs or
framework step counters compress with the same machinery.

``IntraPatternTracker.encode_many`` is the batched entry point: it encodes a
whole sequence of calls for one key at once, finding arithmetic runs with
the shared NumPy segmentation helper (``interprocess.arith_segments``) and
is result- and state-equivalent to calling :meth:`encode` per call.  The
benchmark drivers use it to synthesize large simulated-rank streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .encoding import IterPattern
from .interprocess import arith_segments


@dataclass
class _RunState:
    index: int                      # how many calls matched this run so far
    base: Tuple[int, ...]           # offsets of call 0
    stride: Optional[Tuple[int, ...]]  # set at call 1


Encoded = Union[int, IterPattern]


class IntraPatternTracker:
    """Per-process tracker; keys must be hashable and derivable by the reader
    from decoded records (it uses the same key function on decoded args)."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._runs: Dict[Any, _RunState] = {}

    def encode(self, key: Any, offsets: Sequence[int]) -> List[Encoded]:
        """Encode the OFFSET-role values of one call."""
        vals = tuple(int(v) for v in offsets)
        if not self.enabled or not vals:
            return list(vals)
        run = self._runs.get(key)
        if run is None:
            self._runs[key] = _RunState(index=1, base=vals, stride=None)
            return list(vals)
        if run.stride is None:
            stride = tuple(v - b for v, b in zip(vals, run.base))
            run.stride = stride
            run.index = 2
            return [IterPattern(a, b) for a, b in zip(stride, run.base)]
        expected = tuple(b + run.index * a for a, b in zip(run.stride, run.base))
        if vals == expected:
            run.index += 1
            return [IterPattern(a, b) for a, b in zip(run.stride, run.base)]
        # run broken: restart
        self._runs[key] = _RunState(index=1, base=vals, stride=None)
        return list(vals)

    def encode_many(self, key: Any, rows: Sequence[Sequence[int]],
                    backend: Optional[str] = None) -> List[List[Encoded]]:
        """Batched :meth:`encode`: one call per row, vectorized.

        Equivalent (outputs and final run state) to
        ``[self.encode(key, r) for r in rows]``, but arithmetic runs are
        found with one segmentation pass (``backend`` dispatches it:
        NumPy or the grammar_stats boundary kernel) instead of per-call
        Python work.  Falls back to the scalar loop for ragged/empty
        arities or values outside the int64-safe range.
        """
        rows = [tuple(int(v) for v in r) for r in rows]
        if not self.enabled or not rows:
            return [list(r) for r in rows]
        k = len(rows[0])
        if k == 0 or any(len(r) != k for r in rows):
            return [self.encode(key, r) for r in rows]
        try:
            V = np.asarray(rows, dtype=np.int64)
        except (OverflowError, ValueError):
            return [self.encode(key, r) for r in rows]
        if np.abs(V).max(initial=0) >= (1 << 62):
            return [self.encode(key, r) for r in rows]

        out: List[List[Encoded]] = []
        n = len(rows)
        p = 0  # rows consumed by continuing a pre-existing run
        run = self._runs.get(key)
        if run is not None and len(run.base) == k:
            if run.stride is None:
                # second element of the active run: always matches and
                # fixes the stride
                stride = tuple(v - b for v, b in zip(rows[0], run.base))
                run.stride = stride
                run.index = 2
                out.append([IterPattern(a, b)
                            for a, b in zip(stride, run.base)])
                p = 1
            if p < n and run.stride is not None:
                # keep b + i*a exact in int64 (else defer to Python ints)
                bound = (max(abs(v) for v in run.base)
                         + (run.index + n) * max(
                             (abs(a) for a in run.stride), default=0))
                if bound >= (1 << 62):
                    return out + [self.encode(key, r) for r in rows[p:]]
                base = np.asarray(run.base, dtype=np.int64)
                stride = np.asarray(run.stride, dtype=np.int64)
                idx = run.index + np.arange(n - p, dtype=np.int64)
                expected = base[None, :] + idx[:, None] * stride[None, :]
                bad = (V[p:] != expected).any(axis=1)
                m = int(np.argmax(bad)) if bad.any() else n - p
                if m:
                    pat = [IterPattern(a, b)
                           for a, b in zip(run.stride, run.base)]
                    out.extend(list(pat) for _ in range(m))
                    run.index += m
                    p += m
                if p < n:
                    run = None  # run broken: remaining rows start fresh
        elif run is not None:
            # arity changed mid-stream: defer to the scalar protocol
            return out + [self.encode(key, r) for r in rows]

        if p < n:
            W = V[p:]
            segs = arith_segments(W, backend=backend)
            for s, e in segs:
                base = tuple(int(v) for v in W[s])
                out.append(list(base))
                if e - s >= 2:
                    stride = tuple(int(v) for v in (W[s + 1] - W[s]))
                    pat = [IterPattern(a, b) for a, b in zip(stride, base)]
                    out.extend(list(pat) for _ in range(e - s - 1))
                    self._runs[key] = _RunState(index=e - s, base=base,
                                                stride=stride)
                else:
                    self._runs[key] = _RunState(index=1, base=base,
                                                stride=None)
        return out


class IntraPatternDecoder:
    """Reader-side inverse of :class:`IntraPatternTracker`.

    The decoder tracks, per pattern key, the occurrence index of the active
    run and materializes concrete offsets from ``IterPattern`` values.
    """

    def __init__(self) -> None:
        self._runs: Dict[Any, Tuple[int, Tuple]] = {}  # key -> (index, pattern sig)

    def decode(self, key: Any, encoded: Sequence[Encoded]) -> List[int]:
        if not encoded:
            return []
        if not any(isinstance(v, IterPattern) for v in encoded):
            # concrete call: (re)starts a run at index 0
            self._runs[key] = (1, None)
            return [int(v) for v in encoded]  # type: ignore[arg-type]
        patsig = tuple((v.a, v.b) if isinstance(v, IterPattern) else v
                       for v in encoded)
        idx, prev_sig = self._runs.get(key, (1, None))
        if prev_sig is not None and prev_sig == patsig:
            idx += 1
        # else: this is the first encoded call of the run (index 1)
        out: List[int] = []
        for v in encoded:
            if isinstance(v, IterPattern):
                out.append(int(v.b) + idx * int(v.a))
            else:
                out.append(int(v))
        self._runs[key] = (idx, patsig)
        return out


def pattern_key(func_id: int, thread_id: int, handle_ids: Tuple, other_args: Tuple) -> Tuple:
    """The pattern key shared by tracker and decoder."""
    return (func_id, thread_id, handle_ids, other_args)
