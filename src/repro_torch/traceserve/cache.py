"""Incremental TraceView cache: hot views, per-segment invalidation.

The service keeps one :class:`~repro_torch.core.reader.TraceReader` per hot job
and answers queries from its memoized :class:`TraceView`.  When the job's
writer commits a new ``epoch_NNNNN/`` segment, the cache calls
``reader.refresh()`` -- the O(delta) fold that reads ONLY the new
segment, splices it onto the stitched grammars, and rolls the view's
per-unique-CFG memos forward.  Already-loaded segments are never
re-read, re-decoded, or re-walked: one new epoch costs exactly one
segment fold (``stats["segment_folds"]`` counts them, so tests can
assert the invariant directly).

Reads are *generation-stamped snapshots*.  A refresh builds a complete
replacement :class:`ViewSnapshot` under the entry lock and publishes it
with one reference swap; queries run on whatever snapshot they grabbed,
outside any lock, so a query never observes a half-folded view -- it
sees generation N in full or generation N+1 in full, nothing in between.
(Snapshot views memoize internally on first query; concurrent queries on
one snapshot may duplicate an idempotent memo fill, never corrupt one.)

Eviction is LRU by *resident compressed size* -- the bytes a cached job
actually pins (stitched CST + serialized CFGs + compressed timestamps),
which is the compressed-domain footprint, tiny next to the expanded
trace.  Evicting drops the entry without waiting on in-flight queries
(their snapshot keeps its references); a per-path generation floor keeps
generations monotonic across evict/rebuild cycles.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.reader import TraceReader


def resident_bytes(reader: TraceReader) -> int:
    """Compressed-domain footprint a cached reader pins: CST signature
    bytes, serialized stitched CFGs, and the compressed timestamp blobs
    (per-segment stores expose their raw blob sizes via ``nbytes`` when
    available)."""
    total = sum(len(s) for s in reader.merged_cst)
    total += sum(len(b) for b in reader._unique_bytes)
    store = reader.ts_store
    for sub in getattr(store, "_stores", [store]):
        total += int(getattr(sub, "nbytes", 0) or 0)
    return total


@dataclass(frozen=True)
class ViewSnapshot:
    """One immutable published state of a cached job.

    ``generation`` increases by exactly one per refresh that folded at
    least one segment (and per rebuild), monotonic per path even across
    evictions.  ``refreshed_at`` is the cache-clock instant the directory
    was last checked -- ``age(now)`` is therefore an upper bound on how
    far this snapshot can lag the directory (the observed staleness)."""

    path: str
    view: Any                      # TraceView
    generation: int
    n_segments: int
    coverage: Dict[str, Any]
    refreshed_at: float

    def age(self, now: float) -> float:
        return max(0.0, now - self.refreshed_at)


@dataclass
class _Entry:
    lock: threading.Lock = field(default_factory=threading.Lock)
    reader: Optional[TraceReader] = None
    snapshot: Optional[ViewSnapshot] = None
    resident: int = 0


class IncrementalViewCache:
    """LRU cache of live trace views with incremental refresh.

    ``get(path, max_staleness_s)`` returns a snapshot no older than the
    bound: a miss builds the reader + view once (``view_builds`` /
    ``segments_loaded``); a stale hit runs one ``refresh()`` and counts
    the folded segments (``segment_folds``); a fresh hit is pure
    dictionary lookup.  ``max_staleness_s=None`` always refreshes,
    ``float("inf")`` never does (pin the current snapshot).
    """

    def __init__(self, mode: str = "auto",
                 max_resident_bytes: Optional[int] = None,
                 clock=time.monotonic) -> None:
        self.mode = mode
        self.max_resident_bytes = max_resident_bytes
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._gen_floor: Dict[str, int] = {}
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "view_builds": 0, "segments_loaded": 0,
            "refreshes": 0, "segment_folds": 0, "evictions": 0,
        }

    # -- public API -----------------------------------------------------------

    def get(self, path: str,
            max_staleness_s: Optional[float] = None) -> ViewSnapshot:
        with self._lock:
            entry = self._entries.get(path)
            if entry is None:
                entry = _Entry()
                self._entries[path] = entry
                self.stats["misses"] += 1
            else:
                self.stats["hits"] += 1
            self._entries.move_to_end(path)
        with entry.lock:
            if entry.reader is None:
                snap = self._build(entry, path)
            else:
                snap = entry.snapshot
                if (max_staleness_s is None
                        or snap.age(self.clock()) > max_staleness_s):
                    snap = self._refresh(entry, path)
        self._maybe_evict(keep=path)
        return snap

    def peek(self, path: str) -> Optional[ViewSnapshot]:
        """Current snapshot without refreshing or touching LRU order."""
        with self._lock:
            entry = self._entries.get(path)
        return entry.snapshot if entry is not None else None

    def invalidate(self, path: str) -> bool:
        """Drop a cached job (e.g. its directory was deleted).  In-flight
        queries on its snapshots are unaffected."""
        with self._lock:
            entry = self._entries.pop(path, None)
            if entry is not None and entry.snapshot is not None:
                self._gen_floor[path] = entry.snapshot.generation
        return entry is not None

    def resident_paths(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def total_resident_bytes(self) -> int:
        with self._lock:
            return sum(e.resident for e in self._entries.values())

    # -- internals (entry.lock held) ------------------------------------------

    def _build(self, entry: _Entry, path: str) -> ViewSnapshot:
        with warnings.catch_warnings():
            # coverage is reported structurally in every snapshot; the
            # PARTIAL-coverage RuntimeWarning is for ad-hoc readers
            warnings.simplefilter("ignore", RuntimeWarning)
            reader = TraceReader(path, mode=self.mode)
            view = reader.view()
        entry.reader = reader
        self.stats["view_builds"] += 1
        self.stats["segments_loaded"] += reader.n_segments
        return self._publish(entry, path, view,
                             self._gen_floor.get(path, 0) + 1)

    def _refresh(self, entry: _Entry, path: str) -> ViewSnapshot:
        reader = entry.reader
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            folded = reader.refresh()
            view = reader.view()
        self.stats["refreshes"] += 1
        self.stats["segment_folds"] += folded
        old = entry.snapshot
        if folded == 0 and view is old.view:
            # nothing changed: keep the snapshot, reset its staleness clock
            snap = ViewSnapshot(path=path, view=old.view,
                                generation=old.generation,
                                n_segments=old.n_segments,
                                coverage=old.coverage,
                                refreshed_at=self.clock())
            entry.snapshot = snap
            return snap
        return self._publish(entry, path, view, old.generation + 1)

    def _publish(self, entry: _Entry, path: str, view,
                 generation: int) -> ViewSnapshot:
        reader = entry.reader
        snap = ViewSnapshot(path=path, view=view, generation=generation,
                            n_segments=reader.n_segments,
                            coverage=reader.coverage(),
                            refreshed_at=self.clock())
        entry.snapshot = snap
        entry.resident = resident_bytes(reader)
        return snap

    # -- eviction -------------------------------------------------------------

    def _maybe_evict(self, keep: str) -> None:
        if self.max_resident_bytes is None:
            return
        with self._lock:
            total = sum(e.resident for e in self._entries.values())
            while total > self.max_resident_bytes and len(self._entries) > 1:
                victim = next(iter(self._entries))
                if victim == keep:
                    self._entries.move_to_end(victim)
                    victim = next(iter(self._entries))
                entry = self._entries.pop(victim)
                if entry.snapshot is not None:
                    self._gen_floor[victim] = entry.snapshot.generation
                total -= entry.resident
                self.stats["evictions"] += 1
