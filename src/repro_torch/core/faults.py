"""Deterministic fault injection for the tracing stack.

Production tracing must assume ranks die mid-collective, nodes are
preempted mid-commit, and disks tear writes.  This module is the single
switchboard the rest of the core consults to *simulate* those failures
reproducibly, so the fault-tolerance properties ("every surviving trace
directory is either fully readable or reports degraded coverage -- never
silently wrong") are enforced by seeded tests and the
``benchmarks/fault_matrix.py`` scenario matrix instead of hoped for.

A :class:`FaultPlan` is installed process-wide (:func:`install` /
:func:`injected`); the hook points are:

  ``ThreadComm.send``            -> :meth:`FaultPlan.on_send` may drop a
                                    message or delay its delivery
  ``trace_format`` file writers  -> :meth:`FaultPlan.on_write` may raise
                                    ENOSPC or *mangle* the bytes that hit
                                    the disk (torn write: the writer still
                                    believes it wrote the intended data,
                                    so manifest sizes/CRCs record the
                                    intent -- exactly what a lying disk
                                    does)
  ``streaming.write_epoch_segment`` commit points
                                 -> :meth:`FaultPlan.on_commit_point` may
                                    raise :class:`SimulatedCrash`

Everything is seeded (``random.Random(seed)``) and counted, so a scenario
replays bit-identically and the driver can assert the faults actually
fired.  :func:`corrupt_file` / :func:`tear_file` are the post-commit
bit-rot/truncation helpers for faults that happen *after* a clean commit.
"""

from __future__ import annotations

import errno
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


class SimulatedCrash(BaseException):
    """A simulated process death at a commit point.

    Deliberately NOT an ``Exception``: ordinary error recovery (e.g. the
    segment writer's ``.tmp`` cleanup) must not intercept it, so the
    debris left behind matches what a real kill would leave.
    """


@dataclass
class FaultPlan:
    """One seeded, replayable set of injected faults.

    ``dead_ranks`` simulates *unresponsive* peers: every p2p message sent
    by those ranks is silently dropped (the rank itself keeps running and
    will locally time out -- the preempted-but-not-yet-killed node).  A
    fully dead rank is simulated by simply not calling into the collective
    from that rank's thread.
    """

    seed: int = 0
    # -- comm faults ------------------------------------------------------
    dead_ranks: Tuple[int, ...] = ()
    drop_prob: float = 0.0           # per-message random drop
    delay_prob: float = 0.0          # per-message random delivery delay
    delay_s: float = 0.0             # how late a delayed message arrives
    # -- segment-writer faults -------------------------------------------
    #: raise ENOSPC on the Nth tracked trace-file write (1-based)
    fail_write_at: Optional[int] = None
    #: basename whose Nth write (``torn_at``, 1-based) hits the disk with
    #: its tail zeroed -- same length, wrong bytes: only checksums catch it
    torn_file: Optional[str] = None
    torn_at: int = 1
    #: raise SimulatedCrash at this commit point ("pre-rename",
    #: "pre-manifest", "post-commit"), optionally only for ``crash_epoch``
    crash_point: Optional[str] = None
    crash_epoch: Optional[int] = None
    # -- observability ----------------------------------------------------
    counters: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._writes = 0
        self._torn_seen = 0

    def _bump(self, key: str) -> None:
        self.counters[key] = self.counters.get(key, 0) + 1

    # -- hook: ThreadComm.send -------------------------------------------

    def on_send(self, src: int, dst: int) -> Optional[Any]:
        """None = deliver normally, ``"drop"`` = vanish, a float = deliver
        that many seconds late."""
        with self._lock:
            if src in self.dead_ranks:
                self._bump("sends_dropped")
                return "drop"
            if self.drop_prob and self._rng.random() < self.drop_prob:
                self._bump("sends_dropped")
                return "drop"
            if self.delay_prob and self._rng.random() < self.delay_prob:
                self._bump("sends_delayed")
                return float(self.delay_s)
        return None

    # -- hook: trace file writes -----------------------------------------

    def on_write(self, path: str, data: bytes) -> bytes:
        """Called with the bytes ABOUT to be written to ``path``; returns
        the bytes that actually reach the disk, or raises ``OSError``."""
        base = os.path.basename(path)
        with self._lock:
            self._writes += 1
            if self.fail_write_at is not None \
                    and self._writes == self.fail_write_at:
                self._bump("writes_failed")
                raise OSError(errno.ENOSPC, "disk full (injected)", path)
            if self.torn_file is not None and base == self.torn_file:
                self._torn_seen += 1
                if self._torn_seen == self.torn_at and len(data) > 1:
                    self._bump("files_torn")
                    keep = len(data) // 2
                    return data[:keep] + b"\x00" * (len(data) - keep)
        return data

    # -- hook: segment commit points -------------------------------------

    def on_commit_point(self, point: str, epoch: int) -> None:
        if self.crash_point != point:
            return
        if self.crash_epoch is not None and epoch != self.crash_epoch:
            return
        with self._lock:
            self._bump("crashes")
        raise SimulatedCrash(f"injected crash at {point} (epoch {epoch})")


# ---------------------------------------------------------------------------
# process-wide installation (the hook points poll this slot)
# ---------------------------------------------------------------------------

_ACTIVE: List[Optional[FaultPlan]] = [None]


def install(plan: Optional[FaultPlan]) -> None:
    _ACTIVE[0] = plan


def uninstall() -> None:
    _ACTIVE[0] = None


def get_active() -> Optional[FaultPlan]:
    return _ACTIVE[0]


class injected:
    """``with faults.injected(plan): ...`` -- scoped installation."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        uninstall()


# ---------------------------------------------------------------------------
# post-commit corruption helpers (bit rot / truncation after a clean commit)
# ---------------------------------------------------------------------------


def tear_file(path: str, keep_frac: float = 0.5) -> int:
    """Truncate ``path`` to ``keep_frac`` of its size (post-commit torn
    tail); returns the new size.  Caught by the manifest size check."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_frac))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep


def corrupt_file(path: str, seed: int = 0, n_flips: int = 8) -> None:
    """Flip ``n_flips`` deterministic bits of ``path`` WITHOUT changing its
    size -- classic bit rot: invisible to size checks, caught only by
    checksums."""
    rng = random.Random(seed)
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        if not data:
            return
        for _ in range(n_flips):
            i = rng.randrange(len(data))
            data[i] ^= 1 << rng.randrange(8)
        f.seek(0)
        f.write(bytes(data))


# ---------------------------------------------------------------------------
# the enforced invariant: readable, or detectably partial -- never wrong
# ---------------------------------------------------------------------------


def check_trace_invariants(trace_dir: str) -> Dict[str, Any]:
    """Open ``trace_dir`` and force a full decode of every record it
    serves; returns a report dict.  The contract under any injected fault:
    either the directory reads cleanly, or the damage is *reported*
    (``skipped`` segments / ``degraded_epochs`` masks / a clean
    ``TraceFormatError``) -- a trace that decodes but misrepresents what
    happened is the one outcome this guard exists to rule out, and the
    callers (tests, ``benchmarks/fault_matrix.py``) assert on the report.
    """
    # local imports: faults is imported by the low-level writers, so the
    # reader stack must not be pulled in at module import time
    from .reader import TraceReader
    from .trace_format import TraceFormatError

    report: Dict[str, Any] = {"trace_dir": trace_dir, "readable": False,
                              "n_records": 0, "skipped": [],
                              "degraded_epochs": {}, "error": None}
    try:
        import warnings as _warnings
        with _warnings.catch_warnings():
            _warnings.simplefilter("ignore")
            reader = TraceReader(trace_dir, mode="stitched")
            n = 0
            for _rank, _rec in reader.all_records():
                n += 1
    except TraceFormatError as e:
        report["error"] = str(e)
        return report
    report["readable"] = True
    report["n_records"] = n
    report["skipped"] = list(reader.skipped)
    report["degraded_epochs"] = dict(getattr(reader, "degraded_epochs", {}))
    return report
