"""The Recorder runtime (paper Sections 2 and 3).

One ``Recorder`` instance per process (rank).  The generated tracing
wrappers (``wrappers.py``) call :meth:`Recorder.record` from their epilogue;
the record path performs, in order:

  * argument normalization by role (paths, unified handle ids, buffer
    lengths -- paper §2.2.1/§3.2.2),
  * runtime filtering by path prefix and layer (paper §2.1.1),
  * intra-process I/O pattern encoding of OFFSET-role args (paper §3.2.1),
  * CST interning of the call signature (paper §3.1),
  * Sequitur grammar append (paper §3.1),
  * timestamp buffering (paper §2.2.1).

``finalize`` runs the inter-process stage (paper §3.2.2/§3.3) through a
``Comm`` and writes the five trace files (unique CFGs, CFG index, merged
CST, timestamps, metadata).
"""

from __future__ import annotations

import concurrent.futures
import getpass
import os
import socket
import sys
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .comm import Comm, SoloComm
from .cst import CST
from .encode_backend import BACKENDS, require_device
from .encoding import Handle
from .interprocess import (deserialize_rank_state, finalize_ranks,
                           make_rank_state, materialize_state,
                           merge_serialized_states, serialize_rank_state)
from .patterns import IntraPatternTracker
from .sequitur import Sequitur, concat_grammars
from .specs import DATA_FUNCS, REGISTRY, FunctionRegistry, Role
from .timestamps import TimestampBuffer, compress_timestamps
from . import streaming, trace_format


def _env_int(name: str, minimum: int = 1) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(
            f"{name} must be an integer, got {raw!r}") from None
    if v < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {v}")
    return v


def _env_float(name: str, minimum: float = 0.0) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        v = float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}") from None
    if not v > minimum:
        raise ValueError(f"{name} must be > {minimum}, got {v}")
    return v


@dataclass
class RecorderConfig:
    trace_dir: Optional[str] = None
    layers: Optional[Set[str]] = None        # None = all layers enabled
    path_prefixes: Optional[List[str]] = None  # None = record everything
    intra_patterns: bool = True              # paper §3.2.1 toggle (Fig 4)
    inter_patterns: bool = True              # paper §3.2.2 toggle (Fig 5)
    timestamps: bool = True
    store_buffers: bool = False              # record buffer lengths only
    # "tree": hierarchical O(log N)-round reduction of serialized rank
    # states (interprocess.merge_rank_states) through Comm.reduce_tree.
    # "flat": the original gather-at-root pass, kept for bit-compat checks
    # (both produce byte-identical traces; see tests/test_tree_finalize.py).
    finalize_topology: str = "tree"
    # -- streaming (epoch flush) knobs; see core/streaming.py ----------------
    # auto-flush after this many locally recorded calls since the last flush
    flush_every_n_records: Optional[int] = None
    # auto-flush when this much wall time passed since the last flush
    flush_interval_s: Optional[float] = None
    # keep only the newest K committed epoch segments (live-monitoring ring)
    max_epochs_retained: Optional[int] = None
    # records per zlib block in the segment timestamp index
    ts_block_records: int = 4096
    # run epoch commits (reduce + segment write) in a background thread:
    # flush() snapshots the delta synchronously and returns immediately.
    # At most one epoch is in flight; a flush arriving while one is in
    # flight coalesces (its records ride the next epoch).  Errors from the
    # background commit surface on the next flush()/finalize()/drain().
    async_flush: bool = False
    # crash-resume: when flushing into an existing streaming trace
    # directory, rank 0 rebuilds the cumulative state from the committed
    # segments' state.bin deltas, so a preempted-and-restarted run keeps
    # appending epochs AND still writes a merged/ covering the full history
    resume: bool = True
    # degraded fault-tolerant flushes: when set (and the comm has true
    # point-to-point transport), every flush collective runs barrier-free
    # with this per-hop receive timeout -- an unresponsive rank is voted
    # around and the survivors commit a partial epoch carrying a
    # ranks_present mask; a rank whose delta missed the commit keeps it
    # in memory for the next attempt (see streaming.run_flush_degraded)
    flush_timeout_s: Optional[float] = None
    # backend for the batched encode/fit hot paths (timestamp delta+zigzag,
    # varint packing, rank-linear fitting): "python" (scalar reference),
    # "numpy" (vectorized host), "torch" (the kernels' plain PyTorch
    # versions on the CPU), "cuda" (the hand-written kernels on the card;
    # raises without one), or "auto" (crossover by batch size -- numpy on
    # CPU, kernels for large batches when a card is attached).  Grammar
    # and cfg_index packing follow encode_backend's module default instead.
    # Every backend writes byte-identical traces; see core/encode_backend.py.
    encode_backend: str = "cuda"

    def __post_init__(self) -> None:
        # the same bounds from_env enforces, so directly-constructed
        # configs (the README path) cannot silently degenerate -- e.g.
        # flush_every_n_records=0 would otherwise flush on EVERY record
        if (self.flush_every_n_records is not None
                and self.flush_every_n_records < 1):
            raise ValueError("flush_every_n_records must be >= 1, got "
                             f"{self.flush_every_n_records}")
        if self.flush_interval_s is not None and not self.flush_interval_s > 0:
            raise ValueError("flush_interval_s must be > 0, got "
                             f"{self.flush_interval_s}")
        if (self.max_epochs_retained is not None
                and self.max_epochs_retained < 1):
            raise ValueError("max_epochs_retained must be >= 1, got "
                             f"{self.max_epochs_retained}")
        if self.ts_block_records < 1:
            raise ValueError(
                f"ts_block_records must be >= 1, got {self.ts_block_records}")
        if self.flush_timeout_s is not None and not self.flush_timeout_s > 0:
            raise ValueError("flush_timeout_s must be > 0, got "
                             f"{self.flush_timeout_s}")
        if self.encode_backend not in BACKENDS:
            raise ValueError(f"encode_backend must be one of {BACKENDS}, "
                             f"got {self.encode_backend!r}")

    @classmethod
    def from_env(cls, **overrides) -> "RecorderConfig":
        """Environment-variable control, as in the original tool.

        Malformed streaming knobs raise ``ValueError`` naming the variable
        -- a long job silently falling back to "never flush" would defeat
        the crash-durability the knobs exist for.
        """
        cfg = cls(**overrides)
        layers = os.environ.get("RECORDER_LAYERS")
        if layers:
            cfg.layers = set(layers.split(","))
        prefixes = os.environ.get("RECORDER_PATH_PREFIXES")
        if prefixes:
            cfg.path_prefixes = prefixes.split(",")
        if os.environ.get("RECORDER_NO_INTRA_PATTERNS"):
            cfg.intra_patterns = False
        if os.environ.get("RECORDER_NO_INTER_PATTERNS"):
            cfg.inter_patterns = False
        topo = os.environ.get("RECORDER_FINALIZE_TOPOLOGY")
        if topo:
            cfg.finalize_topology = topo
        n = _env_int("RECORDER_FLUSH_EVERY_N_RECORDS")
        if n is not None:
            cfg.flush_every_n_records = n
        s = _env_float("RECORDER_FLUSH_INTERVAL_S")
        if s is not None:
            cfg.flush_interval_s = s
        k = _env_int("RECORDER_MAX_EPOCHS_RETAINED")
        if k is not None:
            cfg.max_epochs_retained = k
        b = _env_int("RECORDER_TS_BLOCK_RECORDS")
        if b is not None:
            cfg.ts_block_records = b
        if os.environ.get("RECORDER_ASYNC_FLUSH"):
            cfg.async_flush = True
        if os.environ.get("RECORDER_NO_RESUME"):
            cfg.resume = False
        t = _env_float("RECORDER_FLUSH_TIMEOUT_S")
        if t is not None:
            cfg.flush_timeout_s = t
        eb = os.environ.get("RECORDER_ENCODE_BACKEND")
        if eb:
            if eb not in BACKENDS:
                raise ValueError(
                    f"RECORDER_ENCODE_BACKEND must be one of {BACKENDS}, "
                    f"got {eb!r}")
            cfg.encode_backend = eb
        return cfg


@dataclass
class RecorderStats:
    n_records: int = 0
    n_skipped: int = 0
    cst_entries: int = 0
    cfg_bytes: int = 0
    cst_bytes: int = 0
    ts_bytes: int = 0
    epochs: int = 0   # committed streaming flushes (0 for one-shot traces)


class _ThreadState(threading.local):
    def __init__(self) -> None:
        self.depth = 0
        # this thread's dense index into the trace's thread column.  Kept in
        # thread-local storage, NOT in a dict keyed by threading.get_ident():
        # the OS recycles identifiers, so sequential short-lived threads would
        # collapse into one trace thread under an ident-keyed map.
        self.tidx: Optional[int] = None


class Recorder:
    def __init__(self, rank: int = 0, config: Optional[RecorderConfig] = None,
                 registry: FunctionRegistry = REGISTRY,
                 comm: Optional[Comm] = None) -> None:
        self.rank = rank
        self.config = config or RecorderConfig()
        # a "cuda" recorder without a card fails here, not at its first
        # flush or finalize
        require_device(self.config.encode_backend)
        self.registry = registry
        self.cst = CST()
        self.grammar = Sequitur()
        self.intra = IntraPatternTracker(enabled=self.config.intra_patterns)
        self.timestamps = TimestampBuffer()
        self._lock = threading.Lock()
        self._tls = _ThreadState()
        self._next_thread_index = 0
        self._handles: Dict[Any, Handle] = {}
        self._untracked: Set[Any] = set()
        self._next_handle = 0
        self._free_handles: Set[int] = set()  # reuse closed ids (fd-like)
        self._t0 = time.perf_counter()
        self.n_records = 0
        self.n_skipped = 0
        self._finalized = False
        # -- streaming state (core/streaming.py) --------------------------------
        self._comm = comm                 # default comm for flush/finalize
        self.epoch = 0                    # committed flushes so far
        self._records_at_flush = 0
        self._last_flush_t = time.perf_counter()
        self._flush_lock = threading.Lock()
        self._autoflush_broken = False
        # rank 0 only: the O(delta)-per-flush cross-epoch accumulator, and
        # summed per-flush byte sizes for the final RecorderStats
        self._cum = streaming.CumulativeState()
        self._stream_totals = RecorderStats()
        # a snapshotted epoch whose commit failed (or committed without
        # this rank): prepended to the next take_epoch so the next
        # successful flush covers those records exactly once
        self._pending: Optional[Tuple[List[bytes], bytes, Any, int]] = None
        self._records_at_flush_prev = 0
        self._resume_checked = False
        self.epochs_resumed = 0    # epochs recovered by crash-resume
        self.epochs_degraded = 0   # commits that went through partial
        self.epochs_restored = 0   # failed commits whose delta was kept
        self.last_flush_outcome: Optional[streaming.FlushOutcome] = None
        # first (unmasked) tick of the current epoch -> per-epoch wrap base
        self._epoch_first_tick: Optional[int] = None
        # -- async flush state (config.async_flush) -----------------------------
        self._flush_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._inflight: Optional[concurrent.futures.Future] = None
        self._async_error: Optional[BaseException] = None
        self._bg_comm: Optional[Comm] = None
        self.epochs_coalesced = 0  # flush requests absorbed by an in-flight one

    # -- wrapper support ------------------------------------------------------

    def now(self) -> int:
        """Microsecond ticks since recorder start (4-byte timestamps)."""
        return int((time.perf_counter() - self._t0) * 1e6)

    def enter(self) -> int:
        d = self._tls.depth
        self._tls.depth = d + 1
        return d

    def exit(self) -> None:
        self._tls.depth -= 1

    def layer_enabled(self, layer: str) -> bool:
        return self.config.layers is None or layer in self.config.layers

    # -- the record path ------------------------------------------------------

    def _alloc_handle(self) -> Handle:
        """Smallest-free-id allocation: re-opening after close yields the
        SAME unified id (as POSIX fds do), so periodic re-writes of the same
        file (rolling checkpoints) produce identical call signatures."""
        if self._free_handles:
            hid = min(self._free_handles)
            self._free_handles.discard(hid)
            return Handle(hid)
        h = Handle(self._next_handle)
        self._next_handle += 1
        return h

    def _thread_index(self) -> int:
        """Dense per-thread index, assigned on a thread's first record
        (callers hold ``self._lock``, serializing the counter)."""
        idx = self._tls.tidx
        if idx is None:
            idx = self._next_thread_index
            self._next_thread_index += 1
            self._tls.tidx = idx
        return idx

    def record(self, func_id: int, raw_args: tuple, ret: Any, depth: int,
               t0: int, t1: int) -> None:
        spec = self.registry.spec(func_id)
        with self._lock:
            self._record_locked(spec, func_id, raw_args, ret, depth, t0, t1)
        if self._tls.depth == 0:
            # auto-flush only from top-level calls (a flush inside a layered
            # call would split parent and child records across epochs)
            self._maybe_autoflush()

    def _record_locked(self, spec, func_id: int, raw_args: tuple, ret: Any,
                       depth: int, t0: int, t1: int) -> None:
        tidx = self._thread_index()
        norm: List[Any] = []
        offsets: List[int] = []
        offset_slots: List[int] = []
        handle_ids: List[int] = []
        keyparts: List[Any] = []
        prefixes = self.config.path_prefixes
        for i, arg in enumerate(raw_args):
            role = spec.args[i].role if i < len(spec.args) else Role.VAL
            if role == Role.PATH:
                p = str(arg)
                if prefixes is not None and not any(
                        p.startswith(x) for x in prefixes):
                    # filtered out: skip the record entirely; if this call
                    # creates a handle, remember it as untracked
                    if spec.ret_role == Role.HANDLE and ret is not None:
                        self._untracked.add(ret)
                    self.n_skipped += 1
                    return
                norm.append(p)
                keyparts.append(p)
            elif role == Role.HANDLE:
                if arg in self._untracked:
                    self.n_skipped += 1
                    return
                h = self._handles.get(arg)
                if h is None:
                    # handle from before tracing started: late-register
                    h = self._alloc_handle()
                    self._handles[arg] = h
                norm.append(h)
                handle_ids.append(h.id)
            elif role == Role.OFFSET:
                offsets.append(int(arg))
                offset_slots.append(len(norm))
                norm.append(None)  # placeholder, filled below
            elif role == Role.BUF:
                v = len(arg) if hasattr(arg, "__len__") else (
                    int(arg) if isinstance(arg, int) else None)
                norm.append(v)
                keyparts.append(v)
            else:  # SIZE / VAL
                norm.append(arg)
                keyparts.append(arg)

        # normalize the return value
        is_err = isinstance(ret, tuple) and len(ret) == 2 and ret[0] == "err"
        if spec.ret_role == Role.HANDLE and ret is not None and not is_err:
            # layered opens (shard_open -> posix.open) return the same
            # raw handle: they share one unified id (paper Section 3.2.2)
            h = self._handles.get(ret)
            if h is None:
                h = self._alloc_handle()
                self._handles[ret] = h
            nret: Any = h
        elif spec.ret_role == Role.BUF and hasattr(ret, "__len__"):
            nret = len(ret)
        else:
            nret = ret
        if isinstance(nret, Handle):
            key_ret: Any = ("h", nret.id)
        else:
            key_ret = nret

        # OFFSET-role returns (e.g. lseek's resulting offset) join the
        # pattern run; they cannot be part of the pattern key then.
        ret_is_offset = (spec.ret_role == Role.OFFSET
                         and isinstance(nret, int) and not is_err)

        # intra-process I/O pattern encoding (paper §3.2.1)
        if offsets or ret_is_offset:
            key = (func_id, tidx, tuple(handle_ids), tuple(keyparts),
                   None if ret_is_offset else key_ret)
            vals = offsets + ([nret] if ret_is_offset else [])
            encoded = self.intra.encode(key, vals)
            for slot, val in zip(offset_slots, encoded):
                norm[slot] = val
            if ret_is_offset:
                nret = encoded[-1]

        sig = trace_format.make_signature(func_id, tidx, depth, tuple(norm), nret)
        terminal = self.cst.intern(sig)
        self.grammar.push(terminal)
        if self.config.timestamps:
            if self._epoch_first_tick is None:
                self._epoch_first_tick = t0
            self.timestamps.append(t0, t1,
                                   self._data_bytes(spec, norm, nret))
        self.n_records += 1

    @staticmethod
    def _data_bytes(spec, norm: List[Any], nret: Any) -> int:
        """Data bytes moved by this call, for the per-timestamp-block byte
        counters (exact windowed bandwidth).  Mirrors the signature-side
        rule in ``traceview._SigInfo``: first BUF/SIZE int arg, else int
        return, else 0 -- and only for the data-moving functions."""
        if spec.name not in DATA_FUNCS:
            return 0
        for a, v in zip(spec.args, norm):
            if a.role in (Role.BUF, Role.SIZE) and isinstance(v, int):
                return v
        return nret if isinstance(nret, int) else 0

    def forget_handle(self, raw: Any) -> None:
        """Called by close-style wrappers after recording."""
        with self._lock:
            h = self._handles.pop(raw, None)
            if h is not None:
                self._free_handles.add(h.id)
            self._untracked.discard(raw)

    # -- streaming epoch flushes (core/streaming.py) --------------------------

    def _is_streaming(self) -> bool:
        # an in-flight (or failed-but-unreaped) background commit counts:
        # finalize must take the streaming path and drain it even when a
        # failure's _restore_epoch already rolled the epoch counter back
        return (self.epoch > 0
                or self._inflight is not None
                or self._async_error is not None
                or self.config.flush_every_n_records is not None
                or self.config.flush_interval_s is not None)

    def take_epoch(self) -> Tuple[List[bytes], bytes, Any, int]:
        """Snapshot and reset the live per-rank state: returns the epoch's
        (CST entries, serialized CFG, raw tick array, tick wrap counter)
        and restarts the CST, grammar and intra-pattern tracker for the
        next epoch.  Handle ids and the tick clock persist across epochs,
        so cross-epoch streams stitch back into the exact one-shot record
        sequence.  The wrap counter is how many times the uint32
        microsecond clock had wrapped at the epoch's first record --
        readers seed timestamp unwrapping with it, so days-long streamed
        runs keep monotonic int64 timestamps.

        A pending snapshot from a failed earlier commit is spliced in
        FRONT of the live delta (CST concat + ``concat_grammars`` -- the
        same layout segment stitching produces), so retried records land
        in the next committed epoch exactly once."""
        with self._lock:
            entries = self.cst.entries
            cfg = self.grammar.serialize()
            ticks = self.timestamps.take()
            wraps = (self._epoch_first_tick or 0) >> 32
            self._epoch_first_tick = None
            self.cst = CST()
            self.grammar = Sequitur()
            self.intra = IntraPatternTracker(
                enabled=self.config.intra_patterns)
            self._records_at_flush_prev = self._records_at_flush
            self._records_at_flush = self.n_records
            if self._pending is not None:
                p_entries, p_cfg, p_ticks, p_wraps = self._pending
                self._pending = None
                cfg = concat_grammars([(p_cfg, 0), (cfg, len(p_entries))])
                entries = list(p_entries) + list(entries)
                if len(p_ticks):
                    ticks = np.concatenate([p_ticks, ticks], axis=0) \
                        if len(ticks) else p_ticks
                    wraps = p_wraps
        return entries, cfg, ticks, wraps

    def flush(self, comm: Optional[Comm] = None,
              trace_dir: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Commit one epoch segment without stopping tracing (collective:
        every rank of ``comm`` must call it in the same order).

        The epoch delta is reduced across ranks through
        ``comm.reduce_tree`` (O(delta), O(log N) rounds); timestamps ride
        the same tree as block-indexed zlib blocks via
        ``comm.gather_tree``.  Rank 0 folds the delta into the cumulative
        state, writes ``epoch_NNNNN/`` (atomic rename + manifest rewrite)
        and returns the manifest entry; other ranks return None.

        With ``config.async_flush`` the call only snapshots the delta
        (cheap, no compression or I/O) and hands reduce+commit to a
        background thread, returning None immediately.  At most one epoch
        is in flight: a flush arriving while one is still committing
        coalesces -- its records simply ride the next epoch (counted in
        ``epochs_coalesced``).  On a multi-rank comm the coalesce decision
        is taken in lockstep (``comm.vote_any`` of the local busy flags),
        so ranks never disagree on how many epochs exist; the background
        collectives run on ``comm.dup('recorder-flush')``, a separate
        communication context that cannot interleave with foreground
        collectives on ``comm``.  A failed background commit surfaces as a
        RuntimeError (with the original failure chained) on the NEXT
        flush()/drain()/finalize() -- it never vanishes.
        """
        if self._finalized:
            raise RuntimeError("recorder already finalized")
        comm = comm or self._comm or SoloComm()
        trace_dir = trace_dir or self.config.trace_dir
        if not trace_dir:
            raise ValueError("flush requires a trace_dir")
        with self._flush_lock:
            if self._finalized:  # re-check: finalize may have won the lock
                raise RuntimeError("recorder already finalized")
            return self._flush_impl(comm, trace_dir)

    def _maybe_resume(self, comm: Comm, trace_dir: str) -> None:
        """Crash-resume: before the first commit into an EXISTING stream
        directory, rank 0 rebuilds the cross-epoch cumulative state by
        folding the committed segments' ``state.bin`` deltas
        (:func:`streaming.resume_cumulative_state`), so a preempted-and-
        restarted run keeps appending epochs AND a clean finalize still
        writes ``merged/`` covering the FULL history.  Checked once per
        recorder; disabled by ``config.resume=False`` and meaningless
        under ring retention (no merged trace there).  An unresumable
        directory (corrupt/truncated segment) degrades to the old
        append-without-merged behavior with a warning."""
        if self._resume_checked:
            return
        self._resume_checked = True
        if (not self.config.resume or comm.rank != 0
                or self.config.max_epochs_retained is not None
                or self._cum.n_epochs != 0
                or not trace_dir or not trace_format.is_stream_dir(trace_dir)):
            return
        try:
            cum = streaming.resume_cumulative_state(trace_dir)
        except trace_format.TraceFormatError as e:
            warnings.warn(
                f"cannot resume cumulative state from existing trace dir "
                f"{trace_dir!r} ({e}); new epochs will append but no "
                f"full-history merged trace can be written on finalize",
                RuntimeWarning)
            return
        if cum.n_epochs:
            self._cum = cum
            self.epochs_resumed = cum.n_epochs

    def _flush_impl(self, comm: Comm, trace_dir: str
                    ) -> Optional[Dict[str, Any]]:
        self._maybe_resume(comm, trace_dir)
        if self.config.async_flush:
            return self._flush_async_locked(comm, trace_dir)
        return self._flush_locked(comm, trace_dir)

    def _flush_locked(self, comm: Comm, trace_dir: str
                      ) -> Optional[Dict[str, Any]]:
        entries, cfg, ticks, wraps = self.take_epoch()
        epoch = self.epoch
        self.epoch += 1
        self._last_flush_t = time.perf_counter()
        return self._commit_epoch(comm, trace_dir, entries, cfg, ticks,
                                  wraps, epoch)

    def _flush_async_locked(self, comm: Comm, trace_dir: str) -> None:
        self._reap()
        self._raise_async_error()
        busy = self._inflight is not None
        if comm.size > 1:
            # lockstep coalesce: if ANY rank is still committing, every
            # rank coalesces -- local decisions could desync epoch counts
            busy = self._vote(comm, busy)
        if busy:
            self.epochs_coalesced += 1
            return None
        entries, cfg, ticks, wraps = self.take_epoch()
        epoch = self.epoch
        self.epoch += 1
        self._last_flush_t = time.perf_counter()
        if self._bg_comm is None:
            self._bg_comm = comm.dup("recorder-flush")
        self._inflight = self._pool().submit(
            self._commit_epoch, self._bg_comm, trace_dir, entries, cfg,
            ticks, wraps, epoch)
        return None

    def _degraded(self, comm: Comm) -> bool:
        """True when flushes run the timed, failure-tolerant protocol:
        a flush timeout is configured and the comm has a p2p transport
        (the degraded collectives are barrier-free p2p trees)."""
        return (self.config.flush_timeout_s is not None
                and comm.size > 1
                and getattr(comm, "has_p2p", False))

    def _vote(self, comm: Comm, flag: bool) -> bool:
        """Lockstep OR-vote; under the degraded protocol uses the timed
        survivor vote so a dead rank cannot hang cadence decisions."""
        if self._degraded(comm):
            return comm.agree(flag, self.config.flush_timeout_s)[0]
        return comm.vote_any(flag)

    def _restore_epoch(self, entries: List[bytes], cfg: bytes, ticks: Any,
                       wraps: int) -> None:
        """Put a snapshotted-but-uncommitted epoch delta back: the next
        ``take_epoch`` splices it in front of the live delta, so a failed
        flush loses nothing and the retry covers its records exactly
        once.  A second failure before the retry keeps the OLDEST
        snapshot's splice position (it already contains this one)."""
        with self._lock:
            self._pending = (entries, cfg, ticks, wraps)
            self._records_at_flush = self._records_at_flush_prev
            self.epoch -= 1
            self.epochs_restored += 1

    def _commit_epoch(self, comm: Comm, trace_dir: str, entries: List[bytes],
                      cfg: bytes, ticks: Any, wraps: int, epoch: int
                      ) -> Optional[Dict[str, Any]]:
        """Reduce + write one already-snapshotted epoch (the part a
        background flush moves off the application's critical path).

        Any failure path restores the snapshot into ``_pending`` before
        propagating, so epoch records are never silently dropped: a
        crashed write, a lost survivor vote, or this rank being absent
        from a degraded commit all leave the delta intact for the next
        flush attempt."""
        try:
            if self._degraded(comm):
                outcome = streaming.run_flush_degraded(
                    comm, entries=entries, cfg=cfg, ticks=ticks,
                    registry=self.registry, trace_dir=trace_dir, epoch=epoch,
                    cum=self._cum, inter_patterns=self.config.inter_patterns,
                    ts_block_records=self.config.ts_block_records,
                    max_epochs_retained=self.config.max_epochs_retained,
                    meta_extra={**self._metadata(comm.size),
                                "tick_wraps": wraps},
                    timeout_s=self.config.flush_timeout_s,
                    encode_backend=self.config.encode_backend)
                self.last_flush_outcome = outcome
                if outcome.exc is not None:
                    raise outcome.exc
                if outcome.lost_local or not outcome.ok:
                    self._restore_epoch(entries, cfg, ticks, wraps)
                    warnings.warn(
                        f"epoch {epoch} flush did not include this rank "
                        f"({outcome.error or 'commit outcome unknown'}); "
                        f"its records were retained and ride the next "
                        f"flush", RuntimeWarning)
                    return None
                if (comm.rank == 0 and outcome.ranks_present
                        and len(outcome.ranks_present) < comm.size):
                    self.epochs_degraded += 1
                entry = outcome.entry
            else:
                entry = streaming.run_flush(
                    comm, entries=entries, cfg=cfg, ticks=ticks,
                    registry=self.registry, trace_dir=trace_dir, epoch=epoch,
                    cum=self._cum, inter_patterns=self.config.inter_patterns,
                    ts_block_records=self.config.ts_block_records,
                    max_epochs_retained=self.config.max_epochs_retained,
                    meta_extra={**self._metadata(comm.size),
                                "tick_wraps": wraps},
                    encode_backend=self.config.encode_backend)
        except BaseException:
            self._restore_epoch(entries, cfg, ticks, wraps)
            raise
        if entry is not None:
            t = self._stream_totals
            t.epochs += 1
            t.cst_entries += entry["cst_entries"]
            t.cfg_bytes += entry["files"]["unique_cfgs.bin"]
            t.cst_bytes += entry["files"]["merged_cst.bin"]
            t.ts_bytes += entry["files"]["timestamps.bin"]
        return entry

    # -- async flush plumbing -------------------------------------------------

    def _pool(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._flush_pool is None:
            self._flush_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="recorder-flush")
        return self._flush_pool

    def _reap(self) -> None:
        """Collect a finished in-flight future; stash its failure (if any)
        for :meth:`_raise_async_error`.  Callers hold ``_flush_lock``."""
        fut = self._inflight
        if fut is not None and fut.done():
            self._inflight = None
            exc = fut.exception()
            if exc is not None:
                self._async_error = exc

    def _raise_async_error(self) -> None:
        exc, self._async_error = self._async_error, None
        if exc is not None:
            raise RuntimeError(
                "background epoch commit failed; its epoch's records were "
                "retained (restored as a pending delta that rides the next "
                "flush) and the trace directory and cumulative state remain "
                "consistent") from exc

    def _drain_locked(self) -> None:
        fut = self._inflight
        if fut is not None:
            concurrent.futures.wait([fut])
            self._reap()
        self._raise_async_error()

    def drain(self) -> None:
        """Block until any in-flight background epoch commit finished;
        re-raise its error if it failed.  Safe to call with async flushes
        disabled (no-op)."""
        with self._flush_lock:
            self._drain_locked()

    def maybe_flush(self, comm: Optional[Comm] = None,
                    trace_dir: Optional[str] = None
                    ) -> Optional[Dict[str, Any]]:
        """Collective cadence check -- call at a natural synchronization
        point (e.g. once per training step) on EVERY rank.  Each rank
        votes whether its own flush cadence (records / wall time) is due;
        the OR of the votes decides for all, so ranks with skewed record
        counts (non-SPMD workloads) still flush in lockstep.  Flushes via
        :meth:`flush` when the vote passes, else returns None after the
        one cheap vote collective (a barrier-sized piggyback)."""
        if self._finalized:
            return None
        comm = comm or self._comm or SoloComm()
        due = self._flush_due()
        if comm.size > 1:
            due = self._vote(comm, due)
        if not due:
            return None
        return self.flush(comm, trace_dir)

    def _flush_due(self) -> bool:
        cfg = self.config
        if (cfg.flush_every_n_records is not None
                and self.n_records - self._records_at_flush
                >= cfg.flush_every_n_records):
            return True
        return (cfg.flush_interval_s is not None
                and time.perf_counter() - self._last_flush_t
                >= cfg.flush_interval_s)

    def _maybe_autoflush(self) -> None:
        """Auto-flush on the configured record-count / wall-time cadence.

        Cadence is evaluated per rank against the recorder's own comm
        (default Solo).  A multi-rank comm never auto-flushes: flush is
        collective, and a rank-local record count crossing its threshold
        is not a synchronization point -- multi-rank jobs flush through
        the :meth:`maybe_flush` vote (or explicit :meth:`flush`) at
        application sync points.

        Concurrent recording threads race the dueness check, so it is
        re-evaluated under the flush lock and a thread that finds a flush
        already in progress simply moves on -- one cadence crossing
        produces exactly one epoch, never a spurious empty second one.

        Auto-flush runs inside the application's traced call, so a trace-
        volume failure (ENOSPC, removed trace_dir) must not surface -- or
        worse, REPLACE an in-flight exception -- in an unrelated I/O call:
        the failure is warned once and auto-flush disables itself; explicit
        ``flush()`` / ``finalize()`` still raise.
        """
        cfg = self.config
        if (cfg.trace_dir is None or self._finalized
                or self._autoflush_broken
                or (cfg.flush_every_n_records is None
                    and cfg.flush_interval_s is None)):
            return
        if self._comm is not None and self._comm.size > 1:
            # a rank-local cadence crossing is not a synchronization point
            # in a multi-rank job, and flush is collective there; cadence
            # goes through the maybe_flush vote at app sync points instead
            return
        if not self._flush_due():
            return
        if not self._flush_lock.acquire(blocking=False):
            return  # another thread is flushing this very crossing
        try:
            # re-check under the lock: the flush we raced may have
            # satisfied the cadence, or finalize may have completed
            if not self._finalized and self._flush_due():
                self._flush_impl(self._comm or SoloComm(), cfg.trace_dir)
        except Exception as e:
            self._autoflush_broken = True
            warnings.warn(
                f"recorder auto-flush failed ({type(e).__name__}: {e}); "
                f"auto-flush disabled, tracing continues -- call flush() "
                f"or finalize() explicitly to surface the error",
                RuntimeWarning)
        finally:
            self._flush_lock.release()

    # -- finalization (paper §3.3) --------------------------------------------

    def local_state(self) -> Tuple[List[bytes], bytes, bytes]:
        """(CST entries, serialized CFG, compressed timestamps)."""
        ts = compress_timestamps(self.timestamps.as_array(),
                                 backend=self.config.encode_backend)
        return self.cst.entries, self.grammar.serialize(), ts

    def finalize(self, comm: Optional[Comm] = None,
                 trace_dir: Optional[str] = None) -> Optional[RecorderStats]:
        """Run the inter-process stage and write the trace (root returns
        stats; other ranks return None).

        ``config.finalize_topology`` selects how rank states reach rank 0:
        ``"tree"`` reduces serialized states pairwise through
        ``comm.reduce_tree`` in O(log N) rounds (each hop merges two
        contiguous rank blocks, so rank 0 only materializes the already
        merged state); ``"flat"`` gathers every raw CST/CFG to rank 0 and
        merges there.  Both write byte-identical traces; tree timestamps
        travel as one concatenated payload per hop (``comm.gather_tree``),
        bounding rank-0 fan-in, while flat keeps the reference gather.

        **Streaming runs** (any flush happened, or flush cadence knobs are
        set) finalize differently: the remaining tail is flushed as the
        last epoch segment and rank 0 materializes the cumulative
        cross-epoch state into ``<trace_dir>/merged`` -- the incremental
        finalize: no re-reduction of earlier epochs ever happens.
        """
        if self._finalized:
            raise RuntimeError("recorder already finalized")
        comm = comm or self._comm or SoloComm()
        trace_dir = trace_dir or self.config.trace_dir
        if self._is_streaming():
            if not trace_dir:
                raise ValueError("streaming finalize requires a trace_dir")
            # drain any in-flight background commit FIRST (its failure must
            # surface here, not vanish), then flush the tail synchronously;
            # the tail flush is skippable only when provably empty AND the
            # decision needs no agreement (solo comm) -- multi-rank flushes
            # are collective, so every rank must make the same call.  The
            # _finalized flip happens under the flush lock so a racing
            # auto-flush can never commit an epoch after the tail (it
            # re-checks the flag under the same lock).  Safe to wait on the
            # future while holding the lock: the background commit never
            # takes it.
            with self._flush_lock:
                self._drain_locked()
                self._maybe_resume(comm, trace_dir)
                if (comm.size > 1 or self.epoch == 0
                        or self.n_records > self._records_at_flush):
                    self._flush_locked(comm, trace_dir)
                self._finalized = True
            if self._flush_pool is not None:
                self._flush_pool.shutdown(wait=True)
                self._flush_pool = None
            if comm.rank != 0:
                self._finalize_sync(comm)
                return None
            if self.config.max_epochs_retained is None:
                streaming.write_merged_trace(
                    trace_dir, self._cum, registry=self.registry,
                    inter_patterns=self.config.inter_patterns,
                    meta_extra=self._metadata(comm.size))
            stats = self._stream_totals
            stats.n_records = self.n_records
            stats.n_skipped = self.n_skipped
            self._finalize_sync(comm)
            return stats
        self._finalized = True
        if self.config.finalize_topology not in ("tree", "flat"):
            raise ValueError(
                f"finalize_topology must be 'tree' or 'flat', got "
                f"{self.config.finalize_topology!r}")
        entries, cfg, ts = self.local_state()
        if self.config.finalize_topology == "tree":
            leaf = make_rank_state(comm.rank, entries, cfg, self.registry)
            blob = comm.reduce_tree(serialize_rank_state(leaf),
                                    merge_serialized_states)
            ts_gathered = comm.gather_tree(ts)
            if comm.rank != 0:
                comm.barrier()
                return None
            rank_ts = ts_gathered
            merge, cfgs = materialize_state(
                deserialize_rank_state(blob),
                inter_patterns=self.config.inter_patterns)
        else:
            gathered = comm.gather((entries, cfg, ts))
            if comm.rank != 0:
                comm.barrier()
                return None
            rank_csts = [g[0] for g in gathered]
            rank_cfgs = [g[1] for g in gathered]
            rank_ts = [g[2] for g in gathered]
            merge, cfgs = finalize_ranks(
                rank_csts, rank_cfgs, self.registry,
                inter_patterns=self.config.inter_patterns,
                fit_mode=("cuda" if self.config.encode_backend == "cuda"
                          else "vectorized"))
        stats = RecorderStats(
            n_records=self.n_records,
            n_skipped=self.n_skipped,
            cst_entries=len(merge.merged_entries),
            cfg_bytes=sum(len(c) for c in cfgs.unique_cfgs),
            cst_bytes=sum(len(e) + 2 for e in merge.merged_entries),
            ts_bytes=sum(len(t) for t in rank_ts),
        )
        if trace_dir:
            trace_format.write_trace(
                trace_dir,
                registry=self.registry,
                merged_cst=merge.merged_entries,
                unique_cfgs=cfgs.unique_cfgs,
                cfg_index=cfgs.cfg_index,
                rank_timestamps=rank_ts,
                meta_extra=self._metadata(comm.size),
            )
        comm.barrier()
        return stats

    def _finalize_sync(self, comm: Comm) -> None:
        """Finalize-time synchronization point.  A plain barrier would
        wedge survivors forever if a rank died mid-run, so under the
        degraded protocol it is the timed survivor vote instead (same
        exit discipline, bounded wait)."""
        if self._degraded(comm):
            comm.agree(True, self.config.flush_timeout_s)
        else:
            comm.barrier()

    def _metadata(self, nranks: int) -> Dict[str, Any]:
        try:
            user = getpass.getuser()
        except Exception:  # pragma: no cover
            user = "unknown"
        return {
            "nranks": nranks,
            "app": os.path.basename(sys.argv[0]) if sys.argv else "unknown",
            "user": user,
            "host": socket.gethostname(),
            "pid": os.getpid(),
            "layers": sorted(self.config.layers) if self.config.layers else "all",
            "intra_patterns": self.config.intra_patterns,
            "inter_patterns": self.config.inter_patterns,
            "tick_unit": "us",
            "tick_wrap": 2 ** 32,
        }


# ---------------------------------------------------------------------------
# the active-recorder slot used by generated wrappers (LD_PRELOAD analogue)
# ---------------------------------------------------------------------------

_active: List[Optional[Recorder]] = [None]


def attach(rec: Recorder) -> None:
    _active[0] = rec


def detach() -> None:
    _active[0] = None


def active() -> Optional[Recorder]:
    return _active[0]


class session:
    """Context manager: trace a region and finalize on exit.

    >>> with session(RecorderConfig(trace_dir="/tmp/t")) as rec:
    ...     posix.open(...)  # traced
    """

    def __init__(self, config: Optional[RecorderConfig] = None,
                 comm: Optional[Comm] = None, rank: int = 0):
        self.config = config
        self.comm = comm
        self.rank = rank
        self.recorder: Optional[Recorder] = None
        self.stats: Optional[RecorderStats] = None

    def __enter__(self) -> Recorder:
        self.recorder = Recorder(rank=self.rank, config=self.config,
                                 comm=self.comm)
        attach(self.recorder)
        return self.recorder

    def __exit__(self, *exc) -> None:
        detach()
        if self.recorder is not None and exc[0] is None:
            self.stats = self.recorder.finalize(self.comm)
