"""Streaming trace subsystem: epoch flushes and incremental finalize.

The one-shot pipeline (record -> ``Recorder.finalize`` at exit) gives a
long-running job no trace at all if it is preempted mid-run.  This module
adds **run-while-tracing** durability on top of the paper's compression
machinery (the mergeable :class:`~repro.core.interprocess.RankState`s of
Section 3.2.2/3.3):

``Recorder.flush`` (a collective)
    snapshots every rank's live CST/CFG/timestamp state into an **epoch
    delta** without stopping tracing, reduces ONLY that delta across ranks
    through ``Comm.reduce_tree`` (O(log N) rounds over serialized states),
    and commits one crash-durable **epoch segment** -- a complete five-file
    mini trace of the flush window, plus the epoch's serialized cross-rank
    state (``state.bin``).  Per-rank timestamp payloads ride the same
    reduction tree (``Comm.gather_tree``) as block-indexed zlib blocks, so
    rank 0 never absorbs ``size`` simultaneous messages.

:class:`CumulativeState` (incremental finalize)
    rank 0 folds each epoch's reduced delta into a running cross-epoch
    state in **O(delta)** -- groups are inserted into one mutable dict and
    per-rank terminal streams are kept as lists of epoch parts whose
    concatenation is deferred to :meth:`CumulativeState.to_rank_state`.  A
    clean ``finalize`` therefore materializes the full merged trace from
    the already-merged state instead of re-reducing the whole history
    (``merged/`` in the trace directory).  The pure reference semantics
    live in :func:`interprocess.append_epoch_state`; the two are
    property-tested to produce identical states.

Multi-segment trace directory (``trace_format`` streaming layout)
    ``manifest.json`` lists committed segments with per-file byte sizes;
    segments are written under ``.tmp`` names and committed by atomic
    rename + atomic manifest rewrite, so a crash can never expose a
    half-written segment, and post-commit corruption (truncation) is
    detected from the recorded sizes and the segment skipped on read.

:func:`stitch_segments` (the read side)
    concatenates committed segments back into ONE logical trace: merged
    CSTs are concatenated (per-segment terminal offsets), per-rank CFGs
    are spliced with :func:`sequitur.concat_grammars` (expansion ==
    concatenation of the epochs' streams), and timestamps are served by a
    :class:`StitchedTimestampStore` over the per-segment block indexes --
    so every existing ``TraceView`` query runs unchanged on a streaming
    trace, value-identical to a one-shot finalize of the same calls
    (property-tested in ``tests/test_streaming.py``).
"""

from __future__ import annotations

import os
import shutil
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import faults, trace_format
from .comm import CommTimeout
from .interprocess import (CfgResult, MergeResult, RankState,
                           deserialize_rank_state, epoch_occ_counts,
                           make_rank_state, materialize_state,
                           merge_serialized_states, serialize_rank_state)
from .sequitur import Sequitur, concat_grammars, parse_grammar, terminal_counts
from .specs import FunctionRegistry
from .timestamps import (BlockedTimestampStore, TimestampStore, TsBlock,
                         compress_timestamps_blocked, pack_ts_blocks,
                         unpack_ts_blocks)

MERGED_DIR = "merged"


# ---------------------------------------------------------------------------
# incremental cross-epoch accumulation (rank 0)
# ---------------------------------------------------------------------------


class CumulativeState:
    """O(delta)-per-epoch accumulator of reduced epoch states.

    Semantically equivalent to folding epochs through the pure reference
    :func:`interprocess.append_epoch_state` (the two produce byte-identical
    serialized states), but built for streaming: ``append`` never rescans
    earlier epochs.  Groups land in one mutable dict keyed by
    occurrence-shifted ``(masked signature, occ)``; per-rank terminal
    streams are kept as sequences of deduplicated **epoch parts** and only
    concatenated (grammars via :func:`sequitur.concat_grammars`) when
    :meth:`to_rank_state` materializes the final merged state.
    """

    def __init__(self) -> None:
        self.base: Optional[int] = None
        self.n: Optional[int] = None
        self.groups: Dict[Tuple[bytes, int], Any] = {}
        self.occ_counts: Dict[bytes, int] = {}
        # unique (cfg bytes, occurrence-shifted row gkeys) epoch stream parts
        self.parts: List[Tuple[bytes, tuple]] = []
        self.rank_parts: List[List[int]] = []  # per local rank: part indices
        self.n_epochs = 0

    def append(self, delta: RankState) -> None:
        """Fold one epoch's cross-rank reduced state in.  O(delta groups +
        delta stream rows + nranks); ``delta`` is absorbed."""
        if self.n is None:
            self.base, self.n = delta.base, delta.n
            self.rank_parts = [[] for _ in range(delta.n)]
        elif (self.base, self.n) != (delta.base, delta.n):
            raise ValueError(
                f"epoch covers ranks [{delta.base},{delta.base + delta.n}), "
                f"cumulative state covers [{self.base},{self.base + self.n})")
        occ = self.occ_counts
        key_map: Dict[Tuple[bytes, int], Tuple[bytes, int]] = {}
        for (mkey, j), g in delta.groups.items():
            nk = (mkey, occ.get(mkey, 0) + j)
            key_map[(mkey, j)] = nk
            self.groups[nk] = g
        for mkey, cnt in epoch_occ_counts(delta).items():
            occ[mkey] = occ.get(mkey, 0) + cnt
        part_of = []
        for cfg_e, rows_e in delta.streams:
            part_of.append(len(self.parts))
            self.parts.append((cfg_e, tuple(key_map[k] for k in rows_e)))
        for j, si in enumerate(delta.stream_of):
            self.rank_parts[j].append(part_of[si])
        self.n_epochs += 1

    def to_rank_state(self) -> RankState:
        """Materialize the cross-epoch merged state (O(total), finalize
        only): per rank, splice its epoch parts into one stream.  Ranks
        sharing the same part sequence share one stitched stream, so SPMD
        workloads still cost one concatenation, not N."""
        if self.n is None:
            raise ValueError("no epochs appended")
        streams: List[Tuple[bytes, tuple]] = []
        table: Dict[tuple, int] = {}
        stream_of: List[int] = []
        for j in range(self.n):
            combo = tuple(self.rank_parts[j])
            si = table.get(combo)
            if si is None:
                rows: List[Tuple[bytes, int]] = []
                gparts: List[Tuple[bytes, int]] = []
                for pi in combo:
                    cfg_e, rows_e = self.parts[pi]
                    gparts.append((cfg_e, len(rows)))
                    rows.extend(rows_e)
                si = len(streams)
                table[combo] = si
                streams.append((concat_grammars(gparts), tuple(rows)))
            stream_of.append(si)
        return RankState(base=self.base, n=self.n, groups=dict(self.groups),
                         streams=streams, stream_of=stream_of)


# ---------------------------------------------------------------------------
# segment commit + manifest maintenance (rank 0)
# ---------------------------------------------------------------------------


def _load_or_init_manifest(trace_dir: str, nranks: int) -> Dict[str, Any]:
    if trace_format.is_stream_dir(trace_dir):
        return trace_format.read_manifest(trace_dir)
    return {"format_version": trace_format.FORMAT_VERSION,
            "nranks": nranks, "segments": []}


def write_epoch_segment(trace_dir: str, epoch: int, *,
                        registry: FunctionRegistry, merge: MergeResult,
                        cfgs: CfgResult,
                        rank_ts_blocks: List[Sequence[TsBlock]],
                        state_blob: bytes, n_records: int,
                        meta_extra: Optional[Dict[str, Any]] = None,
                        ranks_present: Optional[List[int]] = None
                        ) -> Dict[str, Any]:
    """Commit one epoch segment: write the five-file mini trace plus
    ``state.bin`` under a ``.tmp`` name, atomically rename it in, then
    atomically rewrite the manifest with the segment's file sizes and
    CRC32 checksums (the crash-recovery and bit-rot ground truth).
    Returns the manifest entry.

    A failed write (ENOSPC and friends) removes the ``.tmp`` staging
    directory and raises :class:`trace_format.SegmentWriteError` -- the
    trace directory is left exactly as it was.  (A hard crash mid-write
    still leaves ``.tmp`` debris; the next attempt sweeps it.)

    A restarted job may reuse the trace directory of a preempted run: the
    committed epoch number always continues past the manifest's newest
    segment (whatever the caller's local counter says), so run B's epochs
    append after run A's instead of colliding with them, and any stale
    ``merged`` trace (it no longer covers every epoch) is dropped from the
    manifest before the new segment becomes visible.

    ``ranks_present`` marks a *degraded* commit: the sorted ranks whose
    contributions made it into the epoch.  It is recorded in the manifest
    entry (and segment metadata) only when partial, so readers can report
    exactly which ranks' windows are missing.
    """
    os.makedirs(trace_dir, exist_ok=True)
    manifest = _load_or_init_manifest(trace_dir, len(cfgs.cfg_index))
    segments = manifest.get("segments", [])
    if segments:
        epoch = max(epoch, max(e["epoch"] for e in segments) + 1)
    name = trace_format.segment_name(epoch)
    tmp = os.path.join(trace_dir, name + ".tmp")
    if os.path.exists(tmp):  # debris from a crashed earlier attempt
        shutil.rmtree(tmp)
    partial = (ranks_present is not None
               and len(ranks_present) < len(cfgs.cfg_index))
    if partial:
        meta_extra = {**(meta_extra or {}),
                      "ranks_present": list(ranks_present)}
    try:
        sizes, crcs = trace_format.write_trace(
            tmp, registry=registry, merged_cst=merge.merged_entries,
            unique_cfgs=cfgs.unique_cfgs, cfg_index=cfgs.cfg_index,
            rank_ts_blocks=rank_ts_blocks, meta_extra=meta_extra,
            checksums=True)
        crcs[trace_format.STATE_FILE] = trace_format.write_file(
            os.path.join(tmp, trace_format.STATE_FILE), state_blob)
        sizes[trace_format.STATE_FILE] = len(state_blob)
    except Exception as e:
        # a clean failure (not a crash): leave no debris behind and report
        # a typed error -- SimulatedCrash is a BaseException and skips this,
        # leaving .tmp exactly as a real kill would
        shutil.rmtree(tmp, ignore_errors=True)
        raise trace_format.SegmentWriteError(
            f"failed to write epoch segment {name!r} in {trace_dir!r}: "
            f"{e}") from e
    plan = faults.get_active()
    if plan is not None:
        plan.on_commit_point("pre-rename", epoch)
    final = os.path.join(trace_dir, name)
    if os.path.exists(final):
        # an orphan not listed in the manifest (e.g. pruned entry whose
        # directory removal failed); no reader can reference it
        shutil.rmtree(final)
    os.replace(tmp, final)
    entry = {"name": name, "epoch": epoch, "n_records": n_records,
             "cst_entries": len(merge.merged_entries), "files": sizes,
             "crcs": crcs}
    if partial:
        entry["ranks_present"] = list(ranks_present)
    manifest["segments"] = segments + [entry]
    if plan is not None:
        plan.on_commit_point("pre-manifest", epoch)
    stale_merged = manifest.pop("merged", None)  # no longer covers all epochs
    trace_format.write_manifest(trace_dir, manifest)
    if stale_merged is not None:
        # unlisted above (manifest first, so no reader holds an entry for
        # it); now reclaim the stale directory instead of leaking it
        shutil.rmtree(os.path.join(trace_dir, stale_merged["name"]),
                      ignore_errors=True)
    if plan is not None:
        plan.on_commit_point("post-commit", epoch)
    return entry


def prune_epochs(trace_dir: str, keep: int) -> List[str]:
    """Retention ring for live monitoring: keep only the newest ``keep``
    committed segments.  The manifest is rewritten BEFORE directories are
    deleted, so a reader never sees a listed-but-missing segment; returns
    the dropped segment names."""
    if keep <= 0:
        raise ValueError("keep must be positive")
    manifest = trace_format.read_manifest(trace_dir)
    segs = manifest.get("segments", [])
    if len(segs) <= keep:
        return []
    drop, manifest["segments"] = segs[:-keep], segs[-keep:]
    trace_format.write_manifest(trace_dir, manifest)
    for e in drop:
        shutil.rmtree(os.path.join(trace_dir, e["name"]), ignore_errors=True)
    return [e["name"] for e in drop]


# ---------------------------------------------------------------------------
# crash-resume: rebuild rank 0's cumulative state from committed segments
# ---------------------------------------------------------------------------


def resume_cumulative_state(trace_dir: str) -> CumulativeState:
    """Rebuild the cross-epoch :class:`CumulativeState` of a preempted run
    by folding the committed segments' ``state.bin`` deltas in epoch order
    -- the crash-resume path: a restarted job that reuses its trace
    directory keeps appending epochs AND still gets a clean-finalize
    ``merged/`` covering the FULL history, instead of permanently losing
    the incremental-finalize payoff.

    O(sum of delta sizes), state blobs only -- no CST/CFG/timestamp decode.
    Raises :class:`trace_format.TraceFormatError` when any committed
    segment is unusable (failed checksum, truncation, missing state): a
    merged trace must cover every epoch exactly, so the caller falls back
    to a fresh state (stitched reads still serve the intact segments).
    """
    cum = CumulativeState()
    manifest = trace_format.read_manifest(trace_dir)
    for entry in manifest.get("segments", []):
        reason = trace_format.validate_segment(trace_dir, entry)
        if reason is not None:
            raise trace_format.TraceFormatError(
                f"cannot resume cumulative state from {trace_dir!r}: "
                f"{reason}")
        path = os.path.join(trace_dir, entry["name"],
                            trace_format.STATE_FILE)
        try:
            with open(path, "rb") as f:
                blob = f.read()
            delta = deserialize_rank_state(blob)
        except (OSError, ValueError, IndexError) as e:
            raise trace_format.TraceFormatError(
                f"cannot resume cumulative state from {trace_dir!r}: "
                f"{entry['name']}/state.bin is unreadable: {e}") from e
        cum.append(delta)
    return cum


# ---------------------------------------------------------------------------
# the collective flush (called by Recorder.flush on every rank)
# ---------------------------------------------------------------------------


def run_flush(comm, *, entries: List[bytes], cfg: bytes, ticks: np.ndarray,
              registry: FunctionRegistry, trace_dir: str, epoch: int,
              cum: CumulativeState, inter_patterns: bool = True,
              ts_block_records: int = 4096,
              max_epochs_retained: Optional[int] = None,
              meta_extra: Optional[Dict[str, Any]] = None,
              encode_backend: Optional[str] = None
              ) -> Optional[Dict[str, Any]]:
    """One epoch flush over ``comm``.  Every rank contributes its delta
    (local CST entries, serialized CFG, raw ticks); rank 0 folds the
    reduced delta into ``cum``, commits the segment and returns its
    manifest entry (other ranks return None).  Collective: all ranks must
    call it in the same order."""
    leaf = make_rank_state(comm.rank, entries, cfg, registry)
    blob = comm.reduce_tree(serialize_rank_state(leaf),
                            merge_serialized_states)
    blocks = compress_timestamps_blocked(ticks, ts_block_records,
                                         backend=encode_backend) \
        if len(ticks) else []
    packed = comm.gather_tree(pack_ts_blocks(blocks))
    if comm.rank != 0:
        comm.barrier()
        return None
    delta = deserialize_rank_state(blob)
    # records per unique stream from grammar expansion weights (O(|grammar|)
    # each), summed over ranks by stream multiplicity
    per_stream = [sum(terminal_counts(parse_grammar(cfg_e)).values())
                  for cfg_e, _rows in delta.streams]
    n_records = sum(per_stream[si] for si in delta.stream_of)
    merge, cfgs = materialize_state(delta, inter_patterns=inter_patterns)
    entry = write_epoch_segment(
        trace_dir, epoch, registry=registry, merge=merge, cfgs=cfgs,
        rank_ts_blocks=[unpack_ts_blocks(p) for p in packed],
        state_blob=blob, n_records=n_records, meta_extra=meta_extra)
    # fold into the cumulative state only after the segment committed, so a
    # failed write never desyncs the in-memory state from the directory
    # (the epoch's records are lost either way -- they were snapshotted out
    # of the live recorder -- but every later flush and the final merged
    # trace stay consistent with what is actually on disk).  Under ring
    # retention the cumulative state is never consumed (a merged trace
    # cannot cover pruned epochs), so skip the fold entirely: rank-0 memory
    # stays bounded by the ring, matching the live-monitoring use case.
    if max_epochs_retained is None:
        cum.append(delta)
    else:
        prune_epochs(trace_dir, max_epochs_retained)
    comm.barrier()
    return entry


# ---------------------------------------------------------------------------
# degraded (fault-tolerant) flush: survivors commit around dead ranks
# ---------------------------------------------------------------------------


@dataclass
class FlushOutcome:
    """What one degraded flush attempt did, from this rank's view.

    ``lost_local`` is the signal the Recorder acts on: this rank's delta
    did NOT make it into a committed segment (the commit failed, or the
    commit succeeded without this rank's contribution), so the snapshot
    must be restored into the live recorder for the next attempt --
    exactly-once across retries, no loss and no duplication.
    """

    ok: bool
    entry: Optional[Dict[str, Any]] = None     # rank 0 only
    ranks_present: List[int] = field(default_factory=list)
    error: Optional[str] = None
    exc: Optional[BaseException] = None        # rank 0 local commit failure
    lost_local: bool = False


def _empty_block_blob(base: int, n: int) -> bytes:
    """Serialized stand-in for an absent rank block [base, base+n): empty
    grammar, no groups, one shared empty stream.  Structurally a normal
    contiguous block, so the tree fold stays full-width and
    ``merge_rank_states``'s adjacency invariant holds; semantically 'these
    ranks contributed nothing', which the ``ranks_present`` mask reports."""
    return serialize_rank_state(RankState(
        base=base, n=n, groups={},
        streams=[(Sequitur().serialize(), ())], stream_of=[0] * n))


def run_flush_degraded(comm, *, entries: List[bytes], cfg: bytes,
                       ticks: np.ndarray, registry: FunctionRegistry,
                       trace_dir: str, epoch: int, cum: CumulativeState,
                       inter_patterns: bool = True,
                       ts_block_records: int = 4096,
                       max_epochs_retained: Optional[int] = None,
                       meta_extra: Optional[Dict[str, Any]] = None,
                       timeout_s: float = 30.0,
                       encode_backend: Optional[str] = None) -> FlushOutcome:
    """One epoch flush that survives unresponsive ranks.

    Same reduction tree and association order as :func:`run_flush` (a
    fault-free degraded flush commits a byte-identical segment), but built
    ONLY from tagged point-to-point messages with per-hop timeouts -- no
    barriers, so a dead rank can never wedge the survivors:

      1. tree-reduce ``(present_ranks, state blob, ts payloads)`` with
         :meth:`Comm.reduce_tree_partial`; a subtree that misses its
         timeout is substituted by an explicitly-empty block,
      2. rank 0 commits the segment, with a ``ranks_present`` mask when
         partial, and folds the delta into ``cum`` (degraded epochs ARE
         part of the history the merged trace covers),
      3. rank 0 fans the verdict out (:meth:`Comm.bcast_p2p`); a rank that
         is absent from the mask -- it was alive but too slow -- or that
         never hears a verdict reports ``lost_local`` so its caller
         restores the snapshot for the next flush.

    Collective-call discipline: all alive ranks must call this (and every
    other timed collective on ``comm``) in the same order; the message
    tags assume lockstep invocation counts.
    """
    leaf_state = make_rank_state(comm.rank, entries, cfg, registry)
    blocks = compress_timestamps_blocked(ticks, ts_block_records,
                                         backend=encode_backend) \
        if len(ticks) else []
    leaf = ((comm.rank,), serialize_rank_state(leaf_state),
            ((comm.rank, pack_ts_blocks(blocks)),))

    def fold(a, b):
        return (a[0] + b[0], merge_serialized_states(a[1], b[1]),
                a[2] + b[2])

    def absent(lo, hi):
        return ((), _empty_block_blob(lo, hi - lo), ())

    folded = comm.reduce_tree_partial(leaf, fold, absent, timeout_s)
    if comm.rank != 0:
        patience = comm.verdict_patience(timeout_s)
        try:
            ack = comm.bcast_p2p(None, patience)
        except CommTimeout:
            return FlushOutcome(
                ok=False, lost_local=True,
                error=f"no commit verdict from rank 0 within {patience:g}s")
        if ack[0] != "ok":
            return FlushOutcome(ok=False, lost_local=True, error=ack[1])
        present = list(ack[1])
        return FlushOutcome(ok=True, ranks_present=present,
                            lost_local=comm.rank not in present)
    present, blob, ts_items = folded
    present = sorted(present)
    try:
        delta = deserialize_rank_state(blob)
        per_stream = [sum(terminal_counts(parse_grammar(cfg_e)).values())
                      for cfg_e, _rows in delta.streams]
        n_records = sum(per_stream[si] for si in delta.stream_of)
        merge, cfgs = materialize_state(delta, inter_patterns=inter_patterns)
        rank_blocks: List[List[TsBlock]] = [[] for _ in range(delta.n)]
        for r, packed in ts_items:
            rank_blocks[r - delta.base] = unpack_ts_blocks(packed)
        entry = write_epoch_segment(
            trace_dir, epoch, registry=registry, merge=merge, cfgs=cfgs,
            rank_ts_blocks=rank_blocks, state_blob=blob,
            n_records=n_records, meta_extra=meta_extra,
            ranks_present=present)
        if max_epochs_retained is None:
            cum.append(delta)
        else:
            prune_epochs(trace_dir, max_epochs_retained)
    except Exception as e:
        # commit failed locally: tell the survivors (one fan-out either
        # way, preserving the lockstep tag count), then report the failure
        # with the original exception for the caller to re-raise
        try:
            comm.bcast_p2p(("err", f"{type(e).__name__}: {e}"), timeout_s)
        except Exception:  # pragma: no cover - fan-out itself failing
            pass
        return FlushOutcome(ok=False, error=str(e), exc=e, lost_local=True)
    comm.bcast_p2p(("ok", present), timeout_s)
    return FlushOutcome(ok=True, entry=entry, ranks_present=present)


# ---------------------------------------------------------------------------
# merged trace at clean exit (the incremental-finalize payoff)
# ---------------------------------------------------------------------------


def write_merged_trace(trace_dir: str, cum: CumulativeState, *,
                       registry: FunctionRegistry, inter_patterns: bool = True,
                       meta_extra: Optional[Dict[str, Any]] = None
                       ) -> Optional[Dict[str, Any]]:
    """Materialize the cumulative state into ``<trace_dir>/merged`` -- a
    plain five-file trace covering every epoch, produced WITHOUT
    re-reducing the history (the merge already happened incrementally,
    O(delta) per flush).  Timestamps are reassembled from the committed
    segments' already-compressed blocks (byte concatenation, no
    recompression).  Returns the manifest entry, or None when the segment
    history is incomplete (retention pruned or corrupted epochs): a merged
    trace must cover exactly the epochs the state covers."""
    def skip(reason: str) -> None:
        warnings.warn(
            f"no merged trace written for {trace_dir!r}: {reason} -- the "
            f"committed epoch segments remain readable via "
            f"TraceReader(mode='stitched')", RuntimeWarning)

    manifest = trace_format.read_manifest(trace_dir)
    entries = manifest.get("segments", [])
    if len(entries) != cum.n_epochs:
        skip(f"the directory holds {len(entries)} segments but this run's "
             f"cumulative state covers {cum.n_epochs} epochs (restarted "
             f"run, pruning, or a failed flush)")
        return None
    nranks = cum.n
    rank_blocks: List[List[TsBlock]] = [[] for _ in range(nranks)]
    # per rank, per source segment: [n_blocks, that segment's wrap base] --
    # readers unwrap each epoch's blocks against its OWN base, so
    # inter-epoch gaps of >= 2 whole wrap periods (undetectable from tick
    # values) stay exact in merged mode, matching stitched mode
    wrap_spans: List[List[List[int]]] = [[] for _ in range(nranks)]
    base_wraps: Optional[int] = None
    degraded_epochs: Dict[str, List[int]] = {}
    for entry in entries:
        # only each segment's timestamp payload is needed here -- the
        # CST/CFG already live merged inside `cum` -- so skip the full
        # blob decode a read_stream_trace would pay
        reason = trace_format.validate_segment(trace_dir, entry)
        if reason is not None:
            skip(reason)
            return None
        raw, index, seg_meta = trace_format.read_trace_timestamps(
            os.path.join(trace_dir, entry["name"]))
        if index is None:  # legacy single-blob segment: not block-indexed
            skip(f"{entry['name']} has no block-indexed timestamps")
            return None
        seg_wraps = int(seg_meta.get("tick_wraps", 0) or 0)
        if base_wraps is None:
            # the merged trace's store-wide base stays the FIRST epoch's
            # (back-compat for readers unaware of tick_wrap_spans)
            base_wraps = seg_wraps
        if "ranks_present" in entry:
            degraded_epochs[entry["name"]] = list(entry["ranks_present"])
        for r in range(min(nranks, len(index))):
            rank_blocks[r].extend(
                (raw[e[0] : e[0] + e[1]], e[2], e[3], e[4],
                 e[5] if len(e) > 5 else None)
                for e in index[r])
            wrap_spans[r].append([len(index[r]), seg_wraps])
    state = cum.to_rank_state()
    merge, cfgs = materialize_state(state, inter_patterns=inter_patterns)
    tmp = os.path.join(trace_dir, MERGED_DIR + ".tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    meta_extra = dict(meta_extra or {})
    if base_wraps:
        meta_extra["tick_wraps"] = base_wraps
    if any(len(spans) > 1 or (spans and spans[0][1])
           for spans in wrap_spans):
        meta_extra["tick_wrap_spans"] = wrap_spans
    if degraded_epochs:
        meta_extra["degraded_epochs"] = degraded_epochs
    sizes, crcs = trace_format.write_trace(
        tmp, registry=registry, merged_cst=merge.merged_entries,
        unique_cfgs=cfgs.unique_cfgs, cfg_index=cfgs.cfg_index,
        rank_ts_blocks=rank_blocks, meta_extra=meta_extra or None,
        checksums=True)
    state_blob = serialize_rank_state(state)
    crcs[trace_format.STATE_FILE] = trace_format.write_file(
        os.path.join(tmp, trace_format.STATE_FILE), state_blob)
    sizes[trace_format.STATE_FILE] = len(state_blob)
    final = os.path.join(trace_dir, MERGED_DIR)
    manifest = trace_format.read_manifest(trace_dir)
    if os.path.exists(final):
        # a stale merged trace from a previous run using this directory:
        # unlist it first (atomic manifest write), so no reader ever holds
        # an entry for a directory mid-replacement
        if manifest.pop("merged", None) is not None:
            trace_format.write_manifest(trace_dir, manifest)
        shutil.rmtree(final)
    os.replace(tmp, final)
    entry = {"name": MERGED_DIR, "n_epochs": cum.n_epochs, "files": sizes,
             "crcs": crcs}
    manifest["merged"] = entry
    trace_format.write_manifest(trace_dir, manifest)
    return entry


# ---------------------------------------------------------------------------
# read side: stitch committed segments into one logical trace
# ---------------------------------------------------------------------------


class StitchedTimestampStore:
    """Per-rank timestamp access across epoch segments: delegates to each
    segment's store (block-indexed or legacy) in epoch order and
    concatenates the rows.  ``blocks_touched`` sums the children, so the
    only-touched-blocks property of windowed queries is observable across
    the whole stitched trace."""

    def __init__(self, stores: Sequence[Any]):
        self._stores = list(stores)

    @property
    def blocks_touched(self) -> int:
        return sum(s.blocks_touched for s in self._stores)

    def n_blocks(self, rank: int) -> int:
        return sum(s.n_blocks(rank) for s in self._stores)

    def _concat(self, parts: List[Optional[np.ndarray]]
                ) -> Optional[np.ndarray]:
        parts = [p for p in parts if p is not None]
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def load(self, rank: int) -> Optional[np.ndarray]:
        return self._concat([s.load(rank) for s in self._stores])

    def load_unwrapped(self, rank: int) -> Optional[np.ndarray]:
        """Concatenated int64 unwrapped ticks across segments -- each
        segment unwraps against its own per-epoch wrap base, so epochs
        separated by multiple wrap periods still come out monotonic."""
        return self._concat([s.load_unwrapped(rank) for s in self._stores])

    def window(self, rank: int, t0: int, t1: int) -> Optional[np.ndarray]:
        return self._concat([s.window(rank, t0, t1) for s in self._stores])

    def window_stats(self, rank: int, t0: int, t1: int
                     ) -> Optional[Tuple[int, Optional[int]]]:
        """Summed ``(n_calls, n_bytes)`` over the segments; ``n_bytes`` is
        None unless every contributing segment carries byte counters."""
        parts = [s.window_stats(rank, t0, t1) for s in self._stores]
        parts = [p for p in parts if p is not None]
        if not parts:
            return None
        n_calls = sum(p[0] for p in parts)
        exact = all(p[1] is not None for p in parts if p[0])
        n_bytes = sum(p[1] or 0 for p in parts) if exact else None
        return n_calls, n_bytes


def make_ts_store(data: Dict[str, Any]):
    """The timestamp store for one ``read_trace_files`` payload: block-
    indexed when the segment carries ``ts_index``, legacy single-blob
    otherwise (same interface either way).  The segment's per-epoch
    ``tick_wraps`` counter (how many times the uint32 microsecond clock had
    already wrapped when the epoch began) seeds the unwrap base."""
    wraps = int(data["meta"].get("tick_wraps", 0) or 0)
    if data.get("ts_index") is not None:
        return BlockedTimestampStore(
            data["ts_raw"], data["ts_index"], tick_wraps=wraps,
            wrap_spans=data["meta"].get("tick_wrap_spans"))
    return TimestampStore(data["rank_timestamps"], tick_wraps=wraps)


def stitch_segments(datas: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Concatenate committed segments (``read_trace_files`` payloads, epoch
    order) into one logical trace, value-identical to a one-shot finalize
    of the same calls.

    The stitched merged CST is the concatenation of the segments' CSTs
    (epoch ``e``'s terminals shifted past the earlier rows); each rank's
    stitched CFG splices its per-epoch grammars with
    :func:`sequitur.concat_grammars` -- ranks sharing the same per-epoch
    CFG sequence share one stitched CFG, so SPMD dedup survives stitching.
    The function table is taken from the NEWEST segment (the registry only
    grows during a run, so it is the superset).
    """
    if not datas:
        raise trace_format.TraceFormatError("no segments to stitch")
    nranks_set = {d["meta"]["nranks"] for d in datas}
    if len(nranks_set) != 1:
        raise trace_format.TraceFormatError(
            f"segments disagree on nranks: {sorted(nranks_set)}")
    nranks = nranks_set.pop()
    merged_cst: List[bytes] = []
    toffs: List[int] = []
    for d in datas:
        toffs.append(len(merged_cst))
        merged_cst.extend(d["merged_cst"])
    combo_table: Dict[tuple, int] = {}
    unique_cfgs: List[bytes] = []
    cfg_index: List[int] = []
    for r in range(nranks):
        combo = tuple(d["cfg_index"][r] for d in datas)
        i = combo_table.get(combo)
        if i is None:
            i = len(unique_cfgs)
            combo_table[combo] = i
            unique_cfgs.append(concat_grammars(
                [(datas[s]["unique_cfgs"][u], toffs[s])
                 for s, u in enumerate(combo)]))
        cfg_index.append(i)
    meta = dict(datas[-1]["meta"])
    meta["nranks"] = nranks
    return {
        "meta": meta,
        "merged_cst": merged_cst,
        "unique_cfgs": unique_cfgs,
        "cfg_index": cfg_index,
        "ts_store": StitchedTimestampStore([make_ts_store(d) for d in datas]),
        "n_segments": len(datas),
    }
