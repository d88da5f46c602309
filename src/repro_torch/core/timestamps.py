"""Timestamp storage (paper §2.2.1).

Recorder stores entry and exit times of every call as 4-byte deltas relative
to the application's start, buffered in memory and compressed with zlib at
finalization.  We store uint32 *microsecond* ticks since recorder init
(wraps at ~71.6 minutes -- fine for the traced phases; the wrap policy is
recorded in metadata).  The compression pipeline is

    ticks -> first-order delta -> zigzag -> little-endian u32 -> zlib

The delta+zigzag stage is the arithmetic hot loop; ``repro_torch.kernels.
delta_encode`` provides the CUDA version of it, validated against the
numpy path used here.

**Block-indexed storage** (streaming traces): instead of one zlib blob per
rank, :func:`compress_timestamps_blocked` splits the tick array into
fixed-record blocks, each independently delta+zigzag+zlib encoded and
carrying ``(n_records, t_min, t_max[, n_bytes])`` index metadata.
Time-windowed queries then decompress only the blocks whose
``[t_min, t_max]`` span intersects the window
(:class:`BlockedTimestampStore.window`); the single-blob layout stays
readable through :class:`TimestampStore`, which presents the same
interface with one "block" per rank.  Both stores count
``blocks_touched`` so callers (benchmarks, tests) can assert that windowed
queries really skip untouched blocks.

**Sized blocks** (exact windowed bandwidth): the recorder appends a third
per-record column -- the call's data-transfer byte count (0 for metadata
calls) -- and each block's index entry carries the column's sum.  A
windowed byte query (:meth:`BlockedTimestampStore.window_stats`) then
reads fully-covered blocks straight off the index and decompresses only
the boundary blocks it would have decompressed anyway, making windowed
bandwidth EXACT at the same decompression cost (the old trace-wide
min/max bounds survive only for legacy 2-column traces).

**Tick wrap**: ticks are uint32 microseconds and wrap every ~71.6 minutes.
Per epoch the recorder stores the wrap count of the epoch's first record
(``tick_wraps`` in segment metadata); :func:`unwrap_ticks` rebases a
store's ticks to int64 with that counter and repairs intra-store wraps
from the monotone entry column (a drop of more than 2^31 between
consecutive entries is a wrap, never a reordering -- call durations are
far below 35 minutes), so days-long streamed runs read back monotonic
64-bit timestamps (:meth:`TimestampStore.load_unwrapped`).
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .encoding import read_uvarint, write_uvarint

# records per zlib block in blocked storage (a block holds whole records --
# an (entry, exit) pair never straddles blocks, so per-block [t_min, t_max]
# bounds are exact for call-interval intersection tests)
DEFAULT_BLOCK_RECORDS = 4096


class TimestampBuffer:
    """Append-only (entry, exit, data bytes) tick buffer for one rank.

    The third column is the call's data-transfer size (0 for metadata
    calls), kept out of the legacy single-blob layout (:meth:`as_array`
    stays two-column) but flushed into sized timestamp blocks so windowed
    bandwidth queries are exact without expansion."""

    def __init__(self) -> None:
        self._chunks: List[np.ndarray] = []
        self._cur = np.empty((4096, 3), dtype=np.uint32)
        self._n = 0

    def append(self, t_entry: int, t_exit: int, nbytes: int = 0) -> None:
        if self._n == len(self._cur):
            self._chunks.append(self._cur)
            self._cur = np.empty((4096, 3), dtype=np.uint32)
            self._n = 0
        self._cur[self._n, 0] = t_entry & 0xFFFFFFFF
        self._cur[self._n, 1] = t_exit & 0xFFFFFFFF
        self._cur[self._n, 2] = nbytes & 0xFFFFFFFF
        self._n += 1

    def __len__(self) -> int:
        return sum(len(c) for c in self._chunks) + self._n

    def _full(self) -> np.ndarray:
        parts = self._chunks + [self._cur[: self._n]]
        return np.concatenate(parts, axis=0) if parts \
            else np.empty((0, 3), np.uint32)

    def as_array(self) -> np.ndarray:
        """(n, 2) entry/exit ticks -- the legacy one-shot layout."""
        return self._full()[:, :2]

    def take(self) -> np.ndarray:
        """Snapshot the buffered (n, 3) rows and reset the buffer (epoch
        flush)."""
        arr = self._full()
        self._chunks = []
        self._cur = np.empty((4096, 3), dtype=np.uint32)
        self._n = 0
        return arr


def delta_zigzag_encode(ticks: np.ndarray, backend: Optional[str] = None,
                        segment: int = 0) -> np.ndarray:
    """Flattened interleaved (entry, exit) stream -> delta -> zigzag u32.

    Deltas are wrapped into signed 32-bit range (mod 2^32) BEFORE zigzag:
    ticks are u32, so a raw delta can need 33 bits; the wrap keeps the
    encoding exactly 4 bytes and the mod-2^32 cumsum decode is lossless.
    (This also matches the CUDA kernel's u32 arithmetic bit-for-bit.)
    With ``segment`` the stream restarts from 0 at every multiple of
    ``segment`` elements: the blocks of :func:`compress_timestamps_blocked`
    in one call.

    ``backend`` selects the python/numpy/torch/cuda implementation (see
    ``encode_backend``); output is bit-identical across all of them.  A
    u32 tick buffer goes to the backends as it is.
    """
    # timestamps are monotone per column but interleaved entry/exit deltas
    # may be negative -> zigzag
    from . import encode_backend as _eb
    return _eb.delta_zigzag(ticks.reshape(-1), backend, segment)


def delta_zigzag_decode(zz: np.ndarray, ncols: int = 2) -> np.ndarray:
    u = zz.astype(np.int64)
    deltas = (u >> 1) ^ -(u & 1)
    flat = np.cumsum(deltas)          # mod-2^32 recovery via the u32 cast
    return flat.astype(np.uint32).reshape(-1, ncols)


def compress_timestamps(ticks: np.ndarray,
                        backend: Optional[str] = None) -> bytes:
    zz = delta_zigzag_encode(ticks, backend)
    return zlib.compress(zz.astype("<u4").tobytes(), level=6)


def decompress_timestamps(buf: bytes, ncols: int = 2) -> np.ndarray:
    raw = zlib.decompress(buf)
    zz = np.frombuffer(raw, dtype="<u4").astype(np.uint32)
    return delta_zigzag_decode(zz, ncols)


# ---------------------------------------------------------------------------
# block-indexed storage (streaming traces / time-windowed queries)
# ---------------------------------------------------------------------------

# one block: (zlib blob, n_records, t_min, t_max, n_bytes); t_min is the
# earliest entry tick, t_max the latest effective exit tick (a zero exit
# tick falls back to the entry tick, mirroring the seed `or` in the
# analyses); n_bytes is the block's summed data-transfer size, or None for
# blocks encoded from a 2-column (legacy) tick array
TsBlock = Tuple[bytes, int, int, int, Optional[int]]


def effective_exit(ticks: np.ndarray) -> np.ndarray:
    ent = ticks[:, 0].astype(np.int64)
    ext = ticks[:, 1].astype(np.int64)
    return np.where(ext != 0, ext, ent)


def compress_timestamps_blocked(ticks: np.ndarray,
                                block_records: int = DEFAULT_BLOCK_RECORDS,
                                backend: Optional[str] = None
                                ) -> List[TsBlock]:
    """Split ``ticks`` -- (n, 2) entry/exit or (n, 3) with a data-bytes
    column -- into independently-decodable zlib blocks.

    Each block is delta+zigzag encoded from scratch (its first value is
    absolute), so any block decompresses without touching its neighbours.
    Sized (3-column) inputs produce blocks carrying the summed byte
    counter; the column count is recovered at decode time from the block's
    record count.
    """
    if block_records <= 0:
        raise ValueError("block_records must be positive")
    sized = ticks.ndim == 2 and ticks.shape[1] >= 3
    ncols = ticks.shape[1] if ticks.ndim == 2 else 1
    # every block's deltas in one call: each restarts at its first record
    zz = delta_zigzag_encode(ticks, backend, segment=block_records * ncols)
    blocks: List[TsBlock] = []
    for s in range(0, len(ticks), block_records):
        blk = ticks[s : s + block_records]
        t_min = int(blk[:, 0].astype(np.int64).min())
        t_max = int(effective_exit(blk).max())
        n_bytes = int(blk[:, 2].astype(np.int64).sum()) if sized else None
        raw = zz[s * ncols : (s + len(blk)) * ncols].astype("<u4").tobytes()
        blocks.append((zlib.compress(raw, level=6), len(blk), t_min, t_max,
                       n_bytes))
    return blocks


def pack_ts_blocks(blocks: Sequence[TsBlock]) -> bytes:
    """Stable byte envelope of one rank's block list (tree-hop transport)."""
    out = bytearray()
    write_uvarint(out, len(blocks))
    for blob, n, t_min, t_max, n_bytes in blocks:
        write_uvarint(out, len(blob))
        out.extend(blob)
        write_uvarint(out, n)
        write_uvarint(out, t_min)
        write_uvarint(out, t_max)
        write_uvarint(out, 0 if n_bytes is None else 1)
        if n_bytes is not None:
            write_uvarint(out, n_bytes)
    return bytes(out)


def unpack_ts_blocks(buf: bytes) -> List[TsBlock]:
    pos = 0
    n_blocks, pos = read_uvarint(buf, pos)
    blocks: List[TsBlock] = []
    for _ in range(n_blocks):
        ln, pos = read_uvarint(buf, pos)
        blob = bytes(buf[pos : pos + ln])
        pos += ln
        n, pos = read_uvarint(buf, pos)
        t_min, pos = read_uvarint(buf, pos)
        t_max, pos = read_uvarint(buf, pos)
        has_bytes, pos = read_uvarint(buf, pos)
        n_bytes: Optional[int] = None
        if has_bytes:
            n_bytes, pos = read_uvarint(buf, pos)
        blocks.append((blob, n, t_min, t_max, n_bytes))
    return blocks


def unwrap_ticks(ticks: np.ndarray, base_wraps: int = 0) -> np.ndarray:
    """(n, 2) uint32 ticks -> monotonic int64 microseconds.

    ``base_wraps`` rebases the first entry (the per-epoch ``tick_wraps``
    counter from segment metadata); wraps WITHIN the array are recovered
    from the monotone entry column -- a drop of more than 2^31 between
    consecutive entries can only be a wrap, since real reordering (nested
    calls appended child-first) is bounded by call durations, far below 35
    minutes.  A non-zero exit below its entry wrapped mid-call and is
    bumped one extra period; the zero-exit sentinel is preserved.
    """
    out = np.empty((len(ticks), 2), np.int64)
    if not len(ticks):
        return out
    ent = ticks[:, 0].astype(np.int64)
    ext = ticks[:, 1].astype(np.int64)
    wraps = np.zeros(len(ent), np.int64)
    if len(ent) > 1:
        wraps[1:] = np.cumsum(np.diff(ent) < -(1 << 31))
    off = (base_wraps + wraps) << 32
    out[:, 0] = ent + off
    out[:, 1] = np.where(
        ext == 0, 0,
        ext + off + (((ext != 0) & (ext < ent)).astype(np.int64) << 32))
    return out


def window_rows(ticks: np.ndarray, t0: int, t1: int) -> np.ndarray:
    """Rows whose call interval [entry, effective exit] intersects the
    half-open window [t0, t1) -- the shared filter of every windowed query."""
    ent = ticks[:, 0].astype(np.int64)
    return ticks[(ent < t1) & (effective_exit(ticks) >= t0)]


class TimestampStore:
    """Per-rank timestamp access over the single-blob (legacy) layout.

    One zlib blob per rank == one block per rank: ``window`` still has to
    decompress the whole rank, but the interface (and the
    ``blocks_touched`` counter) is shared with the blocked store so readers
    and views are layout-agnostic.
    """

    def __init__(self, rank_blobs: Sequence[bytes], tick_wraps: int = 0):
        self._blobs = rank_blobs
        self.blocks_touched = 0
        self.tick_wraps = tick_wraps

    def n_blocks(self, rank: int) -> int:
        return 1 if (rank < len(self._blobs) and self._blobs[rank]) else 0

    def load(self, rank: int) -> Optional[np.ndarray]:
        """Full (n, 2) tick array of one rank, or None when absent."""
        blob = self._blobs[rank] if rank < len(self._blobs) else None
        if not blob:
            return None
        self.blocks_touched += 1
        return decompress_timestamps(blob)

    def load_unwrapped(self, rank: int) -> Optional[np.ndarray]:
        """Monotonic int64 (n, 2) microseconds of one rank: the store's
        ``tick_wraps`` base plus heuristic intra-store unwrapping."""
        ts = self.load(rank)
        return None if ts is None else unwrap_ticks(ts, self.tick_wraps)

    def window(self, rank: int, t0: int, t1: int) -> Optional[np.ndarray]:
        """Rows of calls overlapping [t0, t1); decompresses only the blocks
        whose [t_min, t_max] span intersects the window."""
        ts = self.load(rank)
        return None if ts is None else window_rows(ts, t0, t1)

    def window_stats(self, rank: int, t0: int, t1: int
                     ) -> Optional[Tuple[int, Optional[int]]]:
        """(n_calls, n_bytes) of the window; ``n_bytes`` is None when the
        layout carries no per-record sizes (legacy single blob), the whole
        result None when the rank is absent."""
        w = self.window(rank, t0, t1)
        return None if w is None else (len(w), None)


class BlockedTimestampStore(TimestampStore):
    """Block-indexed store: ``index[rank]`` lists ``[offset, length,
    n_records, t_min, t_max]`` (legacy) or ``[..., n_bytes]`` (sized)
    entries into the raw ``timestamps.bin`` bytes; windowed queries
    decompress only intersecting blocks."""

    def __init__(self, raw: bytes, index: Sequence[Sequence[Sequence[int]]],
                 tick_wraps: int = 0,
                 wrap_spans: Optional[Sequence[Sequence[Sequence[int]]]]
                 = None):
        self._raw = raw
        self._index = index
        self.blocks_touched = 0
        self.tick_wraps = tick_wraps
        # merged multi-epoch traces: per rank a list of [n_blocks, wraps]
        # spans -- each source segment's block count with ITS OWN wrap
        # base, so unwrapping stays exact even when consecutive epochs are
        # separated by >= 2 whole wrap periods (undetectable from the tick
        # values alone; see write_merged_trace)
        self._wrap_spans = wrap_spans

    def n_blocks(self, rank: int) -> int:
        return len(self._index[rank]) if rank < len(self._index) else 0

    def _decode_entry(self, e) -> np.ndarray:
        """One block's full column array; the column count (2 legacy, 3
        sized) is recovered from the encoded length / record count."""
        self.blocks_touched += 1
        raw = zlib.decompress(self._raw[e[0] : e[0] + e[1]])
        zz = np.frombuffer(raw, dtype="<u4").astype(np.uint32)
        n = int(e[2])
        ncols = len(zz) // n if n else 2
        return delta_zigzag_decode(zz, ncols)

    def _decompress(self, entries) -> Optional[np.ndarray]:
        if not entries:
            return None
        return np.concatenate([self._decode_entry(e)[:, :2]
                               for e in entries], axis=0)

    def load(self, rank: int) -> Optional[np.ndarray]:
        if rank >= len(self._index):
            return None
        return self._decompress(self._index[rank])

    def load_unwrapped(self, rank: int) -> Optional[np.ndarray]:
        """Monotonic int64 ticks; with per-segment ``wrap_spans`` each
        source epoch's blocks unwrap against that epoch's own recorded
        base (exact across arbitrary inter-epoch gaps), otherwise the
        store-wide base plus intra-array drop detection."""
        spans = self._wrap_spans[rank] \
            if self._wrap_spans is not None and rank < len(self._wrap_spans) \
            else None
        if not spans:
            return super().load_unwrapped(rank)
        entries = self._index[rank] if rank < len(self._index) else []
        parts: List[np.ndarray] = []
        i = 0
        for n_blocks, base in spans:
            sub = entries[i : i + n_blocks]
            i += n_blocks
            if sub:
                parts.append(unwrap_ticks(self._decompress(sub), int(base)))
        if i < len(entries):  # spans out of step with the index: fall back
            tail = self._decompress(entries[i:])
            parts.append(unwrap_ticks(tail, int(spans[-1][1])))
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)

    def window(self, rank: int, t0: int, t1: int) -> Optional[np.ndarray]:
        if rank >= len(self._index):
            return None
        entries = [e for e in self._index[rank] if e[3] < t1 and e[4] >= t0]
        if not entries:
            # rank has blocks but none intersect: an empty row set, not None
            return (np.empty((0, 2), np.uint32) if self._index[rank] else None)
        return window_rows(self._decompress(entries), t0, t1)

    def window_stats(self, rank: int, t0: int, t1: int
                     ) -> Optional[Tuple[int, Optional[int]]]:
        """Exact (n_calls, n_bytes) over [t0, t1) at the SAME decompression
        cost as :meth:`window`: blocks whose [t_min, t_max] span lies fully
        inside the window contribute their indexed record count and byte
        counter without decompression (every row of such a block passes the
        interval filter -- entries never exceed effective exits within an
        epoch); only boundary blocks are decoded and filtered row-wise.
        ``n_bytes`` falls back to None when any touched block predates the
        sized layout."""
        if rank >= len(self._index) or not self._index[rank]:
            return None
        n_calls = 0
        n_bytes = 0
        exact = True
        for e in self._index[rank]:
            if not (e[3] < t1 and e[4] >= t0):
                continue
            if t0 <= e[3] and e[4] < t1:  # fully covered: index-only
                n_calls += int(e[2])
                nb = e[5] if len(e) > 5 else None
                if nb is None:
                    exact = False
                else:
                    n_bytes += int(nb)
                continue
            full = self._decode_entry(e)
            keep = (full[:, 0].astype(np.int64) < t1) \
                & (effective_exit(full[:, :2]) >= t0)
            n_calls += int(keep.sum())
            if full.shape[1] >= 3:
                n_bytes += int(full[keep, 2].astype(np.int64).sum())
            else:
                exact = False
        return (n_calls, n_bytes if exact else None)
