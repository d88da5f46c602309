"""On-disk trace format (paper Fig 3(d)).

A trace directory holds the five files produced by the inter-process
compression stage:

  unique_cfgs.bin   one copy of each distinct per-rank grammar
  cfg_index.bin     for each rank, which unique CFG it uses
  merged_cst.bin    the merged call-signature table
  timestamps.bin    per-rank zlib blocks of delta+zigzag u32 ticks
  metadata.json     function table, options, app info, block offsets

`make_signature` is re-exported here so the record path and the readers share
one definition site for the signature layout.

**Streaming layout** (the multi-segment trace directory written by
``Recorder.flush``): a ``manifest.json`` at the top level lists committed
**epoch segments**, each a complete five-file mini trace of one flush
window (plus ``state.bin``, the epoch's serialized cross-rank
``RankState``) living in its own ``epoch_NNNNN/`` subdirectory.  Segments
are written under a ``.tmp`` name and committed by atomic rename followed
by an atomic manifest rewrite, so a crash can never leave a half-written
segment visible; the manifest records every segment file's byte size, so
post-commit corruption (truncation) is detected and the segment skipped on
read.  Segment timestamps use the block-indexed layout (``ts_index`` in
the segment metadata instead of the legacy per-rank ``ts_offsets``).
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .encoding import (encode_signature, pack_uvarints, read_uvarint,
                       unpack_uvarints, write_uvarint)
from .specs import FunctionRegistry
from .timestamps import TsBlock

FORMAT_VERSION = 3  # "Recorder 3" -- the paper's major revision

make_signature = encode_signature


class TraceFormatError(Exception):
    """A trace directory is unreadable: missing files, malformed metadata,
    or a format_version this reader does not understand."""


class SegmentWriteError(OSError):
    """An epoch segment could not be written (ENOSPC, a vanished trace
    directory, ...).  The ``.tmp`` staging directory has been cleaned up
    and nothing was committed -- the trace directory is exactly as it was
    before the attempt.  Subclasses OSError so callers treating flush
    failures as I/O errors keep working."""


_TRACE_FILES = ("metadata.json", "merged_cst.bin", "unique_cfgs.bin",
                "cfg_index.bin", "timestamps.bin")

MANIFEST_FILE = "manifest.json"
SEGMENT_PREFIX = "epoch_"
STATE_FILE = "state.bin"


def segment_name(epoch: int) -> str:
    return f"{SEGMENT_PREFIX}{epoch:05d}"


def _blob_list_bytes(blobs: List[bytes]) -> bytes:
    out = bytearray()
    write_uvarint(out, len(blobs))
    for b in blobs:
        write_uvarint(out, len(b))
        out.extend(b)
    return bytes(out)


def write_file(path: str, data: bytes) -> int:
    """Write one trace file (through the fault-injection hook) and return
    the CRC32 of the INTENDED bytes.  Under an injected torn write the
    disk receives different bytes than the checksum records -- exactly the
    lying-disk case :func:`validate_segment` must catch, so the checksum
    is deliberately computed from the intent, not from what hit the
    platter."""
    from . import faults

    plan = faults.get_active()
    to_disk = data if plan is None else plan.on_write(path, data)
    with open(path, "wb") as f:
        f.write(to_disk)
    return zlib.crc32(data) & 0xFFFFFFFF


def _read_blob_list(path: str) -> List[bytes]:
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    n, pos = read_uvarint(buf, pos)
    blobs = []
    for _ in range(n):
        ln, pos = read_uvarint(buf, pos)
        blobs.append(buf[pos : pos + ln])
        pos += ln
    return blobs


def write_trace(trace_dir: str, *, registry: FunctionRegistry,
                merged_cst: List[bytes], unique_cfgs: List[bytes],
                cfg_index: List[int],
                rank_timestamps: Optional[List[bytes]] = None,
                rank_ts_blocks: Optional[List[Sequence[TsBlock]]] = None,
                meta_extra: Optional[Dict[str, Any]] = None,
                checksums: bool = False) -> Any:
    """Write the trace directory; returns per-file sizes in bytes, or
    ``(sizes, crcs)`` when ``checksums`` is set (per-file CRC32s of the
    written bytes -- the streaming writer records them in the manifest so
    post-commit bit rot and torn writes are detected, not parsed).

    Timestamps are passed either as ``rank_timestamps`` (legacy: one zlib
    blob per rank, indexed by ``ts_offsets``) or ``rank_ts_blocks``
    (block-indexed: per rank a list of
    ``(blob, n_records, t_min, t_max, n_bytes)`` blocks from
    :func:`timestamps.compress_timestamps_blocked`, indexed by ``ts_index``
    entries ``[offset, length, n_records, t_min, t_max]`` plus an optional
    sixth field -- the block's summed data-byte counter -- when the writer
    recorded per-call sizes).
    """
    if (rank_timestamps is None) == (rank_ts_blocks is None):
        raise ValueError(
            "pass exactly one of rank_timestamps / rank_ts_blocks")
    os.makedirs(trace_dir, exist_ok=True)
    files: Dict[str, bytes] = {
        "merged_cst.bin": _blob_list_bytes(merged_cst),
        "unique_cfgs.bin": _blob_list_bytes(unique_cfgs),
        "cfg_index.bin": pack_uvarints(cfg_index),
    }
    ts_meta: Dict[str, Any] = {}
    ts_buf = bytearray()
    if rank_timestamps is not None:
        ts_offsets = []
        for blob in rank_timestamps:
            ts_offsets.append([len(ts_buf), len(blob)])
            ts_buf.extend(blob)
        ts_meta["ts_offsets"] = ts_offsets
    else:
        ts_index = []
        for blocks in rank_ts_blocks:
            entries = []
            for blob, n, t_min, t_max, n_bytes in blocks:
                e = [len(ts_buf), len(blob), n, t_min, t_max]
                if n_bytes is not None:
                    e.append(n_bytes)
                entries.append(e)
                ts_buf.extend(blob)
            ts_index.append(entries)
        ts_meta["ts_index"] = ts_index
    files["timestamps.bin"] = bytes(ts_buf)
    meta = {
        "format_version": FORMAT_VERSION,
        "functions": {str(i): {
            "name": s.name,
            "layer": s.layer,
            "arg_names": [a.name for a in s.args],
            "arg_roles": [a.role.value for a in s.args],
            "ret_role": s.ret_role.value,
        } for i, s in ((i, registry.spec(i)) for i in range(len(registry)))},
        "nranks": len(cfg_index),
        **ts_meta,
    }
    if meta_extra:
        meta.update(meta_extra)
    files["metadata.json"] = json.dumps(meta).encode("utf-8")
    sizes: Dict[str, int] = {}
    crcs: Dict[str, int] = {}
    for name, data in files.items():
        crcs[name] = write_file(os.path.join(trace_dir, name), data)
        sizes[name] = len(data)
    return (sizes, crcs) if checksums else sizes


def read_trace_files(trace_dir: str) -> Dict[str, Any]:
    missing = [n for n in _TRACE_FILES
               if not os.path.exists(os.path.join(trace_dir, n))]
    if missing:
        raise TraceFormatError(
            f"not a readable trace directory: {trace_dir!r} is missing "
            f"{', '.join(missing)}")
    with open(os.path.join(trace_dir, "metadata.json")) as f:
        try:
            meta = json.load(f)
        except ValueError as e:
            raise TraceFormatError(
                f"malformed metadata.json in {trace_dir!r}: {e}") from e
    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        raise TraceFormatError(
            f"unsupported format_version {version!r} in {trace_dir!r} "
            f"(this reader understands {FORMAT_VERSION})")
    merged_cst = _read_blob_list(os.path.join(trace_dir, "merged_cst.bin"))
    unique_cfgs = _read_blob_list(os.path.join(trace_dir, "unique_cfgs.bin"))
    with open(os.path.join(trace_dir, "cfg_index.bin"), "rb") as f:
        cfg_index = unpack_uvarints(f.read())
    with open(os.path.join(trace_dir, "timestamps.bin"), "rb") as f:
        ts_raw = f.read()
    if "ts_index" in meta:
        rank_ts = None
    elif "ts_offsets" in meta:
        rank_ts = [ts_raw[o : o + n] for o, n in meta["ts_offsets"]]
    else:
        raise TraceFormatError(
            f"metadata.json in {trace_dir!r} has neither ts_offsets nor "
            f"ts_index")
    return {
        "meta": meta,
        "merged_cst": merged_cst,
        "unique_cfgs": unique_cfgs,
        "cfg_index": cfg_index,
        "rank_timestamps": rank_ts,
        "ts_raw": ts_raw,
        "ts_index": meta.get("ts_index"),
    }


# ---------------------------------------------------------------------------
# multi-segment (streaming) trace directories
# ---------------------------------------------------------------------------


def is_stream_dir(trace_dir: str) -> bool:
    """A streaming trace directory carries a top-level manifest; a legacy
    single-segment trace carries metadata.json directly."""
    return os.path.exists(os.path.join(trace_dir, MANIFEST_FILE))


def read_manifest(trace_dir: str) -> Dict[str, Any]:
    path = os.path.join(trace_dir, MANIFEST_FILE)
    if not os.path.exists(path):
        raise TraceFormatError(
            f"not a streaming trace directory: {trace_dir!r} has no "
            f"{MANIFEST_FILE}")
    with open(path) as f:
        try:
            manifest = json.load(f)
        except ValueError as e:
            raise TraceFormatError(
                f"malformed {MANIFEST_FILE} in {trace_dir!r}: {e}") from e
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise TraceFormatError(
            f"unsupported format_version {version!r} in {trace_dir!r} "
            f"manifest (this reader understands {FORMAT_VERSION})")
    return manifest


def write_manifest(trace_dir: str, manifest: Dict[str, Any]) -> None:
    """Atomic + durable manifest rewrite: readers see either the old or
    the new segment list, never a torn one.  The tmp file and the
    directory entry are fsynced around the rename -- a torn manifest would
    make the WHOLE trace unreadable (far worse than losing one segment,
    whose truncation the per-file sizes already catch), so this one file
    pays the full durability cost."""
    tmp = os.path.join(trace_dir, MANIFEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(trace_dir, MANIFEST_FILE))
    try:
        dir_fd = os.open(trace_dir, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir fds
        return
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _segment_meta_version(seg_dir: str) -> Optional[int]:
    """format_version of a segment's metadata.json, or None when the file
    is missing/unparseable (then corruption handling owns the error)."""
    try:
        with open(os.path.join(seg_dir, "metadata.json")) as f:
            return json.load(f).get("format_version")
    except (OSError, ValueError):
        return None


def check_segment_versions(trace_dir: str,
                           entries: Sequence[Dict[str, Any]]) -> None:
    """Reject mixed ``format_version`` across the segments of one trace
    directory (:class:`TraceFormatError`): a trace assembled from
    incompatible writers must not be silently half-read.  Cheap -- only
    each segment's metadata.json is opened, never the blob files."""
    versions = {FORMAT_VERSION}
    for entry in entries:
        v = _segment_meta_version(os.path.join(trace_dir, entry["name"]))
        if v is not None:
            versions.add(v)
    if len(versions) > 1:
        raise TraceFormatError(
            f"mixed format_version across segments of {trace_dir!r}: "
            f"{sorted(versions, key=repr)} (all segments of one trace "
            f"directory must share the manifest's version)")


def validate_segment(trace_dir: str, entry: Dict[str, Any]) -> Optional[str]:
    """Check one manifest segment entry against the on-disk files; returns
    a human-readable reason when the segment must be skipped, else None.

    The manifest records every file's byte size at commit time, so a
    truncated (or grown) file -- the post-commit crash case -- is caught
    before any decode is attempted; the per-file CRC32s (``crcs``, written
    by the streaming commit path) additionally catch same-size damage --
    bit rot and torn writes -- that no size check can see.
    """
    seg_dir = os.path.join(trace_dir, entry["name"])
    if not os.path.isdir(seg_dir):
        return f"segment directory {entry['name']!r} is missing"
    for fname, want in entry.get("files", {}).items():
        path = os.path.join(seg_dir, fname)
        try:
            got = os.path.getsize(path)
        except OSError:
            # the segment can vanish between the manifest read and this
            # stat (retention pruning under a live reader): report it as
            # skippable, never let the race escape as FileNotFoundError
            return f"{entry['name']}/{fname} is missing"
        if got != want:
            return (f"{entry['name']}/{fname} is {got} bytes, manifest "
                    f"recorded {want} (truncated or corrupt)")
    for fname, want in entry.get("crcs", {}).items():
        path = os.path.join(seg_dir, fname)
        try:
            crc = 0
            with open(path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    crc = zlib.crc32(chunk, crc)
        except OSError as e:
            return f"{entry['name']}/{fname} is unreadable: {e}"
        if crc & 0xFFFFFFFF != want:
            return (f"{entry['name']}/{fname} fails its checksum (crc32 "
                    f"{crc & 0xFFFFFFFF:#010x}, manifest recorded "
                    f"{want:#010x}: bit rot or torn write)")
    return None


def read_trace_timestamps(trace_dir: str
                          ) -> Tuple[bytes, Optional[List[Any]],
                                     Dict[str, Any]]:
    """Only a trace directory's ``(timestamps.bin bytes, ts_index, meta)``
    -- ``ts_index`` is None for the legacy single-blob layout.  Lets
    callers that reassemble timestamps (the merged-trace writer) skip
    decoding the CST/CFG blobs entirely; the metadata rides along so wrap
    counters (``tick_wraps``) survive the merge."""
    try:
        with open(os.path.join(trace_dir, "metadata.json")) as f:
            meta = json.load(f)
        with open(os.path.join(trace_dir, "timestamps.bin"), "rb") as f:
            ts_raw = f.read()
    except (OSError, ValueError) as e:
        raise TraceFormatError(
            f"cannot read timestamps of {trace_dir!r}: {e}") from e
    return ts_raw, meta.get("ts_index"), meta


def load_segment(trace_dir: str, entry: Dict[str, Any]
                 ) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    """Validate + decode one manifest segment entry: ``(data, None)`` on
    success, ``(None, reason)`` when the segment must be skipped.  The
    single definition of what counts as an unusable segment -- shared by
    :func:`read_stream_trace` and the lazy per-entry reads in
    ``reader.TraceReader``."""
    reason = validate_segment(trace_dir, entry)
    if reason is None:
        try:
            return read_trace_files(os.path.join(trace_dir,
                                                 entry["name"])), None
        except (TraceFormatError, ValueError, IndexError, OSError) as e:
            # OSError covers the validate-then-read race: a concurrent
            # pruner may delete the segment directory between the size/CRC
            # check and the blob reads
            reason = f"{entry['name']} is unreadable: {e}"
    return None, reason


def read_stream_trace(trace_dir: str) -> Dict[str, Any]:
    """Read a multi-segment trace: the manifest plus every committed,
    intact segment's decoded payload.

    Partially-written segments never appear (atomic rename commit); a
    committed segment whose files were later corrupted is skipped and
    reported in ``skipped``.  Segments whose metadata carries a
    format_version different from the manifest's are a hard error
    (:class:`TraceFormatError`): mixing format versions inside one trace
    directory means the trace was assembled from incompatible writers.
    """
    manifest = read_manifest(trace_dir)
    entries = manifest.get("segments", [])
    check_segment_versions(trace_dir, entries)
    segments: List[Dict[str, Any]] = []
    skipped: List[Dict[str, str]] = []
    for entry in entries:
        data, reason = load_segment(trace_dir, entry)
        if data is None:
            skipped.append({"segment": entry["name"], "reason": reason})
            continue
        segments.append({"entry": entry, "data": data})
    return {"manifest": manifest, "segments": segments, "skipped": skipped}


def trace_size_report(trace_dir: str) -> Dict[str, int]:
    """Per-file sizes; 'pattern_files' = CFG+CST (what §5.1/§5.2 report),
    'total' = everything (§5.3)."""
    sizes = {}
    for name in ("merged_cst.bin", "unique_cfgs.bin", "cfg_index.bin",
                 "timestamps.bin", "metadata.json"):
        p = os.path.join(trace_dir, name)
        sizes[name] = os.path.getsize(p) if os.path.exists(p) else 0
    sizes["pattern_files"] = sizes["merged_cst.bin"] + sizes["unique_cfgs.bin"]
    sizes["total"] = sum(v for k, v in sizes.items()
                         if k not in ("pattern_files", "total"))
    return sizes
