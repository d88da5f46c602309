"""Trace-format converters (paper Section 2.3).

``to_chrome_timeline``  Recorder trace -> Chrome trace-event JSON
                        (loadable in chrome://tracing / perfetto).
``to_columnar``         Recorder trace -> column-oriented dataset in 64K-row
                        groups with per-column compression -- the Parquet
                        converter adapted to this container (pyarrow is not
                        installed offline, so we emit the same columnar
                        layout in a self-describing .npz-style format and
                        keep the row-group + column-compression semantics;
                        a deployment note covers swapping in pyarrow).
``read_columnar``       loads a columnar dataset back into numpy columns.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .encoding import Handle, IterPattern, RankPattern
from .reader import TraceReader

ROW_GROUP = 65536  # records per group (paper: "group of 64K records")


def _arg_str(v: Any) -> str:
    if isinstance(v, Handle):
        return f"h{v.id}"
    if isinstance(v, (IterPattern, RankPattern)):
        return repr(v)
    return str(v)


def to_chrome_timeline(trace_dir: str, out_path: str,
                       ranks: Optional[List[int]] = None) -> int:
    """Write Chrome trace-event JSON; returns the number of events."""
    reader = TraceReader(trace_dir)
    ranks = ranks if ranks is not None else list(range(reader.nranks))
    n = 0
    with open(out_path, "w") as f:
        f.write('{"traceEvents":[\n')
        first = True
        for r in ranks:
            for rec in reader.iter_records(r):
                ev = {
                    "name": rec.func,
                    "cat": rec.layer,
                    "ph": "X",
                    "pid": r,
                    "tid": rec.thread,
                    "ts": rec.t_entry if rec.t_entry is not None else 0,
                    "dur": ((rec.t_exit - rec.t_entry)
                            if rec.t_entry is not None else 0),
                    "args": {k: _arg_str(v) for k, v in
                             zip(rec.arg_names, rec.args)},
                }
                ev["args"]["depth"] = rec.depth
                f.write(("" if first else ",\n") + json.dumps(ev))
                first = False
                n += 1
        f.write('\n]}')
    return n


# ---------------------------------------------------------------------------
# columnar converter
# ---------------------------------------------------------------------------

_COLUMNS = ("rank", "func_id", "thread", "depth", "t_entry", "t_exit",
            "offset", "size", "path_id")


def _record_cols(reader: TraceReader, r: int) -> Iterator[Dict[str, Any]]:
    for rec in reader.iter_records(r):
        offset = size = -1
        path_id = -1
        for name, v, role in zip(rec.arg_names, rec.args, rec.roles):
            if role == "offset" and isinstance(v, (int, np.integer)):
                offset = int(v)
            elif role in ("size", "buf") and isinstance(v, (int, np.integer)):
                size = int(v)
        yield {"rank": r, "func": rec.func, "thread": rec.thread,
               "depth": rec.depth, "t_entry": rec.t_entry or 0,
               "t_exit": rec.t_exit or 0, "offset": offset, "size": size,
               "path": next((str(v) for v, role in zip(rec.args, rec.roles)
                             if role == "path"), None)}


def to_columnar(trace_dir: str, out_dir: str) -> Dict[str, int]:
    """Column-oriented dataset: one compressed block per column per 64K-row
    group + a dataset manifest.  Returns {file: bytes}."""
    reader = TraceReader(trace_dir)
    os.makedirs(out_dir, exist_ok=True)
    func_ids: Dict[str, int] = {}
    path_ids: Dict[str, int] = {}
    rows: List[Dict[str, Any]] = []
    group = 0
    sizes: Dict[str, int] = {}

    def flush():
        nonlocal group, rows
        if not rows:
            return
        cols = {
            "rank": np.array([r["rank"] for r in rows], np.int32),
            "func_id": np.array([func_ids.setdefault(r["func"],
                                                     len(func_ids))
                                 for r in rows], np.int32),
            "thread": np.array([r["thread"] for r in rows], np.int32),
            "depth": np.array([r["depth"] for r in rows], np.int16),
            "t_entry": np.array([r["t_entry"] for r in rows], np.uint32),
            "t_exit": np.array([r["t_exit"] for r in rows], np.uint32),
            "offset": np.array([r["offset"] for r in rows], np.int64),
            "size": np.array([r["size"] for r in rows], np.int64),
            "path_id": np.array(
                [-1 if r["path"] is None
                 else path_ids.setdefault(r["path"], len(path_ids))
                 for r in rows], np.int32),
        }
        fn = os.path.join(out_dir, f"group_{group:05d}.cols")
        with open(fn, "wb") as f:
            header = {}
            blobs = []
            off = 0
            for name, arr in cols.items():
                blob = zlib.compress(arr.tobytes(), 6)  # snappy-role codec
                header[name] = {"dtype": str(arr.dtype), "n": len(arr),
                                "off": off, "len": len(blob)}
                blobs.append(blob)
                off += len(blob)
            hj = json.dumps(header).encode()
            f.write(len(hj).to_bytes(4, "little"))
            f.write(hj)
            for b in blobs:
                f.write(b)
        sizes[os.path.basename(fn)] = os.path.getsize(fn)
        group += 1
        rows = []

    for r in range(reader.nranks):
        for row in _record_cols(reader, r):
            rows.append(row)
            if len(rows) >= ROW_GROUP:
                flush()
    flush()
    manifest = {"n_groups": group, "columns": list(_COLUMNS),
                "functions": {v: k for k, v in func_ids.items()},
                "paths": {v: k for k, v in path_ids.items()}}
    mp = os.path.join(out_dir, "dataset.json")
    with open(mp, "w") as f:
        json.dump(manifest, f)
    sizes["dataset.json"] = os.path.getsize(mp)
    return sizes


def read_columnar(out_dir: str) -> Dict[str, np.ndarray]:
    with open(os.path.join(out_dir, "dataset.json")) as f:
        manifest = json.load(f)
    cols: Dict[str, List[np.ndarray]] = {}
    for g in range(manifest["n_groups"]):
        fn = os.path.join(out_dir, f"group_{g:05d}.cols")
        with open(fn, "rb") as f:
            hlen = int.from_bytes(f.read(4), "little")
            header = json.loads(f.read(hlen))
            base = f.tell()
            for name, h in header.items():
                f.seek(base + h["off"])
                raw = zlib.decompress(f.read(h["len"]))
                cols.setdefault(name, []).append(
                    np.frombuffer(raw, dtype=h["dtype"]))
    return {k: np.concatenate(v) for k, v in cols.items()}
