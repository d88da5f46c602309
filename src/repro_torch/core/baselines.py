"""Comparison baselines for Section 5.3: Recorder-old and a Darshan-like profiler.

The counterpart of the JAX package's ``core/baselines.py``: the same
classes, signatures and bytes (host code only; it has no kernel).

``ToolAdapter`` exposes the Recorder runtime interface (now/enter/exit/
record/...) so either baseline can be ``attach``ed behind the SAME
generated tracing wrappers -- the overhead and trace-size comparisons then
measure the tools, not different instrumentation paths.

``RecorderOld`` -- the predecessor's design (paper references [9]):
  * one trace file PER RANK (no inter-process stage at all),
  * every record stored individually: (func_id, tid, depth, args, ret,
    t_entry, t_exit) in the same varint encoding the new tool uses (so the
    comparison isolates the *compression algorithm*, not the serializer),
  * peephole compression only: a record identical to its predecessor except
    for an offset advanced by the same delta (and timestamps) is stored as a
    2-byte "repeat" token -- the strongest reasonable reading of the
    peephole scheme,
  * trace size therefore grows linearly in ranks x calls.

``DarshanLike`` -- counter-based profiling with optional DXT:
  * per (file, layer) counters: call counts per function, byte/offset
    aggregates, time histogram -- fixed size per file regardless of calls,
  * DXT mode: per data-call segment record (rank, offset, length, start,
    end) at 24 bytes, POSIX/MPC-IO data ops only -- linear in calls but
    lean; metadata calls and most parameters are NOT captured (that is the
    fidelity gap the paper's Table 3 discusses).
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .encoding import encode_signature
from .specs import REGISTRY, FunctionRegistry, Role


# ---------------------------------------------------------------------------
# Recorder-old
# ---------------------------------------------------------------------------


class RecorderOld:
    """Per-rank, record-at-a-time tracer with peephole compression."""

    REPEAT = b"\xff\xfe"

    def __init__(self, rank: int, registry: FunctionRegistry = REGISTRY):
        self.rank = rank
        self.registry = registry
        self._buf = bytearray()
        self._prev: Optional[Tuple] = None   # (func, tid, depth, args, ret)
        self._prev_delta: Optional[Tuple] = None
        self.n_records = 0

    def record(self, func_id: int, tid: int, depth: int, args: tuple,
               ret: Any, t0: int, t1: int) -> None:
        self.n_records += 1
        spec = self.registry.spec(func_id)
        off_pos = spec.offset_positions
        key = (func_id, tid, depth,
               tuple(v for i, v in enumerate(args) if i not in off_pos), ret)
        offs = tuple(int(args[i]) for i in off_pos if i < len(args))
        if self._prev is not None:
            pkey, poffs = self._prev
            if key == pkey and len(offs) == len(poffs):
                delta = tuple(o - p for o, p in zip(offs, poffs))
                if self._prev_delta is None or delta == self._prev_delta:
                    # peephole hit: 2-byte repeat + 2x4-byte timestamps
                    self._buf += self.REPEAT
                    self._buf += struct.pack("<II", t0 & 0xFFFFFFFF,
                                             t1 & 0xFFFFFFFF)
                    self._prev = (key, offs)
                    self._prev_delta = delta
                    return
        sig = encode_signature(func_id, tid, depth, args, ret)
        self._buf += struct.pack("<H", len(sig))
        self._buf += sig
        self._buf += struct.pack("<II", t0 & 0xFFFFFFFF, t1 & 0xFFFFFFFF)
        self._prev = (key, offs)
        self._prev_delta = None

    @property
    def nbytes(self) -> int:
        return len(self._buf)

    def write(self, trace_dir: str) -> int:
        os.makedirs(trace_dir, exist_ok=True)
        p = os.path.join(trace_dir, f"rank_{self.rank}.rec2")
        with open(p, "wb") as f:
            f.write(bytes(self._buf))
        return os.path.getsize(p)


# ---------------------------------------------------------------------------
# Darshan-like
# ---------------------------------------------------------------------------


_DATA_OPS = {"pwrite", "pread", "write", "read", "shard_write_at",
             "shard_read_at"}


@dataclass
class _FileCounters:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_rw: int = 0
    max_offset: int = 0
    t_first: float = float("inf")
    t_last: float = 0.0


class ToolAdapter:
    """Drives a baseline tool through the generated wrapper interface."""

    def __init__(self, tool, rank: int = 0,
                 registry: FunctionRegistry = REGISTRY):
        self._tool = tool
        self._t0 = time.perf_counter()
        self._depth = 0
        self.rank = rank
        self.registry = registry

    def now(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    def enter(self) -> int:
        d = self._depth
        self._depth += 1
        return d

    def exit(self) -> None:
        self._depth -= 1

    def layer_enabled(self, layer: str) -> bool:
        return True

    def record(self, func_id: int, raw_args: tuple, ret, depth: int,
               t0: int, t1: int) -> None:
        norm = tuple(len(a) if isinstance(a, (bytes, bytearray)) else a
                     for a in raw_args)
        self._tool.record(func_id, 0, depth, norm, _scrub(ret), t0, t1)

    def forget_handle(self, raw) -> None:
        pass


def _scrub(ret):
    return len(ret) if isinstance(ret, (bytes, bytearray)) else (
        ret if isinstance(ret, (int, float, str, bool, type(None), tuple))
        else repr(ret))


class DarshanLike:
    """Per-rank counter profiler + optional DXT segment capture."""

    DXT_RECORD = struct.Struct("<iqqII")  # rank, offset, length, t0, t1

    def __init__(self, rank: int, dxt: bool = True,
                 registry: FunctionRegistry = REGISTRY):
        self.rank = rank
        self.dxt = dxt
        self.registry = registry
        self.files: Dict[Any, _FileCounters] = {}
        self._dxt_buf = bytearray()
        self.n_records = 0

    def record(self, func_id: int, tid: int, depth: int, args: tuple,
               ret: Any, t0: int, t1: int) -> None:
        self.n_records += 1
        spec = self.registry.spec(func_id)
        # resolve a file key: first PATH or HANDLE arg
        fkey = "<none>"
        for i, a in enumerate(spec.args):
            if a.role in (Role.PATH, Role.HANDLE) and i < len(args):
                fkey = args[i]
                break
        fc = self.files.setdefault(fkey, _FileCounters())
        fc.counts[spec.name] = fc.counts.get(spec.name, 0) + 1
        size = 0
        offset = None
        for i, a in enumerate(spec.args):
            if i >= len(args):
                continue
            if a.role == Role.BUF:
                size = len(args[i]) if hasattr(args[i], "__len__") else \
                    int(args[i] or 0)
            elif a.role == Role.SIZE and isinstance(args[i], int):
                size = args[i]
            elif a.role == Role.OFFSET:
                offset = int(args[i])
        fc.bytes_rw += size
        if offset is not None:
            fc.max_offset = max(fc.max_offset, offset + size)
        fc.t_first = min(fc.t_first, t0)
        fc.t_last = max(fc.t_last, t1)
        if self.dxt and spec.name in _DATA_OPS and spec.layer in (
                "posix", "shardio"):
            self._dxt_buf += self.DXT_RECORD.pack(
                self.rank, offset or 0, size, t0 & 0xFFFFFFFF,
                t1 & 0xFFFFFFFF)

    def serialize(self) -> bytes:
        """Darshan-style compact log: zlib'd JSON counters + raw DXT."""
        counters = {str(k): {"counts": fc.counts, "bytes": fc.bytes_rw,
                             "max_offset": fc.max_offset,
                             "t": [fc.t_first, fc.t_last]}
                    for k, fc in self.files.items()}
        blob = zlib.compress(json.dumps(counters).encode(), 6)
        dxt = zlib.compress(bytes(self._dxt_buf), 6)  # darshan logs are zlib'd
        head = struct.pack("<II", len(blob), len(dxt))
        return head + blob + dxt

    def write(self, trace_dir: str) -> int:
        os.makedirs(trace_dir, exist_ok=True)
        p = os.path.join(trace_dir, f"rank_{self.rank}.darshan")
        with open(p, "wb") as f:
            f.write(self.serialize())
        return os.path.getsize(p)
