"""A decoder of the Recorder trace format, for one rank's merged trace.

Reads ``metadata.json``, ``merged_cst.bin``, ``unique_cfgs.bin`` and
``cfg_index.bin`` of a trace directory (a streaming trace's ``merged/``),
expands the rank's grammar to its terminals, decodes each terminal's call
signature and resolves the offset patterns (``i*a + b`` runs keyed by the
call's function, thread, handles and other arguments).  A frozen copy of
the format as the port writes it; the port is not imported.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class Iter:
    a: Any
    b: Any


@dataclass(frozen=True)
class RankLin:
    a: int
    b: int


@dataclass(frozen=True)
class Handle:
    id: int


def _uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = result = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _svarint(buf: bytes, pos: int) -> Tuple[int, int]:
    u, pos = _uvarint(buf, pos)
    return (u >> 1) ^ -(u & 1), pos


def _value(buf: bytes, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == 0:
        return None, pos
    if tag == 5:
        return True, pos
    if tag == 6:
        return False, pos
    if tag == 1:
        return _svarint(buf, pos)
    if tag == 2:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag in (3, 4):
        n, pos = _uvarint(buf, pos)
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if tag == 3 else raw), pos + n
    if tag == 7:
        hid, pos = _uvarint(buf, pos)
        return Handle(hid), pos
    if tag == 8:
        a, pos = _value(buf, pos)
        b, pos = _value(buf, pos)
        return Iter(a, b), pos
    if tag == 9:
        a, pos = _svarint(buf, pos)
        b, pos = _svarint(buf, pos)
        return RankLin(a, b), pos
    if tag == 10:
        n, pos = _uvarint(buf, pos)
        items = []
        for _ in range(n):
            item, pos = _value(buf, pos)
            items.append(item)
        return tuple(items), pos
    if tag == 11:
        n, pos = _uvarint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = _value(buf, pos)
            d[k], pos = _value(buf, pos)
        return d, pos
    raise ValueError(f"bad value tag {tag} at {pos - 1}")


def _signature(buf: bytes) -> Tuple[int, int, int, tuple, Any]:
    fid, pos = _uvarint(buf, 0)
    tid, pos = _uvarint(buf, pos)
    depth, pos = _uvarint(buf, pos)
    n, pos = _uvarint(buf, pos)
    args = []
    for _ in range(n):
        v, pos = _value(buf, pos)
        args.append(v)
    ret, pos = _value(buf, pos)
    if pos != len(buf):
        raise ValueError("trailing bytes in a call signature")
    return fid, tid, depth, tuple(args), ret


def _blobs(path: str) -> List[bytes]:
    with open(path, "rb") as f:
        buf = f.read()
    n, pos = _uvarint(buf, 0)
    out = []
    for _ in range(n):
        ln, pos = _uvarint(buf, pos)
        out.append(buf[pos:pos + ln])
        pos += ln
    return out


def _grammar(buf: bytes) -> List[List[Tuple[int, int]]]:
    n_rules, pos = _uvarint(buf, 0)
    rules = []
    for _ in range(n_rules):
        n, pos = _uvarint(buf, pos)
        items = []
        for _ in range(n):
            code, pos = _uvarint(buf, pos)
            exp, pos = _uvarint(buf, pos)
            items.append((code, exp))
        rules.append(items)
    return rules


def _terminals(rules: List[List[Tuple[int, int]]]) -> List[int]:
    """Rule 0 expanded: an odd code names rule ``code >> 1``, an even one
    the terminal ``code >> 1``; each item repeats ``exp`` times."""
    out: List[int] = []
    stack = [[0, 0, 0]]          # rule, next item, repeats left
    while stack:
        frame = stack[-1]
        items = rules[frame[0]]
        if frame[2] == 0:
            if frame[1] >= len(items):
                stack.pop()
                continue
            frame[2] = items[frame[1]][1]
            frame[1] += 1
            continue
        code = items[frame[1] - 1][0]
        frame[2] -= 1
        if code & 1:
            stack.append([code >> 1, 0, 0])
        else:
            out.append(code >> 1)
    return out


def _rank(v: Any, rank: int) -> Any:
    if isinstance(v, RankLin):
        return rank * v.a + v.b
    if isinstance(v, Iter):
        return Iter(_rank(v.a, rank), _rank(v.b, rank))
    if isinstance(v, tuple):
        return tuple(_rank(x, rank) for x in v)
    return v


def read_records(trace_dir: str, rank: int = 0
                 ) -> List[Tuple[str, tuple, Any]]:
    """(function name, arguments, return) of every call of ``rank``, in
    order; handles as :class:`Handle`, offsets resolved to integers."""
    with open(os.path.join(trace_dir, "metadata.json")) as f:
        meta = json.load(f)
    funcs = {int(k): v for k, v in meta["functions"].items()}
    cst = _blobs(os.path.join(trace_dir, "merged_cst.bin"))
    cfgs = _blobs(os.path.join(trace_dir, "unique_cfgs.bin"))
    with open(os.path.join(trace_dir, "cfg_index.bin"), "rb") as f:
        raw = f.read()
    index, pos = [], 0
    while pos < len(raw):
        v, pos = _uvarint(raw, pos)
        index.append(v)
    runs: Dict[Any, Tuple[int, Any]] = {}
    out = []
    for term in _terminals(_grammar(cfgs[index[rank]])):
        fid, tid, _, args, ret = _signature(cst[term])
        info = funcs[fid]
        roles = info["arg_roles"]
        args, ret = _rank(args, rank), _rank(ret, rank)
        slots = [j for j, r in enumerate(roles) if r == "offset"]
        ret_off = info["ret_role"] == "offset" and not (
            isinstance(ret, tuple) and len(ret) == 2 and ret[0] == "err") \
            and isinstance(ret, (int, Iter))
        enc = [args[j] for j in slots] + ([ret] if ret_off else [])
        if enc:
            hids = tuple(a.id for j, a in enumerate(args)
                         if j not in slots and isinstance(a, Handle))
            parts = tuple(a for j, a in enumerate(args)
                          if j not in slots and not isinstance(a, Handle))
            key_ret = None if ret_off else (
                ("h", ret.id) if isinstance(ret, Handle) else ret)
            key = (fid, tid, hids, parts, key_ret)
            if any(isinstance(v, Iter) for v in enc):
                sig = tuple((v.a, v.b) if isinstance(v, Iter) else v
                            for v in enc)
                idx, prev = runs.get(key, (1, None))
                idx = idx + 1 if prev == sig else 1
                runs[key] = (idx, sig)
                dec = [v.b + idx * v.a if isinstance(v, Iter) else v
                       for v in enc]
            else:
                runs[key] = (1, None)
                dec = list(enc)
            args = list(args)
            for j, v in zip(slots, dec):
                args[j] = v
            args = tuple(args)
            if ret_off:
                ret = dec[-1]
        out.append((info["name"], args, ret))
    return out
