"""Deterministic binary encoding for call signatures and trace files.

Recorder stores every function parameter of every intercepted call (paper
Section 2).  Signatures must be *byte-deterministic* so that the Call
Signature Table (CST) can key on them and the inter-process merge can compare
them across ranks.  We use a small tagged varint format rather than a generic
serializer: it is reproducible, compact, and supports the two pattern value
kinds introduced by the compression algorithm (paper Section 3.2):

  * ``IterPattern(a, b)``  -- intra-process offsets following ``i*a + b``
  * ``RankPattern(a, b)``  -- inter-process components following ``rank*a + b``

Pattern components may nest (Fig. 3(c): ``lseek((20, (10, 0)))`` encodes an
iteration stride of 20 whose base is rank-linear ``10*rank + 0``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# varint / zigzag primitives
# ---------------------------------------------------------------------------


class VarintRangeError(ValueError):
    """A batched uvarint value falls outside [0, 2^64).

    The batched packers (NumPy / PyTorch / CUDA, see ``encode_backend``) operate on
    u64 lanes, so a >64-bit int cannot take the accelerated path.  Callers
    that legitimately carry arbitrary-precision ints (``encode_value`` /
    ``write_svarint`` tagged values) keep using the scalar
    :func:`write_uvarint`, which stays arbitrary-precision."""


_U64_MAX = (1 << 64) - 1


def zigzag(n: int) -> int:
    """Map signed -> unsigned (0,-1,1,-2,... -> 0,1,2,3,...)."""
    return (n << 1) ^ (n >> 63) if -(1 << 63) <= n < (1 << 63) else _zigzag_big(n)


def _zigzag_big(n: int) -> int:
    # arbitrary precision fallback (offsets are < 2^63 in practice)
    return n << 1 if n >= 0 else ((-n) << 1) - 1


def unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def write_uvarint(out: bytearray, u: int) -> None:
    if u < 0:
        raise ValueError("uvarint must be non-negative")
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def write_svarint(out: bytearray, n: int) -> None:
    write_uvarint(out, zigzag(n))


def read_uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def read_svarint(buf: bytes, pos: int) -> Tuple[int, int]:
    u, pos = read_uvarint(buf, pos)
    return unzigzag(u), pos


def write_blob(out: bytearray, b: bytes) -> None:
    """Length-prefixed byte string (uvarint length + raw bytes)."""
    write_uvarint(out, len(b))
    out.extend(b)


def read_blob(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = read_uvarint(buf, pos)
    return bytes(buf[pos : pos + n]), pos + n


def pack_uvarints(values: Iterable[int],
                  backend: Optional[str] = None) -> bytes:
    """Concatenated uvarints of ``values`` (all in [0, 2^64) -- the
    batched backends mirror the kernels' u64 lane width, and the scalar
    path enforces the same bound so every backend agrees; a wider int
    raises :class:`VarintRangeError`).

    Large batches dispatch to the vectorized packers in
    ``encode_backend`` (``backend=None`` -> the module default backend);
    output is byte-identical across backends."""
    if not isinstance(values, (list, tuple)):
        values = list(values)
    from . import encode_backend as _eb
    eff = _eb.resolve(backend, len(values))
    if eff != "python":
        return _eb.pack_uvarints_batch(values, eff)
    out = bytearray()
    for v in values:
        if not 0 <= v <= _U64_MAX:
            raise VarintRangeError(
                f"uvarint batch value outside [0, 2^64): {v!r}")
        write_uvarint(out, v)
    return bytes(out)


def unpack_uvarints(buf: bytes) -> List[int]:
    pos = 0
    out = []
    n = len(buf)
    while pos < n:
        v, pos = read_uvarint(buf, pos)
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# pattern value types (paper Section 3.2)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IterPattern:
    """Value of the i-th call in a run equals ``i*a + b`` (intra-process)."""

    a: Any  # stride  (int or RankPattern)
    b: Any  # base    (int or RankPattern)


@dataclass(frozen=True)
class RankPattern:
    """Value for rank ``r`` equals ``r*a + b`` (inter-process)."""

    a: int
    b: int

    def value_for(self, rank: int) -> int:
        return rank * self.a + self.b


@dataclass(frozen=True)
class Handle:
    """Unified file-handle id (paper Section 3.2.2: opaque MPI_File handles
    are replaced by a group-wide unique id at open time)."""

    id: int


# value tags
_T_NONE = 0
_T_INT = 1
_T_FLOAT = 2
_T_STR = 3
_T_BYTES = 4
_T_TRUE = 5
_T_FALSE = 6
_T_HANDLE = 7
_T_ITERPAT = 8
_T_RANKPAT = 9
_T_TUPLE = 10
_T_DICT = 11


def encode_value(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(_T_NONE)
    elif v is True:
        out.append(_T_TRUE)
    elif v is False:
        out.append(_T_FALSE)
    elif isinstance(v, int):
        out.append(_T_INT)
        write_svarint(out, v)
    elif isinstance(v, float):
        out.append(_T_FLOAT)
        out.extend(struct.pack("<d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(_T_STR)
        write_uvarint(out, len(raw))
        out.extend(raw)
    elif isinstance(v, (bytes, bytearray)):
        out.append(_T_BYTES)
        write_uvarint(out, len(v))
        out.extend(v)
    elif isinstance(v, Handle):
        out.append(_T_HANDLE)
        write_uvarint(out, v.id)
    elif isinstance(v, IterPattern):
        out.append(_T_ITERPAT)
        encode_value(out, v.a)
        encode_value(out, v.b)
    elif isinstance(v, RankPattern):
        out.append(_T_RANKPAT)
        write_svarint(out, v.a)
        write_svarint(out, v.b)
    elif isinstance(v, (tuple, list)):
        out.append(_T_TUPLE)
        write_uvarint(out, len(v))
        for item in v:
            encode_value(out, item)
    elif isinstance(v, dict):
        # insertion-order encoding: deterministic for deterministically
        # built dicts (used by the tree-finalize state serialization)
        out.append(_T_DICT)
        write_uvarint(out, len(v))
        for k, item in v.items():
            encode_value(out, k)
            encode_value(out, item)
    else:
        # last resort: stringified (keeps tracing robust for odd arg types)
        encode_value(out, repr(v))


def decode_value(buf: bytes, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_INT:
        return read_svarint(buf, pos)
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == _T_STR:
        n, pos = read_uvarint(buf, pos)
        return buf[pos : pos + n].decode("utf-8"), pos + n
    if tag == _T_BYTES:
        n, pos = read_uvarint(buf, pos)
        return bytes(buf[pos : pos + n]), pos + n
    if tag == _T_HANDLE:
        hid, pos = read_uvarint(buf, pos)
        return Handle(hid), pos
    if tag == _T_ITERPAT:
        a, pos = decode_value(buf, pos)
        b, pos = decode_value(buf, pos)
        return IterPattern(a, b), pos
    if tag == _T_RANKPAT:
        a, pos = read_svarint(buf, pos)
        b, pos = read_svarint(buf, pos)
        return RankPattern(a, b), pos
    if tag == _T_TUPLE:
        n, pos = read_uvarint(buf, pos)
        items = []
        for _ in range(n):
            item, pos = decode_value(buf, pos)
            items.append(item)
        return tuple(items), pos
    if tag == _T_DICT:
        n, pos = read_uvarint(buf, pos)
        d = {}
        for _ in range(n):
            k, pos = decode_value(buf, pos)
            item, pos = decode_value(buf, pos)
            d[k] = item
        return d, pos
    raise ValueError(f"bad value tag {tag} at {pos - 1}")


# ---------------------------------------------------------------------------
# call signatures
# ---------------------------------------------------------------------------


def encode_signature(func_id: int, thread_id: int, depth: int, args: tuple,
                     ret: Any) -> bytes:
    """A call signature is function id + thread id + call depth + all
    arguments + return value (paper Section 3.1)."""
    out = bytearray()
    write_uvarint(out, func_id)
    write_uvarint(out, thread_id)
    write_uvarint(out, depth)
    write_uvarint(out, len(args))
    for a in args:
        encode_value(out, a)
    encode_value(out, ret)
    return bytes(out)


def decode_signature(buf: bytes) -> Tuple[int, int, int, tuple, Any]:
    pos = 0
    func_id, pos = read_uvarint(buf, pos)
    thread_id, pos = read_uvarint(buf, pos)
    depth, pos = read_uvarint(buf, pos)
    nargs, pos = read_uvarint(buf, pos)
    args = []
    for _ in range(nargs):
        v, pos = decode_value(buf, pos)
        args.append(v)
    ret, pos = decode_value(buf, pos)
    if pos != len(buf):
        raise ValueError("trailing bytes in signature")
    return func_id, thread_id, depth, tuple(args), ret


# ---------------------------------------------------------------------------
# batched signature decoding (columnar trace reads)
# ---------------------------------------------------------------------------


def _batch_read_uvarints(buf: np.ndarray, start: np.ndarray, n_fields: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Read ``n_fields`` consecutive uvarints at every position in ``start``.

    Vectorized over the starts: each inner iteration consumes one byte of
    every still-unfinished varint, so the loop depth is the longest varint
    (<= 10 bytes), not the number of signatures.  Returns the decoded
    ``(len(start), n_fields)`` int64 matrix and the positions just past the
    last field.
    """
    pos = start.astype(np.int64).copy()
    out = np.zeros((len(pos), n_fields), dtype=np.int64)
    for f in range(n_fields):
        val = np.zeros(len(pos), dtype=np.int64)
        shift = np.zeros(len(pos), dtype=np.int64)
        active = np.ones(len(pos), dtype=bool)
        while active.any():
            idx = np.flatnonzero(active)
            b = buf[pos[idx]].astype(np.int64)
            val[idx] |= (b & 0x7F) << shift[idx]
            pos[idx] += 1
            shift[idx] += 7
            active[idx[(b & 0x80) == 0]] = False
        out[:, f] = val
    return out, pos


@dataclass
class SignatureColumns:
    """Column-oriented decode of many call signatures (one row per CST
    entry): fixed header fields as NumPy arrays, argument tuples and return
    values as aligned Python lists (they are heterogeneous tagged values,
    possibly nested patterns)."""

    func_id: np.ndarray   # (n,) int64
    thread: np.ndarray    # (n,) int64
    depth: np.ndarray     # (n,) int64
    nargs: np.ndarray     # (n,) int64
    args: List[tuple]
    ret: List[Any]

    def __len__(self) -> int:
        return len(self.args)


def decode_signatures_batch(sigs: Sequence[bytes]) -> SignatureColumns:
    """Decode a whole CST at once into :class:`SignatureColumns`.

    The four header uvarints (func id, thread, depth, argc) of every entry
    are decoded in one vectorized NumPy pass over the concatenated buffer
    (:func:`_batch_read_uvarints`); the tagged argument/return values --
    variable arity, nestable patterns -- are decoded per entry from where
    the header pass stopped.  Result-identical to mapping
    :func:`decode_signature` over ``sigs``.
    """
    n = len(sigs)
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return SignatureColumns(z, z.copy(), z.copy(), z.copy(), [], [])
    lens = np.fromiter((len(s) for s in sigs), dtype=np.int64, count=n)
    starts = np.zeros(n, dtype=np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    buf = np.frombuffer(b"".join(sigs), dtype=np.uint8)
    heads, pos = _batch_read_uvarints(buf, starts, 4)
    args_col: List[tuple] = []
    ret_col: List[Any] = []
    for i, sig in enumerate(sigs):
        p = int(pos[i] - starts[i])
        args = []
        for _ in range(int(heads[i, 3])):
            v, p = decode_value(sig, p)
            args.append(v)
        ret, p = decode_value(sig, p)
        if p != len(sig):
            raise ValueError("trailing bytes in signature")
        args_col.append(tuple(args))
        ret_col.append(ret)
    return SignatureColumns(func_id=heads[:, 0].copy(),
                            thread=heads[:, 1].copy(),
                            depth=heads[:, 2].copy(),
                            nargs=heads[:, 3].copy(),
                            args=args_col, ret=ret_col)


def concat_signature_columns(a: SignatureColumns,
                             b: SignatureColumns) -> SignatureColumns:
    """Row-wise concatenation of two column sets (incremental reader
    refresh: the already-decoded prefix is reused, only the new segments'
    entries are decoded and appended).  Equal to decoding the concatenated
    signature list in one shot."""
    return SignatureColumns(
        func_id=np.concatenate([a.func_id, b.func_id]),
        thread=np.concatenate([a.thread, b.thread]),
        depth=np.concatenate([a.depth, b.depth]),
        nargs=np.concatenate([a.nargs, b.nargs]),
        args=a.args + b.args,
        ret=a.ret + b.ret)
