"""Backend dispatch for the batched encode/fit hot paths.

The arithmetic-dense stages of the tracing pipeline -- timestamp
delta+zigzag (and its fused varint emit), varint packing, arithmetic-run
boundary detection, rank-linear column fitting, and the terminal and
digram histograms of the read side -- exist in interchangeable
implementations:

``python``
    The scalar reference loops.  Slowest, but trivially auditable; the
    tests pin every other backend byte-identical to them.

``numpy``
    Vectorized host implementations (this module).

``torch``
    The plain PyTorch versions of the kernels (``kernels/*/ref.py``), run
    on CPU tensors through the same wrappers the ``cuda`` backend calls.

``cuda`` (the default)
    The hand-written Hopper kernels under ``repro_torch.kernels``
    (``delta_encode``, ``grammar_stats``), on the CUDA card.  Without a
    card it raises; it never falls back to the host.  The kernels take
    int64 (u32 ticks travel as int32 bit patterns), so values at or above
    2^31 stay on the card too.

``auto``
    Crosses over by batch size: tiny batches stay on the Python loop,
    everything else runs NumPy, and batches of ``CUDA_MIN_BATCH``+ move to
    the kernels when a card is present.

Every backend produces byte-identical output
(``RecorderConfig.encode_backend`` / ``RECORDER_ENCODE_BACKEND`` and
:func:`set_default_backend`).  Callers that pass ``backend=None`` --
grammar serialization and the ``cfg_index`` packing of ``write_trace`` --
follow the module default, not a Recorder's config.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.delta_encode import ops as _de
from ..kernels.grammar_stats import ops as _gs
from .encoding import VarintRangeError, write_uvarint

BACKENDS = ("auto", "python", "numpy", "torch", "cuda")

# crossover points for the "auto" backend
NUMPY_MIN_BATCH = 64         # below: NumPy call overhead beats the loop win
CUDA_MIN_BATCH = 1 << 16     # below: kernel launch + transfer dominates

_default_backend = "cuda"


def default_backend() -> str:
    return _default_backend


def set_default_backend(backend: str) -> None:
    """Set the module-wide default used when callers pass ``backend=None``
    (grammar serialization, ``write_trace``'s cfg_index packing, the flat
    finalize fitter unless the config asks for ``cuda``)."""
    global _default_backend
    if backend not in BACKENDS:
        raise ValueError(f"encode backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    _default_backend = backend


def has_accelerator() -> bool:
    """True when PyTorch sees a CUDA card."""
    return torch.cuda.is_available()


def require_device(backend: str) -> None:
    """Raise when ``backend`` is ``cuda`` and no CUDA card is present."""
    if backend == "cuda" and not has_accelerator():
        raise RuntimeError(
            "encode backend 'cuda' needs a CUDA device, but "
            "torch.cuda.is_available() is False; pick 'numpy', 'torch' or "
            "'python' to encode on the CPU")


def resolve(backend: Optional[str], n: int) -> str:
    """Effective backend for a batch of ``n`` elements: explicit choices
    win; ``auto`` applies the size crossover."""
    b = backend if backend is not None else _default_backend
    if b not in BACKENDS:
        raise ValueError(f"encode backend must be one of {BACKENDS}, "
                         f"got {b!r}")
    if b != "auto":
        require_device(b)
        return b
    if n < NUMPY_MIN_BATCH:
        return "python"
    if n >= CUDA_MIN_BATCH and has_accelerator():
        return "cuda"
    return "numpy"


def _to_device(a: np.ndarray, backend: str) -> torch.Tensor:
    """Host array -> tensor for the ``torch`` (CPU) or ``cuda`` backend."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if backend == "cuda":
        require_device(backend)
        return t.cuda()
    return t


# ---------------------------------------------------------------------------
# delta + zigzag (timestamp pipeline stage)
# ---------------------------------------------------------------------------


def _as_u32(flat: np.ndarray) -> np.ndarray:
    """Contiguous u32 view of a flat integer array; other integer types are
    cut to their low 32 bits, which is all a delta mod 2^32 reads."""
    flat = np.ascontiguousarray(flat).reshape(-1)
    return flat if flat.dtype == np.uint32 else flat.astype(np.uint32)


def _delta_zigzag_py(flat: np.ndarray, segment: int) -> np.ndarray:
    """Scalar reference: first-order delta wrapped mod 2^32 -> zigzag u32,
    restarting from 0 at every multiple of ``segment``."""
    out = np.empty(len(flat), np.uint32)
    prev = 0
    for i, v in enumerate(flat.tolist()):
        d = v if i == 0 or (segment and i % segment == 0) else v - prev
        prev = v
        d = ((d + (1 << 31)) % (1 << 32)) - (1 << 31)
        out[i] = ((d << 1) ^ (d >> 63)) & 0xFFFFFFFF
    return out


def _delta_zigzag_np(u: np.ndarray, segment: int) -> np.ndarray:
    """The same in u32 arithmetic, which wraps mod 2^32 as the kernel's
    does; the zigzag shifts run on the int32 view."""
    d = u.copy()
    d[1:] -= u[:-1]
    if segment:
        d[::segment] = u[::segment]
    s = d.view(np.int32)
    return ((s << 1) ^ (s >> 31)).view(np.uint32)


def _delta_zigzag_torch(u: np.ndarray, backend: str,
                        segment: int) -> np.ndarray:
    x = _to_device(u.view(np.int32), backend)
    return _de.delta_zigzag(x, segment).cpu().numpy().view(np.uint32)


def delta_zigzag(flat: np.ndarray, backend: Optional[str] = None,
                 segment: int = 0) -> np.ndarray:
    """Flat tick stream (u32, or any integer type, read mod 2^32) ->
    zigzag'd u32 deltas, backend-dispatched.  Element i is taken against 0
    where ``i % segment == 0`` (``segment`` 0: only element 0), so one call
    encodes every block of a flush.  All backends are bit-identical (the
    kernel's u32 arithmetic is the mod-2^32 wrap of the reference)."""
    if segment < 0:
        raise ValueError(f"segment must be >= 0, got {segment}")
    u = _as_u32(flat)
    if u.size == 0:
        return np.empty((0,), np.uint32)
    eff = resolve(backend, u.size)
    if eff == "python":
        return _delta_zigzag_py(u, segment)
    if eff in ("torch", "cuda"):
        return _delta_zigzag_torch(u, eff, segment)
    return _delta_zigzag_np(u, segment)


# ---------------------------------------------------------------------------
# varint packing (u64-guarded; see encoding.pack_uvarints)
# ---------------------------------------------------------------------------


def _emit_varint_bytes(lens: np.ndarray, planes: np.ndarray) -> bytes:
    """Scatter per-element byte planes into the packed varint stream.

    ``planes`` is (n_planes, n): plane j holds byte j of every element with
    its continuation bit already set; ``lens`` the per-element byte counts.
    The exclusive-scan offsets + masked scatter are the host half of the
    two-pass byte-emit of the ``numpy`` packer and the fused tick encode
    (``delta_zigzag_varint`` produces lens/planes, shapes static)."""
    lens = np.asarray(lens, np.int64)
    n = len(lens)
    n_planes = planes.shape[0]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    out = np.zeros(int(offs[-1]), np.uint8)
    starts = offs[:-1]
    for j in range(n_planes):       # plane-major: <= 10 vector scatters
        sel = lens > j
        if not sel.any():
            break
        out[starts[sel] + j] = planes[j][sel].astype(np.uint8, copy=False)
    return out.tobytes()


def _uvarint_planes_np(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(lens, planes) of a u64 value array -- the NumPy mirror of the
    kernel's per-element varint pass."""
    n = v.size
    lens = np.ones(n, np.int64)
    for k in range(1, 10):
        lens += (v >= np.uint64(1 << (7 * k))).astype(np.int64)
    shifts = np.uint64(7) * np.arange(10, dtype=np.uint64)
    b = ((v[None, :] >> shifts[:, None]) & np.uint64(0x7F)).astype(np.uint8)
    cont = np.arange(10, dtype=np.int64)[:, None] < (lens - 1)[None, :]
    return lens, np.where(cont, b | 0x80, b)


def _to_u64(values: Sequence[int]) -> np.ndarray:
    try:
        return np.asarray(values, dtype=np.uint64)
    except (OverflowError, ValueError, TypeError) as e:
        raise VarintRangeError(
            f"uvarint batch contains a value outside [0, 2^64): {e}"
        ) from None


def pack_uvarints_batch(values: Sequence[int], backend: str) -> bytes:
    """Batched uvarint packing, byte-identical to the ``write_uvarint``
    loop; values outside u64 raise :class:`encoding.VarintRangeError` on
    the host, before anything reaches a kernel (arbitrary-precision ints
    keep their own tagged path through ``encode_value``).  ``torch`` and
    ``cuda`` call the ``uvarint_pack64`` wrapper: on the card one launch
    packs the bytes, and only those come back; ``numpy`` scatters byte
    planes on the host."""
    v = _to_u64(values)
    if v.size == 0:
        return b""
    if backend in ("torch", "cuda"):
        packed = _de.uvarint_pack64(_to_device(v.view(np.int64), backend))
        return packed.cpu().numpy().tobytes()
    return _emit_varint_bytes(*_uvarint_planes_np(v))


# ---------------------------------------------------------------------------
# fused tick encode: delta -> zigzag -> varint bytes
# ---------------------------------------------------------------------------


def _encode_ticks_varint_py(flat: np.ndarray) -> bytes:
    out = bytearray()
    prev = 0
    for i, t in enumerate(flat.tolist()):
        d = t if i == 0 else t - prev
        prev = t
        d = ((d + (1 << 31)) % (1 << 32)) - (1 << 31)
        write_uvarint(out, ((d << 1) ^ (d >> 63)) & 0xFFFFFFFF)
    return bytes(out)


def encode_ticks_varint(ticks: np.ndarray, backend: Optional[str] = None
                        ) -> bytes:
    """Fused delta -> zigzag -> varint byte-emit over a tick array.

    The variable-length stream is ~35-45% smaller than the fixed ``<u4``
    layout before zlib; the trace format keeps the fixed layout for
    byte-compat, so this op serves the benchmark sweep and future compact
    segment layouts.  All backends are byte-identical; ``torch``/``cuda``
    run the ``delta_zigzag_varint`` wrapper and scatter its planes on the
    host."""
    flat = np.asarray(ticks).reshape(-1).astype(np.int64)
    if flat.size == 0:
        return b""
    eff = resolve(backend, flat.size)
    if eff == "python":
        return _encode_ticks_varint_py(flat)
    if eff in ("torch", "cuda"):
        x = _to_device(flat.astype(np.uint32).view(np.int32), eff)
        _zz, lens, planes = _de.delta_zigzag_varint(x)
        return _emit_varint_bytes(lens.cpu().numpy().astype(np.int64),
                                  planes.cpu().numpy())
    zz = _delta_zigzag_np(_as_u32(flat), 0).astype(np.uint64)
    lens, planes = _uvarint_planes_np(zz)
    return _emit_varint_bytes(lens, planes[:5])


# ---------------------------------------------------------------------------
# arithmetic-run boundaries (arith_segments / Sequitur RLE pre-tokenization)
# ---------------------------------------------------------------------------


def _run_boundaries_py(V: np.ndarray) -> np.ndarray:
    rows = V.tolist()
    mask = np.zeros(len(rows), bool)
    mask[0] = True
    for i in range(1, len(rows)):
        mask[i] = rows[i] != rows[i - 1]
    return mask


def run_boundaries(V: np.ndarray, backend: Optional[str] = None
                   ) -> np.ndarray:
    """Row-change mask of a (n, k) matrix: ``mask[i]`` iff row i differs
    from row i-1 (``mask[0]`` always True).  The shared building block of
    ``interprocess.arith_segments`` (over row diffs) and
    ``Sequitur.push_stream`` (over the raw terminal column), which call
    :func:`run_starts`; its ``cuda`` path stays the ``row_boundaries``
    kernel's."""
    V = np.asarray(V)
    if V.ndim == 1:
        V = V[:, None]
    n = V.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    eff = resolve(backend, V.size)
    if eff == "python":
        return _run_boundaries_py(V)
    if eff in ("torch", "cuda"):
        mask = _gs.row_boundaries(_to_device(V.astype(np.int64, copy=False),
                                             eff))
        return mask.cpu().numpy()
    mask = np.empty(n, bool)
    mask[0] = True
    if n > 1:
        mask[1:] = (V[1:] != V[:-1]).any(axis=1)
    return mask


def run_starts(V: np.ndarray, backend: Optional[str] = None,
               diff: bool = False) -> np.ndarray:
    """int64 indices of the rows of a (n, k) matrix that start a run: 0
    and every i whose row differs from row i-1 -- ``flatnonzero`` of
    :func:`run_boundaries`.  With ``diff`` the rows are those of the first
    difference ``V[1:] - V[:-1]`` (n - 1 of them).  ``Sequitur.push_stream``
    takes the starts of the terminal column, ``interprocess.arith_segments``
    those of the diff rows.  ``torch``/``cuda`` call the ``row_run_starts``
    wrapper, which takes the difference and compacts the starts on the
    card; ``numpy`` and ``python`` difference and scan on the host."""
    V = np.asarray(V)
    if V.ndim == 1:
        V = V[:, None]
    rows = V.shape[0] - int(diff)
    if rows <= 0:
        return np.zeros(0, np.int64)
    eff = resolve(backend, rows * V.shape[1])
    if eff in ("torch", "cuda"):
        starts = _gs.row_run_starts(_to_device(V.astype(np.int64,
                                                        copy=False), eff),
                                    diff)
        return starts.cpu().numpy()
    if diff:
        V = V[1:] - V[:-1]
    return np.flatnonzero(run_boundaries(V, eff))


# ---------------------------------------------------------------------------
# rank-linear column classification (interprocess.batch_fit_columns)
# ---------------------------------------------------------------------------


def fit_classify(V: np.ndarray, backend: Optional[str] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column (const_mask, linear_mask, first_diff) of a (C, R) int64
    value matrix with R >= 2 -- the vectorized core of the rank-linear
    fitter.  The ``torch``/``cuda`` paths run one ``fit_columns`` call over
    the whole int64 matrix; on ``cuda`` the matrix goes to the card through
    pinned memory and the packed result comes back in one copy."""
    if backend in ("torch", "cuda"):
        t = torch.from_numpy(np.ascontiguousarray(V, dtype=np.int64))
        if backend == "cuda":
            require_device(backend)
            t = t.pin_memory().to("cuda", non_blocking=True)
        flags, d0 = _de.fit_to_host(*_de.fit_columns(t))
        return flags == 1, flags == 2, d0
    d = V[:, 1:] - V[:, :-1]
    const = (d == 0).all(axis=1)
    linear = (d == d[:, :1]).all(axis=1) & (d[:, 0] != 0)
    return const, linear, d[:, 0]


# ---------------------------------------------------------------------------
# symbol-stream statistics (Sequitur / TraceView digram profiles)
# ---------------------------------------------------------------------------


def terminal_histogram(stream: np.ndarray, n_bins: int,
                       backend: Optional[str] = None) -> np.ndarray:
    """Occurrence counts of terminals ``0..n_bins-1`` over a symbol
    stream; values outside that range are ignored.  ``torch``/``cuda``
    run the ``histogram`` wrapper over the int64 stream."""
    stream = np.asarray(stream, np.int64).reshape(-1)
    if stream.size == 0:
        return np.zeros(n_bins, np.int64)
    eff = resolve(backend, stream.size)
    if eff in ("torch", "cuda"):
        return _gs.histogram(_to_device(stream, eff), n_bins).cpu().numpy()
    if eff == "python":
        out = np.zeros(n_bins, np.int64)
        for t in stream.tolist():
            if 0 <= t < n_bins:
                out[t] += 1
        return out
    return np.bincount(stream[(stream >= 0) & (stream < n_bins)],
                       minlength=n_bins)[:n_bins].astype(np.int64)


def digram_histogram(stream: np.ndarray, n_terminals: int,
                     backend: Optional[str] = None) -> Dict[Tuple[int, int],
                                                            int]:
    """Directly-follows (digram) counts over a terminal stream.

    ``torch``/``cuda`` call the ``digram_counts`` wrapper, which counts
    the int64 pair codes ``a * n_terminals + b`` on the card and returns
    only the m distinct codes and their counts, in code order; the host
    builds the dict from those m pairs.  Unlike the ``numpy`` path's
    bincount, whose table would need ``n_terminals^2`` entries --
    terabytes once the codes pass 2^31 -- it takes any T, and it raises
    on a terminal outside [0, n_terminals).  Backends agree exactly, and
    ``numpy``, ``torch`` and ``cuda`` give the keys in the same (code)
    order."""
    stream = np.asarray(stream, np.int64).reshape(-1)
    if stream.size < 2:
        return {}
    eff = resolve(backend, stream.size)
    if eff == "python":
        counts: Dict[Tuple[int, int], int] = {}
        prev = None
        for t in stream.tolist():
            if prev is not None:
                k = (prev, t)
                counts[k] = counts.get(k, 0) + 1
            prev = t
        return counts
    if eff in ("torch", "cuda"):
        codes, counts = _gs.digram_counts(_to_device(stream, eff),
                                          n_terminals)
        return {(c // n_terminals, c % n_terminals): k
                for c, k in zip(codes.tolist(), counts.tolist())}
    codes = stream[:-1] * n_terminals + stream[1:]
    hist = np.bincount(codes)
    nz = np.flatnonzero(hist)
    return {(int(c) // n_terminals, int(c) % n_terminals): int(hist[c])
            for c in nz}
