"""Backend dispatch for the batched encode/fit hot paths.

The arithmetic-dense stages of the tracing pipeline -- timestamp
delta+zigzag, varint packing, arithmetic-run boundary detection and
rank-linear column fitting -- exist in interchangeable implementations:

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
    int64, so values at or above 2^31 stay on the card too.

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

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.delta_encode import ops as _de
from ..kernels.grammar_stats import ops as _gs
from .encoding import VarintRangeError

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


def _delta_zigzag_py(flat: np.ndarray) -> np.ndarray:
    """Scalar reference: first-order delta wrapped mod 2^32 -> zigzag u32."""
    out = np.empty(len(flat), np.uint32)
    prev = 0
    for i, v in enumerate(flat.tolist()):
        d = v if i == 0 else v - prev
        prev = v
        d = ((d + (1 << 31)) % (1 << 32)) - (1 << 31)
        out[i] = ((d << 1) ^ (d >> 63)) & 0xFFFFFFFF
    return out


def _delta_zigzag_np(flat: np.ndarray) -> np.ndarray:
    flat = flat.astype(np.int64)        # wrap arithmetic needs headroom
    deltas = np.empty_like(flat)
    deltas[0] = flat[0]
    deltas[1:] = flat[1:] - flat[:-1]
    deltas = ((deltas + (1 << 31)) % (1 << 32)) - (1 << 31)
    zz = (deltas << 1) ^ (deltas >> 63)
    return (zz & 0xFFFFFFFF).astype(np.uint32)


def _delta_zigzag_torch(flat: np.ndarray, backend: str) -> np.ndarray:
    x = _to_device(flat.astype(np.uint32).view(np.int32), backend)
    return _de.delta_zigzag(x).cpu().numpy().view(np.uint32)


def delta_zigzag(flat: np.ndarray, backend: Optional[str] = None
                 ) -> np.ndarray:
    """Flat int64 tick stream -> zigzag'd u32 deltas, backend-dispatched.
    All backends are bit-identical (the kernel's u32 arithmetic is the
    mod-2^32 wrap of the reference)."""
    if flat.size == 0:
        return np.empty((0,), np.uint32)
    eff = resolve(backend, flat.size)
    if eff == "python":
        return _delta_zigzag_py(flat)
    if eff in ("torch", "cuda"):
        return _delta_zigzag_torch(flat, eff)
    return _delta_zigzag_np(flat)


# ---------------------------------------------------------------------------
# varint packing (u64-guarded; see encoding.pack_uvarints)
# ---------------------------------------------------------------------------


def _emit_varint_bytes(lens: np.ndarray, planes: np.ndarray) -> bytes:
    """Scatter per-element byte planes into the packed varint stream.

    ``planes`` is (n_planes, n): plane j holds byte j of every element with
    its continuation bit already set; ``lens`` the per-element byte counts.
    The exclusive-scan offsets + masked scatter are the host half of the
    two-pass byte-emit (the kernels produce lens/planes, shapes static)."""
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


def _uvarint_planes_torch(v: np.ndarray, backend: str
                          ) -> Tuple[np.ndarray, np.ndarray]:
    lens, planes = _de.uvarint_encode64(_to_device(v.view(np.int64),
                                                   backend))
    return lens.cpu().numpy().astype(np.int64), planes.cpu().numpy()


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
    keep their own tagged path through ``encode_value``)."""
    v = _to_u64(values)
    if v.size == 0:
        return b""
    if backend in ("torch", "cuda"):
        lens, planes = _uvarint_planes_torch(v, backend)
    else:
        lens, planes = _uvarint_planes_np(v)
    return _emit_varint_bytes(lens, planes)


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
    ``Sequitur.push_stream`` (over the raw terminal column)."""
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


# ---------------------------------------------------------------------------
# rank-linear column classification (interprocess.batch_fit_columns)
# ---------------------------------------------------------------------------


def fit_classify(V: np.ndarray, backend: Optional[str] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column (const_mask, linear_mask, first_diff) of a (C, R) int64
    value matrix with R >= 2 -- the vectorized core of the rank-linear
    fitter.  The ``torch``/``cuda`` paths run one ``fit_columns`` call over
    the whole int64 matrix."""
    if backend in ("torch", "cuda"):
        flags, d0 = _de.fit_columns(_to_device(V.astype(np.int64,
                                                        copy=False),
                                               backend))
        flags = flags.cpu().numpy()
        return flags == 1, flags == 2, d0.cpu().numpy()
    d = V[:, 1:] - V[:, :-1]
    const = (d == 0).all(axis=1)
    linear = (d == d[:, :1]).all(axis=1) & (d[:, 0] != 0)
    return const, linear, d[:, 0]
