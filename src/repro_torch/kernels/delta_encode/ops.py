"""Wrappers of the delta_encode CUDA kernels (``csrc/delta_encode.cu``).

Each wrapper checks its input, runs the plain PyTorch version (``ref.py``)
when the tensor lies on the CPU, and otherwise allocates its outputs with
``torch.empty`` and launches the kernel on the current stream -- there is
no fallback for a CUDA tensor: the kernel runs or the call raises.

Each kernel replaces a Pallas kernel of the JAX package's
``kernels/delta_encode/delta_encode.py``:

- ``delta_zigzag``: ``delta_zigzag_pallas`` (:40)
- ``delta_zigzag_varint``: ``delta_zigzag_varint_pallas`` (:100)
- ``uvarint_encode64``: ``uvarint_encode64_pallas`` (:155)
- ``uvarint_pack64``: the same function through to the packed byte
  stream, which is what the encode path needs; it launches this one
- ``fit_columns``: ``fit_columns_pallas`` (:202)

All of them are bound by bytes moved, and at the tracer's sizes by launch
latency and host<->device copies (see ``PERF.md``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build
from .ref import (delta_zigzag_ref, delta_zigzag_varint_ref, fit_columns_ref,
                  uvarint_encode64_ref, uvarint_pack64_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int64
# values a block of uvarint_pack64 takes (kPackTile); the kernel refuses a
# status buffer too short for its tiles
PACK_TILE = 1024
_SIGNATURES = {
    "delta_zigzag": [_P, _P, _I, _I, _P],
    "delta_zigzag_varint": [_P, _P, _P, _P, _I, _P],
    "uvarint_encode64": [_P, _P, _P, _I, _P],
    "uvarint_pack64": [_P, _P, _P, _I, _I, _P],
    "fit_columns": [_P, _P, _P, _I, _I, _I, _P],
    "fit_columns_plan": [_I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    return _build.library("delta_encode", _SIGNATURES)


# (device index, raw stream) -> the zeroed int32 scratch fit_columns
# combines a row's spans in; every launch leaves it zeroed, and launches
# on one stream run in turn, so one a stream is kept.  A caller holds the
# tensor it was given until its launch is enqueued: a block the dict
# drops for a larger one goes back to the allocator for this stream only
# then, after the launch in stream order
_fit_scratch_lock = threading.Lock()
_fit_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _scratch_for(device: torch.device, c: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(device)
    key = (stream.device.index, stream.cuda_stream)
    with _fit_scratch_lock:
        t = _fit_scratch.get(key)
        if t is None or t.numel() < 2 * c:
            t = _fit_scratch[key] = torch.zeros(
                max(2 * c, 1024), dtype=torch.int32, device=device)
        return t


def delta_zigzag(ticks: torch.Tensor, segment: int = 0) -> torch.Tensor:
    """Flat u32 ticks as int32 bit patterns, shape (n,) -> zigzag'd
    first-order deltas (mod 2^32) as int32 bit patterns, shape (n,).
    Element i is taken against 0 where ``i % segment == 0`` (``segment``
    0: only element 0), so one call encodes ``n / segment`` independent
    blocks."""
    _build.check(ticks, "ticks", torch.int32, 1)
    if segment < 0:
        raise ValueError(f"segment must be >= 0, got {segment}")
    if ticks.device.type == "cpu":
        return delta_zigzag_ref(ticks, segment)
    out = torch.empty_like(ticks)
    n = ticks.numel()
    if n:
        _build.launch(_lib(), "delta_zigzag", ticks.device,
                      _build.ptr(ticks), _build.ptr(out), n, segment)
    return out


def delta_zigzag_varint(ticks: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat u32 ticks as int32 bit patterns, shape (n,) -> (zigzag'd deltas
    as int32 bit patterns (n,), int32 varint byte counts (n,), uint8 byte
    planes (5, n)) for the host varint scatter."""
    _build.check(ticks, "ticks", torch.int32, 1)
    if ticks.device.type == "cpu":
        return delta_zigzag_varint_ref(ticks)
    n = ticks.numel()
    zz = torch.empty_like(ticks)
    lens = torch.empty(n, dtype=torch.int32, device=ticks.device)
    planes = torch.empty((5, n), dtype=torch.uint8, device=ticks.device)
    if n:
        _build.launch(_lib(), "delta_zigzag_varint", ticks.device,
                      _build.ptr(ticks), _build.ptr(zz), _build.ptr(lens),
                      _build.ptr(planes), n)
    return zz, lens, planes


def uvarint_encode64(values: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u64 values as int64 bit patterns, shape (n,) -> (int32 byte counts
    (n,), uint8 byte planes (10, n)) for the host varint scatter."""
    _build.check(values, "values", torch.int64, 1)
    if values.device.type == "cpu":
        return uvarint_encode64_ref(values)
    n = values.numel()
    lens = torch.empty(n, dtype=torch.int32, device=values.device)
    planes = torch.empty((10, n), dtype=torch.uint8, device=values.device)
    if n:
        _build.launch(_lib(), "uvarint_encode64", values.device,
                      _build.ptr(values), _build.ptr(lens),
                      _build.ptr(planes), n)
    return lens, planes


def uvarint_pack64(values: torch.Tensor) -> torch.Tensor:
    """u64 values as int64 bit patterns, shape (n,) -> their uvarints
    packed end to end, uint8 (total,), on the values' device.  On the card
    one launch writes the bytes into a worst-case buffer of 10 n and the
    total into a status word; the result is the ``[:total]`` view (reading
    the total synchronises with the launch)."""
    _build.check(values, "values", torch.int64, 1)
    if values.device.type == "cpu":
        return uvarint_pack64_ref(values)
    n = values.numel()
    if not n:
        return torch.empty(0, dtype=torch.uint8, device=values.device)
    out = torch.empty(10 * n, dtype=torch.uint8, device=values.device)
    # the tile counter, the total, then one look-back word per tile
    status = torch.zeros(2 + -(-n // PACK_TILE), dtype=torch.int64,
                         device=values.device)
    _build.launch(_lib(), "uvarint_pack64", values.device,
                  _build.ptr(values), _build.ptr(out), _build.ptr(status),
                  status.numel(), n)
    return out[:int(status[1])]


def packed_words(c: int) -> int:
    """int64 words of ``fit_columns``' packed output for C columns."""
    return c + (c + 1) // 2


def split_fit(packed: torch.Tensor, c: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed int64 output of ``fit_columns`` (``packed_words(c)``
    words) -> (int32 flags (c,), int64 first deltas (c,)), both views of
    it: the deltas are words [0, c), the flags the int32 after them."""
    return packed.view(torch.int32)[2 * c:3 * c], packed[:c]


def fit_columns(V: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, R) int64 matrix with R >= 2, rows at any stride and values at
    stride 1 -> (int32 flags (C,), int64 first deltas (C,)); flag 1 =
    constant, 2 = rank-linear, 0 = no fit.  Both are views of one packed
    tensor (:func:`split_fit`), so :func:`fit_to_host` brings them to the
    host in one copy."""
    _build.check(V, "V", torch.int64, 2, rows=True)
    c, r = V.shape
    if r < 2:
        raise ValueError(f"fit_columns needs R >= 2 columns, got {r}")
    packed = torch.empty(packed_words(c), dtype=torch.int64,
                         device=V.device)
    flags, d0 = split_fit(packed, c)
    if V.device.type == "cpu":
        want_flags, want_d0 = fit_columns_ref(V)
        flags.copy_(want_flags)
        d0.copy_(want_d0)
    elif c:
        scratch = _scratch_for(V.device, c)
        _build.launch(_lib(), "fit_columns", V.device, _build.ptr(V),
                      _build.ptr(packed), _build.ptr(scratch), c, r,
                      V.stride(0) if c > 1 else r)
    return flags, d0


def fit_plan(c: int, r: int, device: torch.device) -> Tuple[str, int, int]:
    """How ``fit_columns`` splits a (C, R) matrix on ``device``: (``"rows"``
    or ``"tiles"``, the ranks a rows thread loads at a time or a tiles
    warp's span, the spans a row)."""
    plan = torch.zeros(3, dtype=torch.int64)
    with torch.cuda.device(device):
        err = _lib().fit_columns_plan(c, r, _build.ptr(plan))
    if err != 0:
        raise RuntimeError(f"fit_columns_plan failed: error {err}")
    route, span, nspans = plan.tolist()
    return ("rows" if route == 0 else "tiles"), span, nspans


def fit_to_host(flags: torch.Tensor, d0: torch.Tensor
                ) -> Tuple[np.ndarray, np.ndarray]:
    """``fit_columns``' outputs as numpy arrays on the host: from the card,
    one D2H copy of the packed tensor they are views of."""
    c = d0.numel()
    packed = d0 if d0._base is None else d0._base
    if (packed.dtype != torch.int64 or packed.shape != (packed_words(c),)
            or d0.data_ptr() != packed.data_ptr()
            or flags.data_ptr() != packed.data_ptr() + 8 * c):
        raise ValueError("flags and d0 are not the views fit_columns gave")
    host = packed.cpu().numpy()
    return host[c:].view(np.int32)[:c], host[:c]
