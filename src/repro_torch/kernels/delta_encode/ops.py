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
from typing import Tuple

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
    "fit_columns": [_P, _P, _P, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    return _build.library("delta_encode", _SIGNATURES)


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


def fit_columns(V: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, R) int64 matrix with R >= 2 -> (int32 flags (C,), int64 first
    deltas (C,)); flag 1 = constant, 2 = rank-linear, 0 = no fit."""
    _build.check(V, "V", torch.int64, 2)
    c, r = V.shape
    if r < 2:
        raise ValueError(f"fit_columns needs R >= 2 columns, got {r}")
    if V.device.type == "cpu":
        return fit_columns_ref(V)
    flags = torch.empty(c, dtype=torch.int32, device=V.device)
    d0 = torch.empty(c, dtype=torch.int64, device=V.device)
    if c:
        _build.launch(_lib(), "fit_columns", V.device, _build.ptr(V),
                      _build.ptr(flags), _build.ptr(d0), c, r)
    return flags, d0
