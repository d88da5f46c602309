"""Wrappers of the delta_encode CUDA kernels (``csrc/delta_encode.cu``).

Each wrapper checks its input, runs the plain PyTorch version (``ref.py``)
when the tensor lies on the CPU, and otherwise allocates its outputs with
``torch.empty`` and launches the kernel on the current stream -- there is
no fallback for a CUDA tensor: the kernel runs or the call raises.

Each kernel replaces a Pallas kernel of the JAX package's
``kernels/delta_encode/delta_encode.py``:

- ``delta_zigzag``: ``delta_zigzag_pallas`` (:40)
- ``uvarint_encode64``: ``uvarint_encode64_pallas`` (:155)
- ``fit_columns``: ``fit_columns_pallas`` (:202)

All three are bound by bytes moved, and at the tracer's sizes by launch
latency and host<->device copies (see ``PERF.md``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import _build
from .ref import delta_zigzag_ref, fit_columns_ref, uvarint_encode64_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "delta_zigzag": [_P, _P, _I, _P],
    "uvarint_encode64": [_P, _P, _P, _I, _P],
    "fit_columns": [_P, _P, _P, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    return _build.library("delta_encode", _SIGNATURES)


def delta_zigzag(ticks: torch.Tensor) -> torch.Tensor:
    """Flat u32 ticks as int32 bit patterns, shape (n,) -> zigzag'd
    first-order deltas (mod 2^32) as int32 bit patterns, shape (n,)."""
    _build.check(ticks, "ticks", torch.int32, 1)
    if ticks.device.type == "cpu":
        return delta_zigzag_ref(ticks)
    out = torch.empty_like(ticks)
    n = ticks.numel()
    if n:
        _build.launch(_lib(), "delta_zigzag", ticks.device,
                      _build.ptr(ticks), _build.ptr(out), n)
    return out


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
