"""Wrapper of the grammar_stats CUDA kernel (``csrc/grammar_stats.cu``).

``row_boundaries`` replaces ``row_boundaries_pallas``
(grammar_stats.py:48 of the JAX package).  It is bound by bytes moved,
and at the tracer's sizes by launch latency and host<->device copies.
A CPU tensor runs the plain PyTorch version (``ref.py``); a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import row_boundaries_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"row_boundaries": [_P, _P, _I, _I, _P]}


def _lib() -> ctypes.CDLL:
    return _build.library("grammar_stats", _SIGNATURES)


def row_boundaries(V: torch.Tensor) -> torch.Tensor:
    """(n, k) int64 matrix, k >= 1 -> bool mask (n,): True where row i
    differs from row i-1 (row 0 always True)."""
    _build.check(V, "V", torch.int64, 2)
    n, k = V.shape
    if k < 1:
        raise ValueError("row_boundaries needs k >= 1 columns")
    if V.device.type == "cpu":
        return row_boundaries_ref(V)
    out = torch.empty(n, dtype=torch.bool, device=V.device)
    if n:
        _build.launch(_lib(), "row_boundaries", V.device, _build.ptr(V),
                      _build.ptr(out), n, k)
    return out
