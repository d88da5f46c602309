"""Wrappers of the grammar_stats CUDA kernels (``csrc/grammar_stats.cu``).

Each wrapper checks its input, runs the plain PyTorch version (``ref.py``)
when the tensor lies on the CPU, and otherwise allocates its outputs with
``torch.empty``/``torch.zeros`` and launches the kernel on the current
stream -- there is no fallback for a CUDA tensor: the kernel runs or the
call raises.

Each kernel replaces a Pallas kernel of the JAX package's
``kernels/grammar_stats/grammar_stats.py``:

- ``row_boundaries``: ``row_boundaries_pallas`` (:48)
- ``histogram``: ``histogram_pallas`` (:79)
- ``digram_codes``: ``digram_codes_pallas`` (:113)

All three are bound by bytes moved, and at the tracer's sizes by launch
latency and host<->device copies (see ``PERF.md``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import digram_codes_ref, histogram_ref, row_boundaries_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "row_boundaries": [_P, _P, _I, _I, _P],
    "histogram": [_P, _P, _I, _I, _P],
    "digram_codes": [_P, _P, _I, _I, _P],
}


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


def histogram(stream: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int64 stream (n,) -> int64 counts (n_bins,) of the values in
    [0, n_bins); negative and larger values are ignored."""
    _build.check(stream, "stream", torch.int64, 1)
    n_bins = int(n_bins)
    if n_bins < 0:
        raise ValueError(f"histogram needs n_bins >= 0, got {n_bins}")
    if stream.device.type == "cpu":
        return histogram_ref(stream, n_bins)
    out = torch.zeros(n_bins, dtype=torch.int64, device=stream.device)
    n = stream.numel()
    if n and n_bins:
        _build.launch(_lib(), "histogram", stream.device, _build.ptr(stream),
                      _build.ptr(out), n, n_bins)
    return out


def digram_codes(stream: torch.Tensor, n_terminals: int) -> torch.Tensor:
    """int64 terminal stream (n,) -> int64 pair codes
    ``stream[i-1] * n_terminals + stream[i]`` (n,), -1 at position 0.
    int64 codes need no ``T * (T + 1) < 2^31`` guard."""
    _build.check(stream, "stream", torch.int64, 1)
    n_terminals = int(n_terminals)
    if n_terminals < 1:
        raise ValueError(f"digram_codes needs n_terminals >= 1, "
                         f"got {n_terminals}")
    if stream.device.type == "cpu":
        return digram_codes_ref(stream, n_terminals)
    out = torch.empty_like(stream)
    n = stream.numel()
    if n:
        _build.launch(_lib(), "digram_codes", stream.device,
                      _build.ptr(stream), _build.ptr(out), n, n_terminals)
    return out
