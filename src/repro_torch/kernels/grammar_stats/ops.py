"""Wrappers of the grammar_stats CUDA kernels (``csrc/grammar_stats.cu``).

Each wrapper checks its input, runs the plain PyTorch version (``ref.py``)
when the tensor lies on the CPU, and otherwise allocates its outputs with
``torch.empty``/``torch.zeros`` and launches the kernel on the current
stream -- there is no fallback for a CUDA tensor: the kernel runs or the
call raises.

Each kernel replaces a Pallas kernel of the JAX package's
``kernels/grammar_stats/grammar_stats.py``:

- ``row_boundaries``: ``row_boundaries_pallas`` (:48)
- ``row_run_starts``: the same function through to the indices of the
  rows that start a run, optionally over the rows' first difference; the
  encode path launches this one
- ``histogram``: ``histogram_pallas`` (:79)
- ``digram_codes``: ``digram_codes_pallas`` (:113)
- ``digram_counts``: the same function through to the distinct pair codes
  and their counts; the read side launches this one

All of them are bound by bytes moved, and at the tracer's sizes by launch
latency and host<->device copies (see ``PERF.md``), so the two that the
main path launches return only their short results: each reads its status
words back once, the one wait for the card a call makes.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from .. import _build
from .ref import (digram_codes_ref, digram_counts_ref, histogram_ref,
                  row_boundaries_ref, row_run_starts_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "row_boundaries": [_P, _P, _I, _I, _P],
    "row_run_starts": [_P, _I, _I, _I, _P, _I, _P, _P],
    "histogram": [_P, _P, _I, _I, _P],
    "digram_codes": [_P, _P, _I, _I, _P],
    "digram_counts": [_P, _I, _I, _P, _P, _P, _P],
    "digram_dense_max_t": [ctypes.POINTER(ctypes.c_int64)],
}
# rows a block of row_run_starts takes (kRunTile); the kernel refuses a
# status buffer too short for its tiles
RUN_TILE = 1024
# the largest T whose codes T^2 - 1 stay below 2^63
MAX_TERMINALS = 3037000499

_dense_lock = threading.Lock()
_dense_max_t: Dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    return _build.library("grammar_stats", _SIGNATURES)


def dense_max_terminals(device: torch.device) -> int:
    """The largest T whose T^2 counters fit in a block's opt-in shared
    memory on ``device`` (241 on the H100): ``digram_counts`` counts such
    streams in one launch, larger T through ``digram_codes`` and a sort."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _dense_lock:
        if index not in _dense_max_t:
            out = ctypes.c_int64(0)
            with torch.cuda.device(index):
                err = _lib().digram_dense_max_t(ctypes.byref(out))
            if err:
                raise RuntimeError(
                    f"digram_dense_max_t failed: error {err} "
                    f"({_lib().repro_error_string(err).decode()})")
            _dense_max_t[index] = out.value
        return _dense_max_t[index]


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


def row_run_starts(V: torch.Tensor, diff: bool = False) -> torch.Tensor:
    """(n, k) int64 matrix, k >= 1 -> int64 indices of the rows that start
    a run: 0 and every i whose row differs from row i-1.  With ``diff`` the
    rows compared are the first difference ``V[1:] - V[:-1]`` (wrapping
    int64, as NumPy's), n - 1 of them, so n >= 2.  On the card one launch
    writes the starts and their count; the result is the ``[:count]``
    view (reading the count synchronises with the launch)."""
    _build.check(V, "V", torch.int64, 2)
    n, k = V.shape
    if k < 1:
        raise ValueError("row_run_starts needs k >= 1 columns")
    if diff and n < 2:
        raise ValueError(f"row_run_starts(diff=True) needs n >= 2 rows, "
                         f"got {n}")
    if V.device.type == "cpu":
        return row_run_starts_ref(V, diff)
    rows = n - 1 if diff else n
    if not rows:
        return torch.empty(0, dtype=torch.int64, device=V.device)
    out = torch.empty(rows, dtype=torch.int64, device=V.device)
    # the tile counter, the count, then one look-back word per tile
    status = torch.zeros(2 + -(-rows // RUN_TILE), dtype=torch.int64,
                         device=V.device)
    _build.launch(_lib(), "row_run_starts", V.device, _build.ptr(V), n, k,
                  int(diff), _build.ptr(status), status.numel(),
                  _build.ptr(out))
    return out[:int(status[1])]


def digram_counts(stream: torch.Tensor, n_terminals: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 terminal stream (n,) with values in [0, n_terminals) ->
    ``(codes, counts)``, int64 (m,) each, on the stream's device: the
    distinct pair codes ``stream[i-1] * n_terminals + stream[i]`` (i >= 1)
    in increasing order, and how often each occurs.  A value outside the
    range raises ``ValueError``, on the card as on the CPU.

    On the card, T up to :func:`dense_max_terminals` counts in shared
    memory and compacts the counts in the same launch, then reads its
    status words back once (the wait for the card); it copies none of the
    n pair codes.  A larger T forms the codes with :func:`digram_codes`
    and counts them on the card with ``torch.unique``, after one read of
    the stream's least and greatest values for the range check."""
    _build.check(stream, "stream", torch.int64, 1)
    n_terminals = int(n_terminals)
    if not 1 <= n_terminals <= MAX_TERMINALS:
        raise ValueError(f"digram_counts needs 1 <= n_terminals <= "
                         f"{MAX_TERMINALS}, got {n_terminals}")
    if stream.device.type == "cpu":
        return digram_counts_ref(stream, n_terminals)
    dev = stream.device
    n = stream.numel()
    if not n:
        empty = torch.empty(0, dtype=torch.int64, device=dev)
        return empty, empty.clone()
    if n_terminals > dense_max_terminals(dev):
        lo, hi = torch.stack(torch.aminmax(stream)).tolist()
        if lo < 0 or hi >= n_terminals:
            raise ValueError(f"terminal stream holds a value outside "
                             f"[0, {n_terminals})")
        return torch.unique(digram_codes(stream, n_terminals)[1:],
                            sorted=True, return_counts=True)
    room = min(n - 1, n_terminals * n_terminals)
    codes = torch.empty(room, dtype=torch.int64, device=dev)
    counts = torch.empty(room, dtype=torch.int64, device=dev)
    # one zero fill: the status words (bad flag, blocks done, m), then the
    # T^2 counts
    scratch = torch.zeros(3 + n_terminals * n_terminals, dtype=torch.int64,
                          device=dev)
    _build.launch(_lib(), "digram_counts", dev, _build.ptr(stream), n,
                  n_terminals, _build.ptr(scratch), _build.ptr(scratch[3:]),
                  _build.ptr(codes), _build.ptr(counts))
    bad, _, m = scratch[:3].tolist()
    if bad:
        raise ValueError(f"terminal stream holds a value outside "
                         f"[0, {n_terminals})")
    return codes[:m], counts[:m]
