"""Plain PyTorch versions of the grammar_stats kernels.

The wrappers in ``ops.py`` run these for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""

from __future__ import annotations

from typing import Tuple

import torch


def row_boundaries_ref(V: torch.Tensor) -> torch.Tensor:
    """(n, k) int64 matrix -> bool mask (n,), True where row i differs from
    row i-1; row 0 is always True."""
    mask = torch.ones(V.shape[0], dtype=torch.bool, device=V.device)
    if V.shape[0] > 1:
        mask[1:] = (V[1:] != V[:-1]).any(dim=1)
    return mask


def histogram_ref(stream: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int64 stream (n,) -> int64 counts (n_bins,) of the values in
    [0, n_bins); other values are ignored."""
    keep = stream[(stream >= 0) & (stream < n_bins)]
    return torch.bincount(keep, minlength=n_bins)[:n_bins]


def digram_codes_ref(stream: torch.Tensor, n_terminals: int) -> torch.Tensor:
    """int64 terminal stream (n,) -> int64 pair codes
    ``stream[i-1] * n_terminals + stream[i]`` (n,); position 0 is -1."""
    out = torch.empty_like(stream)
    if stream.numel():
        out[0] = -1
        out[1:] = stream[:-1] * n_terminals + stream[1:]
    return out


def digram_counts_ref(stream: torch.Tensor, n_terminals: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 terminal stream (n,) with values in [0, n_terminals) ->
    (codes, counts): the distinct pair codes ``stream[i-1] * n_terminals
    + stream[i]`` (i >= 1) in increasing order, int64 (m,), and how often
    each occurs, int64 (m,).  A value outside the range raises."""
    if stream.numel() and bool(((stream < 0)
                                | (stream >= n_terminals)).any()):
        raise ValueError(f"terminal stream holds a value outside "
                         f"[0, {n_terminals})")
    codes = stream[:-1] * n_terminals + stream[1:]
    return torch.unique(codes, sorted=True, return_counts=True)


def row_run_starts_ref(V: torch.Tensor, diff: bool = False) -> torch.Tensor:
    """(n, k) int64 matrix -> int64 indices of the rows that start a run:
    0 and every i whose row differs from row i-1.  With ``diff`` the rows
    are those of the first difference ``V[1:] - V[:-1]`` (n - 1 of them;
    int64 subtraction wraps as NumPy's does)."""
    if diff:
        V = V[1:] - V[:-1]
    return torch.nonzero(row_boundaries_ref(V)).reshape(-1)
