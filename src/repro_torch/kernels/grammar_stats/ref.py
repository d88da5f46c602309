"""Plain PyTorch version of the grammar_stats kernel."""

from __future__ import annotations

import torch


def row_boundaries_ref(V: torch.Tensor) -> torch.Tensor:
    """(n, k) int64 matrix -> bool mask (n,), True where row i differs from
    row i-1; row 0 is always True."""
    mask = torch.ones(V.shape[0], dtype=torch.bool, device=V.device)
    if V.shape[0] > 1:
        mask[1:] = (V[1:] != V[:-1]).any(dim=1)
    return mask
