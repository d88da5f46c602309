"""Plain PyTorch version of the RMSNorm kernel.

The wrapper in ``ops.py`` runs it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5
                ) -> torch.Tensor:
    """x (..., d) -> ``x * rsqrt(mean(x^2) + eps) * w`` with f32
    statistics and one cast back to ``x.dtype`` at the end."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
