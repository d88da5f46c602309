"""Wrapper of the RMSNorm CUDA kernel (``csrc/rmsnorm.cu``).

``rmsnorm`` replaces ``rmsnorm_pallas`` of the JAX package
(``kernels/rmsnorm/rmsnorm.py:25``): ``x * rsqrt(mean(x^2) + eps) * w``
over the last dimension, statistics in f32, one cast to ``x.dtype``.  It
checks its inputs, runs the plain PyTorch version (``ref.py``) when they
lie on the CPU, and otherwise launches the kernel on the current stream
-- there is no fallback for CUDA tensors: the kernel runs or the call
raises.

The kernel is bound by bytes moved: each element is read once and written
once (at the serving path's prefill q, 262,144 x 128 bf16 rows, 134 MB,
40 us at 3.35 TB/s).  It runs one warp per row, so any row count works,
with 16-byte loads when the row allows them (see ``PERF.md``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rmsnorm_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"rmsnorm": [_P, _P, _P, _I, _I, ctypes.c_float, _I, _P]}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    return _build.library("rmsnorm", _SIGNATURES)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """x (..., d) float32 or bfloat16, contiguous; w (d,) float32 ->
    the normalised x, same shape and dtype."""
    if not isinstance(x, torch.Tensor) or not isinstance(w, torch.Tensor):
        raise TypeError("rmsnorm takes torch.Tensor inputs")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must have a last dimension >= 1, got shape "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    _build.check(w, "w", torch.float32, 1)
    if w.shape[0] != d:
        raise ValueError(f"w has {w.shape[0]} entries, x rows have {d}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x ({x.device}) and w ({w.device}) must lie on "
                         f"the same CPU or CUDA device")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows:
        _build.launch(_lib(), "rmsnorm", x.device, _build.ptr(x),
                      _build.ptr(w), _build.ptr(out), rows, d,
                      ctypes.c_float(eps), DTYPE_CODES[x.dtype])
    return out


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`rmsnorm` as a PyTorch operator, the model's one path to the
    kernel: a sharded model calls it on each rank's shard (``local_map``),
    and under ``FakeTensorMode`` (the dry run) its fake version gives the
    shape without launching."""
    return rmsnorm(x, w, eps=eps)


@rmsnorm_op.register_fake
def _(x, w, eps):
    return torch.empty_like(x)
