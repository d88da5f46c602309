"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention`` replaces ``flash_attention_pallas`` of the JAX package
(``kernels/flash_attention/flash_attention.py:72``) behind the same public
signature and layout as its ``ops.flash_attention``: q (B, Sq, H, D), k and
v (B, Skv, KVH, D), ``causal``, ``window``.  It checks its inputs, runs the
plain PyTorch version (``ref.py``) when they lie on the CPU, and otherwise
launches the kernel on the current stream -- there is no fallback for CUDA
tensors: the kernel runs or the call raises.  The kernels read q, k and v
through their strides, so no transposed copies are made.

The function is bound by compute (at the serving prefill, 68.8 GFLOP
against 151 MB moved).  bf16 runs on the tensor cores (wgmma), with q, k
and v loaded by the Tensor Memory Accelerator: their base addresses must
be 16-byte aligned and their strides multiples of 8 elements, which every
model call meets; anything else raises (no copy is made).  f32 keeps the
CUDA-core kernel, whose f32 sums hold the f32 tolerances.  Times are in
``PERF.md``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"flash_attention": [_P] * 4 + [_I] * 15
               + [ctypes.c_float, _I, _I, _I, _P]}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)


def _lib() -> ctypes.CDLL:
    return _build.library("flash_attention", _SIGNATURES)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must have 4 dimensions, got shape "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in D")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device) \
            or q.device.type not in ("cpu", "cuda"):
        raise ValueError("q, k and v must lie on one CPU or CUDA device")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"H={H} must be a multiple of KVH={k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported; one of {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_tma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless the bf16 kernel's tensor maps can address q, k, v:
    16-byte aligned bases, (B, S, H) strides in multiples of 16 bytes,
    Skv >= 1."""
    if k.shape[1] < 1:
        raise ValueError("k and v must hold at least one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{name} (strides {tuple(t.stride())}) must "
                             f"start on a 16-byte boundary with strides in "
                             f"multiples of 16 bytes for the bf16 kernel's "
                             f"TMA loads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D) -> (B, Sq, H, D), q's dtype
    (float32 or bfloat16).  ``window`` > 0: key j is visible to query i
    only when j > i - window."""
    window = int(window)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B} and H={H} must each be <= 65535 (grid)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel():
        if q.dtype == torch.bfloat16:
            _check_tma(q, k, v)
        strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
        _build.launch(_lib(), "flash_attention", q.device, _build.ptr(q),
                      _build.ptr(k), _build.ptr(v), _build.ptr(out), B, Sq,
                      Skv, H, KVH, D, *strides,
                      ctypes.c_float(1.0 / math.sqrt(D)), int(causal),
                      window, DTYPE_CODES[q.dtype])
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    """:func:`flash_attention` as a PyTorch operator, the model's one path
    to the kernel: a sharded model calls it on each rank's head group
    (``local_map``), and under ``FakeTensorMode`` (the dry run) its fake
    version gives the shape without launching."""
    return flash_attention(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)
