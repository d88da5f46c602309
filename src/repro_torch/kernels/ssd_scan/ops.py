"""Wrapper of the SSD chunk-scan CUDA kernel (``csrc/ssd_scan.cu``).

``ssd_scan`` replaces ``ssd_scan_pallas`` of the JAX package
(``kernels/ssd_scan/ssd_scan.py:63``) behind the same chunked layout as
its ``ops.ssd_scan``: x (B, nc, Q, nh, hd), b and c (B, nc, Q, ns), dt and
da (B, nc, Q, nh).  With ``return_state=True`` it also returns the f32
state after the last chunk, (B, nh, ns, hd), which a prefill keeps as the
decode cache (the Pallas kernel writes only y).  It checks its inputs,
runs the plain PyTorch version (``ref.py``) when they lie on the CPU, and
otherwise launches the kernel on the current stream -- there is no
fallback for CUDA tensors: the kernel runs or the call raises.  The
kernel reads x, b and c through their strides (the model passes column
slices of the convolution's output), so no copies are made; dt and da
must be contiguous.

At the mamba2-370m serve prefill (B 4, nc 8, Q 256, nh 32, hd 64,
ns 128) the function moves 77.6 MB and needs 21.5 GFLOP (the causal
triangle of each chunk), so the bytes bound it, narrowly, on an H100.
bf16 runs three kernels on the tensor cores (chunk states, state
passing, chunk output), with f32 scratch of (2 ns hd + Q + 1) floats per
(batch, chunk, head) that the wrapper allocates.  So that the scratch
does not grow with the number of chunks (a prime prompt length gives
Q = 1 and nc = S), the kernel runs the three passes over groups of at most
G chunks, carrying the f32 state from group to group, with G from
:func:`scratch_plan`; the scratch is allocated once per call and reused
by every group, and one call counts as one ``ssd_scan`` launch.  f32
keeps the CUDA-core kernel, which needs no scratch.  Times are in
``PERF.md``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from .. import _build
from .ref import ssd_scan_chunked_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"ssd_scan": [_P] * 8 + [_I] * 18 + [_P]}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128      # hd: the kernel's widest register tile
MAX_STATE = 128         # ns: shared memory holds the (ns, hd) state
MAX_CHUNK = 4096        # Q: shared memory holds the chunk's decay sums
MAX_GRID = 65535        # grid y and z: pass A has G on y, pass C B * G on z
# bytes of f32 scratch a bf16 call may take: above the 68.2 MB that the
# mamba2-370m serve prefill (B 4, nc 8, Q 256) takes in one group, below
# twice that
SCRATCH_BUDGET = 128 << 20


def _lib() -> ctypes.CDLL:
    return _build.library("ssd_scan", _SIGNATURES)


def _check(x, b, c, dt, da) -> None:
    for name, t in (("x", x), ("b", b), ("c", c)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != (5 if name == "x" else 4):
            want = "(B, nc, Q, nh, hd)" if name == "x" else "(B, nc, Q, ns)"
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want "
                             f"{want}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last "
                             f"dimension")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c dtypes differ: {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    for name, t in (("dt", dt), ("da", da)):
        _build.check(t, name, torch.float32, 4)
    if not (x.device == b.device == c.device == dt.device == da.device):
        raise ValueError("x, b, c, dt and da must lie on one device")
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    if b.shape != c.shape or tuple(b.shape[:3]) != (B, nc, Q):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if dt.shape != da.shape or tuple(dt.shape) != (B, nc, Q, nh):
        raise ValueError(f"dt {tuple(dt.shape)} and da {tuple(da.shape)} "
                         f"must be (B, nc, Q, nh) = {(B, nc, Q, nh)}")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= ns <= MAX_STATE
            and Q <= MAX_CHUNK):
        raise ValueError(f"hd={hd}, ns={ns}, Q={Q}: the kernel takes "
                         f"1 <= hd <= {MAX_HEAD_DIM}, 1 <= ns <= "
                         f"{MAX_STATE}, Q <= {MAX_CHUNK}")


def scratch_plan(B: int, nc: int, Q: int, nh: int, hd: int, ns: int
                 ) -> Tuple[int, int]:
    """(G, bytes): the chunks a group of the bf16 path takes and the f32
    scratch the call allocates, (2 ns hd + Q + 1) floats per (batch, chunk
    of a group, head).  G is the most chunks whose scratch fits
    SCRATCH_BUDGET (at least one) and whose grids fit (B G <= 65535)."""
    per_chunk = 4 * B * nh * (2 * ns * hd + Q + 1)
    G = max(1, min(nc, SCRATCH_BUDGET // per_chunk, MAX_GRID // B))
    return G, G * per_chunk


def ssd_scan(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             dt: torch.Tensor, da: torch.Tensor, *,
             return_state: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, nc, Q, nh, hd), b and c (B, nc, Q, ns) in float32 or
    bfloat16; dt, da (B, nc, Q, nh) float32 -> y (x's shape and dtype), and
    with ``return_state`` also the f32 state (B, nh, ns, hd) after the
    last chunk."""
    _check(x, b, c, dt, da)
    if x.device.type == "cpu":
        y, h = ssd_scan_chunked_ref(x, b, c, dt, da)
        return (y, h) if return_state else y
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    if B > MAX_GRID or nh > MAX_GRID:
        raise ValueError(f"B = {B} and nh = {nh} must each be <= "
                         f"{MAX_GRID} (grid)")
    G, nbytes = scratch_plan(B, nc, Q, nh, hd, ns)
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    # more than one group carries the state from group to group in h
    h = torch.zeros((B, nh, ns, hd), dtype=torch.float32, device=x.device) \
        if return_state or (bf16 and G < nc) else None
    if x.numel():
        # bf16: for the chunks of one group, their states, the states
        # entering them as bf16 hi and lo, then cs and tot of every
        # (batch, chunk, head)
        scratch = torch.empty(nbytes // 4, dtype=torch.float32,
                              device=x.device) if bf16 else None
        _build.launch(_lib(), "ssd_scan", x.device, _build.ptr(x),
                      _build.ptr(b), _build.ptr(c), _build.ptr(dt),
                      _build.ptr(da), _build.ptr(y),
                      _build.ptr(h) if h is not None else None,
                      _build.ptr(scratch) if scratch is not None else None,
                      B, nc, Q, nh, hd, ns, *x.stride()[:4],
                      *b.stride()[:3], *c.stride()[:3], G,
                      DTYPE_CODES[x.dtype])
    return (y, h) if return_state else y


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                dt: torch.Tensor, da: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan` with ``return_state`` as a PyTorch operator, the
    model's one path to the kernel: a sharded model calls it on each
    rank's shard (``local_map``), and under ``FakeTensorMode`` (the dry
    run) its fake version gives the shapes without launching."""
    return ssd_scan(x, b, c, dt, da, return_state=True)


@ssd_scan_op.register_fake
def _(x, b, c, dt, da):
    B, _, _, nh, hd = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((B, nh, b.shape[-1], hd), dtype=torch.float32,
                        device=x.device))
