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

``ssd_scan_with_grad`` carries the chunk scan's gradient: on CUDA tensors
its backward is the hand-written f32 kernel of ``csrc/ssd_scan_bwd.cu``
(:func:`ssd_scan_bwd`, one counted ``ssd_scan_bwd`` launch a call), on
CPU tensors the plain version's autograd, recomputed.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple, Union

import torch
from torch._subclasses.fake_tensor import is_fake

from .. import _build, _grad
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
# bytes of f32 scratch a backward call may take: above the 315 MB that the
# mamba2-370m training step (B 16, nc 8, Q 256) takes in one group
BWD_SCRATCH_BUDGET = 512 << 20
_BWD_SIGNATURES = {"ssd_scan_bwd": [_P] * 14 + [_I] * 18 + [_P]}
TILE = 64               # rows of the backward kernels' tiles


def _lib() -> ctypes.CDLL:
    return _build.library("ssd_scan", _SIGNATURES)


def _bwd_lib() -> ctypes.CDLL:
    return _build.library("ssd_scan_bwd", _BWD_SIGNATURES)


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


def bwd_scratch_plan(B: int, nc: int, Q: int, nh: int, hd: int, ns: int
                     ) -> Tuple[int, int, int]:
    """(G, scratch bytes, bounds bytes) of a backward call: the chunks a
    group takes, the f32 scratch of one group -- (nh (2 ns hd + Q + 1) +
    2 pairs 64^2) floats per (batch, chunk), pairs the 64 x 64 tile pairs
    on or below a chunk's diagonal -- and the states entering every group
    after the first.  G is the most chunks whose scratch fits
    BWD_SCRATCH_BUDGET (at least one) and whose grids fit (G <= 65535)."""
    nt = -(-Q // TILE)
    per_chunk = 4 * B * (nh * (2 * ns * hd + Q + 1)
                         + 2 * (nt * (nt + 1) // 2) * TILE * TILE)
    G = max(1, min(nc, BWD_SCRATCH_BUDGET // per_chunk, MAX_GRID))
    groups = -(-nc // G)
    return G, G * per_chunk, (groups - 1) * 4 * B * nh * ns * hd


def ssd_scan_bwd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 dt: torch.Tensor, da: torch.Tensor, dy: torch.Tensor,
                 dh: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """The gradient of the chunk scan (:func:`ssd_scan` with its final
    state) at x, b, c, dt, da, given dy (y's shape and dtype) and the final
    state's gradient dh ((B, nh, ns, hd) f32, or None): (dx, db, dc) in the
    inputs' dtype, (ddt, dda) in f32, from the CUDA kernel, or from the
    plain version's autograd for tensors on the CPU."""
    _check(x, b, c, dt, da)
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must be x's "
                         f"shape and dtype")
    if dh is not None and (tuple(dh.shape) != (B, nh, ns, hd)
                           or dh.dtype != torch.float32):
        raise ValueError(f"dh {tuple(dh.shape)} {dh.dtype} must be "
                         f"{(B, nh, ns, hd)} float32")
    if x.device.type == "cpu":
        return _plain_grads((x, b, c, dt, da), (True,) * 5, dy, dh)
    if B > MAX_GRID or nh > MAX_GRID:
        raise ValueError(f"B = {B} and nh = {nh} must each be <= "
                         f"{MAX_GRID} (grid)")
    dy = dy.contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    db = torch.empty(b.shape, dtype=b.dtype, device=x.device)
    dc = torch.empty(c.shape, dtype=c.dtype, device=x.device)
    ddt = torch.empty(dt.shape, dtype=torch.float32, device=x.device)
    dda = torch.empty(da.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0 or b.numel() == 0:
        return (dx.zero_(), db.zero_(), dc.zero_(), ddt.zero_(),
                dda.zero_())
    G, nbytes, bbytes = bwd_scratch_plan(B, nc, Q, nh, hd, ns)
    scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    bounds = torch.empty(bbytes // 4, dtype=torch.float32,
                         device=x.device) if bbytes else None
    dcarry = dh.detach().clone().contiguous() if dh is not None else \
        torch.zeros((B, nh, ns, hd), dtype=torch.float32, device=x.device)
    ptrs = [_build.ptr(t) for t in (x, b, c, dt, da, dy, dx, db, dc, ddt,
                                    dda, scratch)]
    _build.launch(_bwd_lib(), "ssd_scan_bwd", x.device, *ptrs,
                  _build.ptr(bounds) if bounds is not None else None,
                  _build.ptr(dcarry), B, nc, Q, nh, hd, ns, *x.stride()[:4],
                  *b.stride()[:3], *c.stride()[:3], G, DTYPE_CODES[x.dtype])
    return dx, db, dc, ddt, dda


def _plain_grads(inputs, wanted, dy, dh):
    """The plain version's gradients by autograd, recomputed (None where
    an input's gradient is not wanted)."""
    return _grad.plain_backward(ssd_scan_chunked_ref, {}, inputs, wanted,
                                (dy, dh))


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def ssd_scan_bwd_op(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    dt: torch.Tensor, da: torch.Tensor, dy: torch.Tensor,
                    dh: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan_bwd` as a PyTorch operator: under
    ``FakeTensorMode`` (the dry run) its fake version gives the shapes
    without launching."""
    return ssd_scan_bwd(x, b, c, dt, da, dy, dh)


@ssd_scan_bwd_op.register_fake
def _(x, b, c, dt, da, dy, dh):
    return tuple(torch.empty(t.shape, dtype=d, device=x.device)
                 for t, d in ((x, x.dtype), (b, b.dtype), (c, c.dtype),
                              (dt, torch.float32), (da, torch.float32)))


class _SSDScanWithGrad(torch.autograd.Function):
    """``forward(x, b, c, dt, da)`` -> (y, final state) in the forward
    pass, autograd off inside it, only the five inputs saved; the backward
    is :func:`ssd_scan_bwd`: the kernel on CUDA tensors, the plain
    version's autograd, recomputed, on the CPU.  Fake tensors (the dry
    run) take :func:`ssd_scan_bwd_op` instead, whose fake version stands
    for the kernel on either device; real CPU tensors cannot, since
    autograd is off below an operator."""

    @staticmethod
    def forward(ctx, forward: Callable, *inputs: torch.Tensor):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, dy, dh):
        inputs = ctx.saved_tensors
        wanted = ctx.needs_input_grad[1:]
        if (dy is None and dh is None) or not any(wanted):
            return (None,) * 6
        x = inputs[0]
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
        bwd = ssd_scan_bwd_op if is_fake(x) else ssd_scan_bwd
        grads = bwd(*inputs, dy, dh)
        return (None, *(g if w else None for g, w in zip(grads, wanted)))


def ssd_scan_with_grad(forward: Callable, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, dt: torch.Tensor, da: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``forward(x, b, c, dt, da)`` -> (y, final state), the chunk scan on
    either path (the plain version or :func:`ssd_scan_op`), with the
    gradient of :func:`ssd_scan_chunked_ref` when autograd is on and some
    input requires a gradient; otherwise ``forward`` alone."""
    inputs = (x, b, c, dt, da)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        return forward(*inputs)
    return _SSDScanWithGrad.apply(forward, *inputs)


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
