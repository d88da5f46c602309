"""Plain PyTorch versions of the delta_encode kernels.

The wrappers in ``ops.py`` run these for tensors on the CPU (the ``torch``
encode backend), and ``chip_smoke.py`` holds each CUDA kernel against them
on the card.  Unsigned values travel as the bit patterns of signed
tensors (u32 in int32, u64 in int64), because the CUDA kernels read them
that way; the arithmetic below works on the unsigned values.
"""

from __future__ import annotations

from typing import Tuple

import torch

_U32 = 1 << 32


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2^32) -> the int32 bit patterns."""
    return torch.where(u >= (1 << 31), u - _U32, u).to(torch.int32)


def delta_zigzag_ref(ticks: torch.Tensor, segment: int = 0) -> torch.Tensor:
    """Flat u32 ticks (int32 bit patterns) -> zigzag of the first-order
    delta wrapped mod 2^32, as int32 bit patterns; element i is taken
    against 0 where ``i % segment == 0`` (``segment`` 0: only element
    0)."""
    x = ticks.to(torch.int64) & (_U32 - 1)
    prev = torch.zeros_like(x)
    prev[1:] = x[:-1]
    if segment:
        prev[::segment] = 0
    d = (x - prev) & (_U32 - 1)
    d = torch.where(d >= (1 << 31), d - _U32, d)     # signed 32-bit delta
    return _as_int32(((d << 1) ^ (d >> 63)) & (_U32 - 1))


def delta_zigzag_varint_ref(ticks: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Flat u32 ticks (int32 bit patterns) -> (zigzag'd deltas as int32 bit
    patterns (n,), int32 varint byte counts (n,), (5, n) uint8 byte planes
    with continuation bits): :func:`delta_zigzag_ref` and the varint split
    of a u32 in one call."""
    zz = delta_zigzag_ref(ticks)
    z = zz.to(torch.int64) & (_U32 - 1)
    lens = torch.ones(z.shape, dtype=torch.int32, device=z.device)
    for k in range(1, 5):
        lens += (z >= (1 << (7 * k))).to(torch.int32)
    planes = torch.empty((5,) + tuple(z.shape), dtype=torch.uint8,
                         device=z.device)
    for j in range(5):
        b = (z >> (7 * j)) & 0x7F
        planes[j] = torch.where(j < lens - 1, b | 0x80, b).to(torch.uint8)
    return zz, lens, planes


def uvarint_encode64_ref(values: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u64 values (int64 bit patterns) -> (int32 varint byte counts,
    (10, n) uint8 byte planes with continuation bits)."""
    v = values
    high = v < 0                       # unsigned value >= 2^63
    lens = torch.ones(v.shape, dtype=torch.int32, device=v.device)
    for k in range(1, 10):
        ge = high if 7 * k == 63 else (high | (v >= (1 << (7 * k))))
        lens += ge.to(torch.int32)
    planes = torch.empty((10,) + tuple(v.shape), dtype=torch.uint8,
                         device=v.device)
    for j in range(10):
        # >> is arithmetic on int64: the top plane keeps only bit 63
        b = (v >> (7 * j)) & (0x7F if j < 9 else 0x01)
        planes[j] = torch.where(j < lens - 1, b | 0x80, b).to(torch.uint8)
    return lens, planes


def uvarint_pack64_ref(values: torch.Tensor) -> torch.Tensor:
    """u64 values (int64 bit patterns) -> their uvarints packed end to end,
    uint8 (total,): the lens and planes of :func:`uvarint_encode64_ref`
    scattered to their offsets, plane by plane."""
    lens, planes = uvarint_encode64_ref(values)
    lens = lens.to(torch.int64)
    starts = torch.cumsum(lens, 0) - lens
    out = torch.empty(int(lens.sum()), dtype=torch.uint8,
                      device=values.device)
    for j in range(10):
        sel = lens > j
        out[starts[sel] + j] = planes[j][sel]
    return out


def fit_columns_ref(V: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, R) int64 matrix, R >= 2 -> (int32 flags, int64 first deltas):
    flag 1 = every delta is 0, 2 = every delta equals a nonzero first
    delta, 0 = neither."""
    d = V[:, 1:] - V[:, :-1]
    const = (d == 0).all(dim=1)
    linear = (d == d[:, :1]).all(dim=1) & (d[:, 0] != 0)
    flags = torch.where(const, 1, torch.where(linear, 2, 0))
    return flags.to(torch.int32), d[:, 0].contiguous()
