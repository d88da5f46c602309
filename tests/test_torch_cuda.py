"""The port's CUDA kernels against their plain PyTorch versions, on the
card (exact: all four are integer maps).  Every test here needs a CUDA
device and skips without one; on a machine with the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.delta_encode import ops as de
from repro_torch.kernels.delta_encode.ref import (delta_zigzag_ref,
                                                  fit_columns_ref,
                                                  uvarint_encode64_ref)
from repro_torch.kernels.grammar_stats import ops as gs
from repro_torch.kernels.grammar_stats.ref import row_boundaries_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ only)")
    return torch.device("cuda")


def _u32(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    x[rng.randint(0, n)] = (1 << 32) - 1
    x[rng.randint(0, n)] = 0
    return torch.from_numpy(x.view(np.int32))


def _u64(n, seed):
    rng = np.random.RandomState(seed)
    shift = rng.randint(0, 64, size=n).astype(np.uint64)
    v = rng.randint(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2)
    v = v >> shift
    v[: min(n, 3)] = np.asarray([0, (1 << 63), (1 << 64) - 1],
                                np.uint64)[: min(n, 3)]
    return torch.from_numpy(v.view(np.int64))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 65542])
def test_delta_zigzag(dev, n):
    x = _u32(n, n)
    assert torch.equal(de.delta_zigzag(x.to(dev)).cpu(), delta_zigzag_ref(x))


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 65542])
def test_uvarint_encode64(dev, n):
    v = _u64(n, n)
    lens, planes = de.uvarint_encode64(v.to(dev))
    want_lens, want_planes = uvarint_encode64_ref(v)
    assert torch.equal(lens.cpu(), want_lens)
    assert torch.equal(planes.cpu(), want_planes)


@pytest.mark.parametrize("c,r", [(1, 2), (7, 33), (4096, 32)])
@pytest.mark.parametrize("base", [0, 1 << 31, 1 << 61])
def test_fit_columns(dev, c, r, base):
    rng = np.random.RandomState(c + r)
    V = np.where(np.arange(c)[:, None] % 2 == 0,
                 rng.randint(1, 9, size=(c, 1)) * np.arange(r)[None, :],
                 rng.randint(-9, 9, size=(c, r))) + base
    V = torch.from_numpy(V.astype(np.int64))
    flags, d0 = de.fit_columns(V.to(dev))
    want_flags, want_d0 = fit_columns_ref(V)
    assert torch.equal(flags.cpu(), want_flags)
    assert torch.equal(d0.cpu(), want_d0)


@pytest.mark.parametrize("n,k", [(1, 1), (257, 1), (65535, 3)])
def test_row_boundaries(dev, n, k):
    V = np.random.RandomState(n).randint(0, 2, size=(n, k)) + (1 << 40)
    V = torch.from_numpy(V.astype(np.int64))
    assert torch.equal(gs.row_boundaries(V.to(dev)).cpu(),
                       row_boundaries_ref(V))


def test_launches_are_counted(dev):
    _build.reset_launches()
    de.delta_zigzag(_u32(10, 0).to(dev))
    de.delta_zigzag(torch.empty(0, dtype=torch.int32, device=dev))  # no-op
    assert _build.launch_counts() == {"delta_zigzag": 1}
