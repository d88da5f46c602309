"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  The eight encode and read kernels are exact (integer maps;
histogram counts are integers, so the order of its atomic adds cannot
change them); flash attention and RMSNorm sum in another order than their
plain versions and are held to f32 2e-5 and bf16 2e-2 (atol and rtol),
the tolerances of ``tests/test_kernels.py``, and the SSD chunk scan to 5
times those, as that file holds its Pallas kernel.  Every test here needs
a CUDA device and skips without one; on a machine with the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only the port is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref
from repro_torch.kernels.delta_encode import ops as de
from repro_torch.kernels.delta_encode.ref import (delta_zigzag_ref,
                                                  delta_zigzag_varint_ref,
                                                  fit_columns_ref,
                                                  uvarint_encode64_ref,
                                                  uvarint_pack64_ref)
from repro_torch.kernels.grammar_stats import ops as gs
from repro_torch.kernels.grammar_stats.ref import (digram_codes_ref,
                                                   digram_counts_ref,
                                                   histogram_ref,
                                                   row_boundaries_ref,
                                                   row_run_starts_ref)

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


# lengths around a warp (32 lanes of 4 values), a block (256 threads) and
# the packer's 1,024-value tile, primes, and a grid-stride walk
ODD_LENGTHS = [1, 2, 63, 64, 127, 1021, 1024, 1025, 2047, 2048, 2049, 4099,
               32771, 65542, 3 * 2 ** 20 + 7]


@pytest.mark.parametrize("segment", [0, 1, 3, 4, 5, 31, 33, 12288])
@pytest.mark.parametrize("n", ODD_LENGTHS)
def test_delta_zigzag_segments(dev, n, segment):
    """A segment boundary inside a 4-value vector and inside a warp; x read
    16 bytes at a time and, one element off 16-byte alignment, a value at
    a time."""
    x = _u32(n, n + segment)
    want = delta_zigzag_ref(x, segment)
    assert torch.equal(de.delta_zigzag(x.to(dev), segment).cpu(), want)
    shifted = torch.cat([torch.zeros(1, dtype=torch.int32), x]).to(dev)[1:]
    assert torch.equal(de.delta_zigzag(shifted, segment).cpu(), want)


@pytest.mark.parametrize("n", ODD_LENGTHS)
def test_uvarint_pack64(dev, n):
    """Every length class, tiles whose bytes start off a 4-byte boundary,
    values read 16 bytes at a time and, off alignment, one at a time;
    small values too (one to two bytes each)."""
    for v in (_u64(n, n), torch.arange(n, dtype=torch.int64) % 300):
        want = uvarint_pack64_ref(v)
        got = de.uvarint_pack64(v.to(dev))
        assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)
        shifted = torch.cat([torch.zeros(1, dtype=torch.int64), v]).to(dev)
        assert torch.equal(de.uvarint_pack64(shifted[1:]).cpu(), want)


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


def _fit_rows(c, r, base, seed):
    """(C, R) int64 rows near ``base``: constant, rank-linear, irregular,
    and rank-linear but for one rank, at a span edge (256 and 1,024 are
    multiples of every span the tiled route takes), at the last rank or
    at rank 1 (a wrong d0 only)."""
    rng = np.random.RandomState(seed)
    slope = rng.randint(1, 9, size=(c, 1)) * np.where(rng.rand(c, 1) < .5,
                                                      -1, 1)
    ranks = np.arange(r)[None, :]
    V = np.where(np.arange(c)[:, None] % 4 == 0,
                 rng.randint(-50, 50, size=(c, 1)) + 0 * ranks,
                 slope * ranks + rng.randint(-99, 99, size=(c, 1)))
    noise = rng.randint(-1000, 1000, size=(c, r))
    V = np.where(np.arange(c)[:, None] % 4 == 2, noise, V)
    for i in range(3, c, 4):
        V[i, (256, 1024, r - 1, 1)[(i // 4) % 4] % r] += 7
    return (V + base).astype(np.int64)


def _route_edges(dev):
    """(the least C, the most R) that ``fit_plan`` gives the rows route
    on ``dev``: rows take (C, R) with C >= the first and R <= the
    second."""
    r_max = 2
    while de.fit_plan(1 << 40, r_max + 1, dev)[0] == "rows":
        r_max += 1
    lo, hi = 1, 1 << 40          # fit_plan(lo, 2) tiles, (hi, 2) rows
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if de.fit_plan(mid, 2, dev)[0] == "rows" \
            else (mid, hi)
    return hi, r_max


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("base", [0, (1 << 62) - (1 << 20),
                                  -(1 << 62) + (1 << 20)])
@pytest.mark.parametrize("c,r", [
    (c, r) for c in (1, 2, 257)
    for r in (2, 3, 31, 32, 33, "edge", "edge+1", 255, 257, 511, 513, 4099,
              16384)] + [
    (65536, r) for r in (2, 3, 17, "edge", "edge+1")])
def test_fit_columns_edges(dev, c, r, base, offset):
    """Both routes (a thread a row where R is at most the rows route's
    edge, ``fit_plan``'s, and C fills the card, else a warp a span of
    ranks), rows split over spans at prime lengths and a span multiple
    +- 1, values near +-2^62, and with ``offset`` rows that start off
    16-byte alignment (a column slice): exact against the plain version,
    one counted launch, one packed output."""
    if isinstance(r, str):
        r = _route_edges(dev)[1] + (r == "edge+1")
    W = _fit_rows(c, r + offset, base, c * r + offset)
    V = torch.from_numpy(W).to(dev)[:, offset:]
    _build.reset_launches()
    flags, d0 = de.fit_columns(V)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"fit_columns": 1}
    want_flags, want_d0 = fit_columns_ref(torch.from_numpy(W[:, offset:]))
    hf, hd = de.fit_to_host(flags, d0)
    np.testing.assert_array_equal(hf, want_flags.numpy())
    np.testing.assert_array_equal(hd, want_d0.numpy())
    assert torch.equal(flags.cpu(), want_flags)
    kinds = set(want_flags.tolist())
    assert kinds == {0, 1, 2} or c < 4 or r < 3


def test_fit_columns_scratch_stays_zeroed(dev):
    """Rows split over spans combine in a scratch that every launch leaves
    zeroed: repeated and interleaved calls (more rows, fewer rows, another
    stream) give the plain version's flags each time."""
    mats = [torch.from_numpy(_fit_rows(c, r, 0, c * r)).to(dev)
            for c, r in ((257, 4099), (3, 16384), (257, 4099), (1, 5000))]
    wants = [fit_columns_ref(V.cpu()) for V in mats]
    side = torch.cuda.Stream(dev)
    for rep in range(3):
        for V, (want_flags, want_d0) in zip(mats, wants):
            with torch.cuda.stream(side if rep == 1 else
                                   torch.cuda.default_stream(dev)):
                flags, d0 = de.fit_columns(V)
                torch.cuda.current_stream(dev).synchronize()
            assert torch.equal(flags.cpu(), want_flags)
            assert torch.equal(d0.cpu(), want_d0)


def test_fit_columns_route_boundary(dev):
    """The rows route takes R up to its edge once C gives every SM whole
    warps of rows (both edges from ``fit_plan``); a tiles split of a long
    row spans whole quanta of 256 ranks, 32 warps an SM; both sides of
    each edge are exact."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c_min, r_max = _route_edges(dev)
    assert c_min % (32 * sms) == 0 and r_max >= 16
    assert de.fit_plan(c_min, r_max, dev) == ("rows", 16, 1)
    assert [de.fit_plan(c_min, r, dev)[1] for r in (2, 3, 16, 17)] == [
        2, 3, 16, 16]
    assert de.fit_plan(c_min, r_max + 1, dev)[0] == "tiles"
    assert de.fit_plan(c_min - 1, 2, dev)[0] == "tiles"
    assert de.fit_plan(6, 32, dev) == ("tiles", 256, 1)
    route, span, nspans = de.fit_plan(256, 16384, dev)
    assert route == "tiles" and span % 256 == 0 and nspans == -(-16384 //
                                                                span)
    assert 256 * nspans >= 16 * sms
    for c, r in ((c_min - 1, 2), (c_min, 2), (c_min, r_max),
                 (c_min, r_max + 1), (c_min + 31, 5)):
        V = torch.from_numpy(_fit_rows(c, r, 1 << 40, c + r))
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


def _run_rows(n, k, seed, long_run=False):
    """(n, k) int64 rows in runs of 1 to 7 equal rows, a third of them
    near 2^63 and a third near -2^63, so that differences wrap; with
    ``long_run`` one arithmetic run ending at 2^63 - 1."""
    rng = np.random.RandomState(seed)
    if long_run:
        V = (np.arange(n)[:, None] * rng.randint(1, 9, size=(1, k))
             + rng.randint(-9, 9, size=(1, k))).astype(np.int64)
        V -= V.max()
        return torch.from_numpy(V + np.int64((1 << 63) - 1))
    vals = rng.randint(0, 3, size=(n, k)).astype(np.int64)
    vals[::3] += np.int64(3 << 61)
    vals[1::3] -= np.int64(3 << 61)
    V = np.repeat(vals, rng.randint(1, 8, size=n), axis=0)[:n]
    return torch.from_numpy(np.ascontiguousarray(V))


# tiles of 1,024 rows: one row either side of a tile edge, primes
@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [1, 2, 3, 1023, 1024, 1025, 4099, 65537])
def test_row_run_starts(dev, n, k, diff):
    """Every run start, 16-byte loads and (off alignment) scalar ones, k
    in the register path (1-2) and past it (3-5)."""
    if diff and n < 2:
        with pytest.raises(ValueError):
            gs.row_run_starts(_run_rows(n, k, 0).to(dev), diff)
        return
    for long_run in (False, True):
        V = _run_rows(n, k, n * k + diff, long_run)
        want = row_run_starts_ref(V, diff)
        got = gs.row_run_starts(V.to(dev), diff)
        assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
        shifted = torch.cat([torch.zeros((1, k), dtype=torch.int64),
                             V]).to(dev)[1:]
        assert torch.equal(gs.row_run_starts(shifted, diff).cpu(), want)


# T 241 is the dense route's last on the H100; from 242 the codes are
# formed by digram_codes and counted by a sort
@pytest.mark.parametrize("T", [1, 6, 241, 242, 4096, 1 << 20])
@pytest.mark.parametrize("n", [1, 2, 3, 4099, 65537])
def test_digram_counts(dev, n, T):
    s = np.random.RandomState(n + T).randint(0, T, size=n).astype(np.int64)
    s[: n // 2: 2] = 0                      # two hot codes, as IOR's
    s[1: n // 2: 2] = T - 1
    s = torch.from_numpy(s)
    want = digram_counts_ref(s, T)
    for x in (s.to(dev), torch.cat([s[:1], s]).to(dev)[1:]):
        got = gs.digram_counts(x, T)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64 and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("T", [6, 4096])
@pytest.mark.parametrize("bad", [-1, 4096, 1 << 40])
def test_digram_counts_raise_on_the_card(dev, T, bad):
    s = torch.arange(5000, dtype=torch.int64) % T
    s[4321] = bad if bad != 4096 else T
    with pytest.raises(ValueError, match="outside"):
        gs.digram_counts(s.to(dev), T)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 4099, 65537])
def test_delta_zigzag_varint(dev, n):
    x = _u32(n, n + 1)
    got = de.delta_zigzag_varint(x.to(dev))
    for g, w in zip(got, delta_zigzag_varint_ref(x)):
        assert torch.equal(g.cpu(), w)


# 58,112 uint32 bins fill Hopper's 227 KB of shared memory a block; 65,536
# and 2^20 bins run the kernel that adds straight into global memory
@pytest.mark.parametrize("n_bins", [1, 64, 4096, 58112, 65536, 1 << 20])
@pytest.mark.parametrize("n", [1, 257, 65537])
def test_histogram(dev, n, n_bins):
    rng = np.random.RandomState(n + n_bins)
    s = rng.randint(-3, n_bins + 3, size=n).astype(np.int64)
    s[rng.rand(n) < 0.05] = -(1 << 40)
    s = torch.from_numpy(s)
    got = gs.histogram(s.to(dev), n_bins)
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), histogram_ref(s, n_bins))


@pytest.mark.parametrize("T", [1, 40, 1 << 20])
@pytest.mark.parametrize("n", [1, 2, 257, 65537])
def test_digram_codes(dev, n, T):
    s = torch.from_numpy(np.random.RandomState(n + T).randint(
        0, T, size=n).astype(np.int64))
    assert torch.equal(gs.digram_codes(s.to(dev), T).cpu(),
                       digram_codes_ref(s, T))


def test_launches_are_counted(dev):
    _build.reset_launches()
    de.delta_zigzag(_u32(10, 0).to(dev))
    de.delta_zigzag(torch.empty(0, dtype=torch.int32, device=dev))  # no-op
    de.uvarint_pack64(_u64(5000, 0).to(dev))
    de.uvarint_pack64(torch.empty(0, dtype=torch.int64, device=dev))
    assert _build.launch_counts() == {"delta_zigzag": 1, "uvarint_pack64": 1}


TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _close(got, want):
    tol = TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _randn(shape, seed, dtype, dev):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 24),
                                           (False, 100)])
@pytest.mark.parametrize("S,H,KVH,D", [(1, 8, 1, 128), (37, 8, 1, 16),
                                       (131, 4, 4, 32), (1000, 8, 1, 64),
                                       (1024, 16, 2, 128), (100, 2, 2, 8)])
def test_flash_attention(dev, S, H, KVH, D, causal, window, dtype):
    q = _randn((2, S, H, D), S, dtype, dev)
    k = _randn((2, S, KVH, D), S + 1, dtype, dev)
    v = _randn((2, S, KVH, D), S + 2, dtype, dev)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    _close(got, flash_attention_ref(q, k, v, causal=causal, window=window))


def test_flash_attention_reads_strided_inputs(dev):
    """q, k, v as column slices of one fused projection, not contiguous."""
    B, S, H, KVH, D = 2, 77, 8, 2, 64
    qkv = _randn((B, S, (H + 2 * KVH) * D), 5, torch.bfloat16, dev)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + KVH) * D].view(B, S, KVH, D)
    v = qkv[..., (H + KVH) * D:].view(B, S, KVH, D)
    assert not q.is_contiguous()
    _close(flash_attention(q, k, v),
           flash_attention_ref(q.contiguous(), k.contiguous(),
                               v.contiguous()))


def test_flash_attention_at_the_serving_prefill_shape(dev):
    q = _randn((4, 1024, 64, 128), 1, torch.bfloat16, dev)
    k = _randn((4, 1024, 8, 128), 2, torch.bfloat16, dev)
    v = _randn((4, 1024, 8, 128), 3, torch.bfloat16, dev)
    _close(flash_attention(q, k, v), flash_attention_ref(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [127, 129, 255])
def test_flash_attention_tails_of_the_q_tile(dev, S, dtype):
    """S one short of, one past and one short of twice the bf16 kernel's
    128-row q tile (and of its kv tiles)."""
    q = _randn((2, S, 8, 128), S, dtype, dev)
    k = _randn((2, S, 2, 128), S + 1, dtype, dev)
    v = _randn((2, S, 2, 128), S + 2, dtype, dev)
    _close(flash_attention(q, k, v), flash_attention_ref(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hymba_like_group_and_window(dev, dtype):
    """GQA group 5 at D 64 with a window of 128 keys, as hymba's layers."""
    q = _randn((2, 300, 25, 64), 30, dtype, dev)
    k = _randn((2, 300, 5, 64), 31, dtype, dev)
    v = _randn((2, 300, 5, 64), 32, dtype, dev)
    _close(flash_attention(q, k, v, window=128),
           flash_attention_ref(q, k, v, window=128))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_one_query_row(dev, causal, dtype):
    """Sq = 1 against 300 keys: one valid row in a 128-row q tile."""
    q = _randn((2, 1, 8, 128), 40, dtype, dev)
    k = _randn((2, 300, 1, 128), 41, dtype, dev)
    v = _randn((2, 300, 1, 128), 42, dtype, dev)
    _close(flash_attention(q, k, v, causal=causal),
           flash_attention_ref(q, k, v, causal=causal))


def test_flash_attention_rejects_what_tma_cannot_address(dev):
    """bf16 q whose rows start 2 bytes apart from 16-byte boundaries (an
    odd row stride): the wrapper raises, it does not copy."""
    B, S, H, D = 2, 40, 4, 64
    base = _randn((B, S, H * D + 1), 50, torch.bfloat16, dev)
    q = base[..., 1:].unflatten(-1, (H, D))
    k = _randn((B, S, 1, D), 51, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        flash_attention(base[..., :H * D].unflatten(-1, (H, D)), k, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128), (37, 128), (4, 7, 8, 128),
                                   (262144, 128), (256, 128), (3, 100),
                                   (5, 8192), (9, 8)])
def test_rmsnorm(dev, shape, dtype):
    x = _randn(shape, shape[0], dtype, dev)
    w = torch.from_numpy(np.random.RandomState(1).rand(shape[-1])
                         .astype(np.float32)).to(dev)
    got = rmsnorm(x, w, eps=1e-6)
    torch.cuda.synchronize()
    _close(got, rmsnorm_ref(x, w, eps=1e-6))


def test_rmsnorm_unaligned_rows(dev):
    """A view that starts 2 bytes into its storage takes the scalar path."""
    base = _randn((1 + 64 * 128,), 3, torch.bfloat16, dev)
    x = base[1:].view(64, 128)
    w = torch.ones(128, device=dev)
    _close(rmsnorm(x, w), rmsnorm_ref(x, w))


def test_model_kernels_launch_and_agree_with_the_cpu(dev):
    """The qwen3-32b smoke model (f32) on the card against the same
    weights on the CPU (plain versions): prefill logits and greedy
    tokens; one flash_attention launch per layer of the prefill, two
    rmsnorm launches per layer and token."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(dev)
    cfg = get_smoke_config("qwen3-32b")
    params = get_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    params_dev = to(params)
    batch = {"tokens": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 37)).astype(np.int32)}
    want_logits, _ = get_model(cfg, "cpu").prefill(params, batch)
    got_logits, _ = get_model(cfg, dev).prefill(params_dev, batch)
    torch.testing.assert_close(got_logits.cpu(), want_logits, atol=1e-4,
                               rtol=1e-4)
    want = ServeEngine(cfg, params, max_seq=64, device="cpu").generate(
        batch, 8)
    _build.reset_launches()
    got = ServeEngine(cfg, params_dev, max_seq=64, device=dev).generate(
        batch, 8)
    counts = _build.launch_counts()
    np.testing.assert_array_equal(got, want)
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["rmsnorm"] == 2 * cfg.n_layers * 8


def _ssd_inputs(B, nc, Q, nh, hd, ns, dtype, dev, seed):
    rng = np.random.RandomState(seed)
    x = _randn((B, nc, Q, nh, hd), seed, dtype, dev)
    b = _randn((B, nc, Q, ns), seed + 1, dtype, dev)
    c = _randn((B, nc, Q, ns), seed + 2, dtype, dev)
    dt = torch.from_numpy((rng.rand(B, nc, Q, nh) * 0.1)
                          .astype(np.float32)).to(dev)
    da = torch.from_numpy((-rng.rand(B, nc, Q, nh) * 0.5)
                          .astype(np.float32)).to(dev)
    return x, b, c, dt, da


def _ssd_close(got, want):
    tol = 5 * TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,nc", [(1, 3), (7, 8), (100, 3), (256, 1),
                                  (256, 8)])
@pytest.mark.parametrize("ns,hd", [(16, 16), (128, 64), (8, 48), (128, 128)])
def test_ssd_scan(dev, Q, nc, ns, hd, dtype):
    tx = _ssd_inputs(2, nc, Q, 3, hd, ns, dtype, dev, Q + nc + hd)
    y, h = ssd_scan(*tx, return_state=True)
    torch.cuda.synchronize()
    want_y, want_h = ssd_scan_chunked_ref(*tx)
    _ssd_close(y, want_y)
    _ssd_close(h, want_h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q", [1, 64])
def test_ssd_scan_sixteen_chunks(dev, Q, dtype):
    """nc 16: the state-passing walk over many chunks, with Q 1 (a prime
    prompt length's chunk) and Q 64 (one full tile)."""
    tx = _ssd_inputs(2, 16, Q, 3, 64, 128, dtype, dev, 60 + Q)
    y, h = ssd_scan(*tx, return_state=True)
    torch.cuda.synchronize()
    want_y, want_h = ssd_scan_chunked_ref(*tx)
    _ssd_close(y, want_y)
    _ssd_close(h, want_h)


def test_ssd_scan_prime_length_runs_in_groups(dev):
    """Q 1 and nc 2,003 (a prime prompt length): the bf16 passes run over
    groups of chunks with bounded scratch, the state carried between
    groups, within the plain version's tolerance."""
    tx = _ssd_inputs(2, 2003, 1, 4, 64, 128, torch.bfloat16, dev, 91)
    G, _ = ssd_ops.scratch_plan(2, 2003, 1, 4, 64, 128)
    assert 1 < G < 2003
    y, h = ssd_scan(*tx, return_state=True)
    torch.cuda.synchronize()
    want_y, want_h = ssd_scan_chunked_ref(*tx)
    _ssd_close(y, want_y)
    _ssd_close(h, want_h)


def test_ssd_scan_groups_are_bit_identical(dev, monkeypatch):
    """A group boundary only cuts the state pass's walk, and the state
    crosses it in f32: a scratch budget that takes groups of 3 or of 5
    gives one group's y and state bit for bit."""
    shape = (2, 16, 64, 3, 64, 128)
    tx = _ssd_inputs(*shape, torch.bfloat16, dev, 92)
    assert ssd_ops.scratch_plan(*shape)[0] == 16
    y, h = ssd_scan(*tx, return_state=True)
    per_chunk = ssd_ops.scratch_plan(*shape)[1] // 16
    for group in (3, 5):
        monkeypatch.setattr(ssd_ops, "SCRATCH_BUDGET", group * per_chunk)
        assert ssd_ops.scratch_plan(*shape)[0] == group
        yg, hg = ssd_scan(*tx, return_state=True)
        assert torch.equal(yg, y) and torch.equal(hg, h)
    monkeypatch.setattr(ssd_ops, "SCRATCH_BUDGET", 3 * per_chunk)
    assert torch.equal(ssd_scan(*tx), y)   # h only as the carry


def test_ssd_scan_more_batch_chunks_than_a_grid_holds(dev):
    """B nc = 66,000 > 65,535, once refused, runs in groups whose grids
    fit; one call is one counted launch."""
    tx = _ssd_inputs(33, 2000, 1, 1, 16, 16, torch.bfloat16, dev, 93)
    _build.reset_launches()
    y, h = ssd_scan(*tx, return_state=True)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"ssd_scan": 1}
    want_y, want_h = ssd_scan_chunked_ref(*tx)
    _ssd_close(y, want_y)
    _ssd_close(h, want_h)


def test_ssd_scan_reads_strided_inputs(dev):
    """x, b and c as column slices of one tensor, as the model passes
    them."""
    B, nc, Q, nh, hd, ns = 2, 3, 100, 4, 64, 128
    xbc = _randn((B, nc * Q, nh * hd + 2 * ns), 7, torch.bfloat16, dev)
    x = xbc[..., :nh * hd].reshape(B, nc, Q, nh, hd)
    b = xbc[..., nh * hd:nh * hd + ns].reshape(B, nc, Q, ns)
    c = xbc[..., nh * hd + ns:].reshape(B, nc, Q, ns)
    _, _, _, dt, da = _ssd_inputs(B, nc, Q, nh, 8, 8, torch.float32, dev, 8)
    y, h = ssd_scan(x, b, c, dt, da, return_state=True)
    want_y, want_h = ssd_scan_chunked_ref(x.contiguous(), b.contiguous(),
                                          c.contiguous(), dt, da)
    _ssd_close(y, want_y)
    _ssd_close(h, want_h)


def test_ssd_scan_overflowing_decay_stays_finite(dev):
    """exp(cs_q - cs_p) is inf above the diagonal at mamba2's strongest
    decay over a 256-token chunk; the kernel must select, not mask."""
    x, b, c, dt, da = _ssd_inputs(1, 2, 256, 2, 64, 128, torch.float32, dev,
                                  9)
    da = torch.full_like(da, -3.2)
    dt = torch.full_like(dt, 0.1)
    y, h = ssd_scan(x, b, c, dt, da, return_state=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    want_y, want_h = ssd_scan_chunked_ref(x, b, c, dt, da)
    _ssd_close(y, want_y)
    _ssd_close(h, want_h)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ssm_models_launch_and_agree_with_the_cpu(dev, arch):
    """The SSM and hybrid smoke models (f32) on the card against the same
    weights on the CPU: prefill logits and greedy tokens; one ssd_scan
    launch per layer of the prefill, one rmsnorm launch per layer and
    token (the gate norm), and for hymba one flash_attention per layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(dev)
    cfg = get_smoke_config(arch)
    params = get_model(cfg, "cpu").init_params(torch.Generator().manual_seed(0))
    params_dev = to(params)
    batch = {"tokens": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32)}
    want_logits, _ = get_model(cfg, "cpu").prefill(params, batch)
    got_logits, _ = get_model(cfg, dev).prefill(params_dev, batch)
    torch.testing.assert_close(got_logits.cpu(), want_logits, atol=1e-4,
                               rtol=1e-4)
    want = ServeEngine(cfg, params, max_seq=64, device="cpu").generate(
        batch, 8)
    _build.reset_launches()
    got = ServeEngine(cfg, params_dev, max_seq=64, device=dev).generate(
        batch, 8)
    counts = _build.launch_counts()
    np.testing.assert_array_equal(got, want)
    assert counts["ssd_scan"] == cfg.n_layers
    assert counts["rmsnorm"] == cfg.n_layers * 8
    assert counts.get("flash_attention", 0) == (cfg.n_layers if cfg.hybrid
                                                else 0)
