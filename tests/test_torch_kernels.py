"""The port's kernels against the JAX package's Pallas kernels.

Each plain PyTorch version (``repro_torch.kernels.*.ref``, reached through
the wrappers with CPU tensors) must equal the reference Pallas kernel run
in interpret mode on the same numpy inputs -- exactly, since all of them
are integer maps.  Fit values at or above 2^31 are held against the
reference ``fit_columns_ref`` instead, because the reference's TPU path
only takes int32.  ``test_torch_cuda.py`` holds the CUDA kernels against
these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_encode import ops as ref_de
from repro.kernels.delta_encode.ref import fit_columns_ref
from repro.kernels.grammar_stats import ops as ref_gs
from repro_torch.kernels import _build
from repro_torch.kernels.delta_encode import ops as de
from repro_torch.kernels.grammar_stats import ops as gs

LENGTHS = [1, 5, 257, 4099]
STYLES = ["mono", "wrap", "zero", "extreme"]
VARINT_EDGES = [0, 127, 128, 1 << 63, (1 << 64) - 1]


def _ticks(n, style, seed=0):
    """Flat u32 tick stream of length n in the styles of the reference
    encode tests: monotone, wrapping at 2^32, zero deltas, extremes."""
    rng = np.random.RandomState(seed)
    if style == "wrap":
        base = (1 << 32) - n - 5
        flat = base + np.sort(rng.randint(0, 2 * n + 9, size=n))
    elif style == "zero":
        flat = np.sort(np.repeat(rng.randint(0, 1000, size=max(1, n // 8)),
                                 8)[:n])
        flat = np.pad(flat, (0, n - len(flat)), mode="edge")
    elif style == "extreme":
        flat = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
        flat[rng.randint(0, n)] = (1 << 32) - 1
        flat[rng.randint(0, n)] = 0
    else:
        flat = np.cumsum(rng.randint(0, 100000, size=n))
    return (np.asarray(flat).astype(np.uint64) & 0xFFFFFFFF).astype(np.uint32)


def _ragged_u64(n, seed=0):
    """u64 values in every varint length class 1..10, plus the edges."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 65, size=n)
    vals = [(int(rng.randint(0, 1 << 32, dtype=np.uint64))
             | (1 << max(0, int(b) - 1))) & ((1 << 64) - 1) if b else 0
            for b in bits]
    return np.asarray(VARINT_EDGES + vals, dtype=np.uint64)


def _fit_matrix(c, r, big=False, seed=0):
    """(C, R) columns mixing constant, rank-linear and irregular rows."""
    rng = np.random.RandomState(seed)
    base = (1 << 40) if big else 0
    rows = []
    for i in range(c):
        kind = i % 3
        if kind == 0:
            rows.append(np.full(r, base + rng.randint(-50, 50)))
        elif kind == 1:
            a = int(rng.randint(1, 9)) * (1 if i % 2 else -1)
            rows.append(base + rng.randint(-99, 99) + a * np.arange(r))
        else:
            rows.append(base + rng.randint(-1000, 1000, size=r))
    return np.asarray(rows, dtype=np.int64)


def _to_t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("n", LENGTHS)
def test_delta_zigzag_matches_pallas(style, n):
    x = _ticks(n, style, seed=n)
    want = np.asarray(ref_de.delta_zigzag(jnp.asarray(x), interpret=True))
    got = de.delta_zigzag(_to_t(x.view(np.int32))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 5, 257])
def test_uvarint_encode64_matches_pallas(n):
    v = _ragged_u64(n, seed=n)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    want_lens, want_planes = ref_de.uvarint_encode64(
        jnp.asarray(lo), jnp.asarray(hi), interpret=True)
    lens, planes = de.uvarint_encode64(_to_t(v.view(np.int64)))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(want_planes).astype(np.uint8))
    # the edges land in their length classes: 1, 1, 2, 10, 10 bytes
    assert lens.numpy()[:5].tolist() == [1, 1, 2, 10, 10]


@pytest.mark.parametrize("c,r", [(1, 2), (5, 3), (257, 32), (4099, 6)])
def test_fit_columns_matches_pallas(c, r):
    V = _fit_matrix(c, r, seed=c)
    flags_w, d0_w = ref_de.fit_columns(jnp.asarray(V.astype(np.int32)),
                                       interpret=True)
    flags, d0 = de.fit_columns(_to_t(V))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(flags_w)[:c])
    np.testing.assert_array_equal(d0.numpy(), np.asarray(d0_w)[:c])


@pytest.mark.parametrize("c,r", [(1, 2), (64, 32), (4099, 3)])
def test_fit_columns_wide_values_match_reference(c, r):
    V = _fit_matrix(c, r, big=True, seed=c)
    V[0, :] = np.int64(1 << 61) + 3 * np.arange(r)   # near the int64 guard
    flags_w, d0_w = fit_columns_ref(V)
    flags, d0 = de.fit_columns(_to_t(V))
    np.testing.assert_array_equal(flags.numpy(), flags_w)
    np.testing.assert_array_equal(d0.numpy(), d0_w)
    assert flags.numpy()[0] == 2


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", LENGTHS)
def test_row_boundaries_matches_pallas(n, k):
    rng = np.random.RandomState(n * 10 + k)
    V = rng.randint(0, 3, size=(n, k)).astype(np.int64)
    want = np.asarray(ref_gs.row_boundaries(jnp.asarray(V.astype(np.int32)),
                                            interpret=True))
    got = gs.row_boundaries(_to_t(V)).numpy()
    np.testing.assert_array_equal(got.astype(np.int32), want)


@pytest.mark.parametrize("call,arg", [
    (de.delta_zigzag, torch.zeros(4, dtype=torch.int64)),       # dtype
    (de.delta_zigzag, torch.zeros((2, 2), dtype=torch.int32)),  # rank
    (de.uvarint_encode64, torch.zeros(4, dtype=torch.int32)),
    (de.fit_columns, torch.zeros((4, 1), dtype=torch.int64)),   # R < 2
    (gs.row_boundaries, torch.zeros((4, 3), dtype=torch.int64)[:, ::2]),
])
def test_wrappers_reject_bad_inputs(call, arg):
    with pytest.raises((TypeError, ValueError)):
        call(arg)


def test_cpu_wrappers_launch_nothing():
    _build.reset_launches()
    de.delta_zigzag(torch.arange(9, dtype=torch.int32))
    de.uvarint_encode64(torch.arange(9, dtype=torch.int64))
    de.fit_columns(torch.zeros((3, 4), dtype=torch.int64))
    gs.row_boundaries(torch.zeros((3, 2), dtype=torch.int64))
    assert _build.launch_counts() == {}


def test_launch_counts_survive_concurrent_threads():
    """ThreadComm ranks launch from many threads: no count may be lost."""
    import sys
    import threading
    n_threads, per_thread = 32, 2000
    _build.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch("k")
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.launch_counts() == {"k": n_threads * per_thread}
    _build.reset_launches()
