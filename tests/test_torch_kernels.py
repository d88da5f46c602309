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

from repro.core.encoding import pack_uvarints as ref_pack
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


@pytest.mark.parametrize("segment", [1, 2, 3, 4, 5, 64, 100])
@pytest.mark.parametrize("n", [1, 7, 257])
def test_delta_zigzag_segments_match_pallas_per_segment(n, segment):
    """With ``segment`` every segment is encoded from scratch: the result
    is the Pallas kernel's, run on each segment alone (segments of 1-5
    elements end inside one of the kernel's 4-value vectors)."""
    x = _ticks(n, "extreme", seed=n + segment)
    want = np.concatenate([
        np.asarray(ref_de.delta_zigzag(jnp.asarray(x[s:s + segment]),
                                       interpret=True))
        for s in range(0, n, segment)])
    got = de.delta_zigzag(_to_t(x.view(np.int32)), segment)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# a value of every varint length class 1..10: 7 k bits for k = 1..9, then
# 64 bits
PACK_CLASSES = [(1 << (7 * k)) - 1 for k in range(1, 10)] + [(1 << 64) - 1]


@pytest.mark.parametrize("n", [1, 63, 64, 32771])
def test_uvarint_pack64_matches_jax_pack_uvarints(n):
    """The packed stream of the plain version (the wrapper on CPU tensors)
    equals the JAX package's ``pack_uvarints`` byte for byte: values of
    every length class, 0, 2^63 and 2^64 - 1 lead, ragged values follow."""
    lead = [0, 1 << 63, (1 << 64) - 1] + PACK_CLASSES
    v = np.concatenate([np.asarray(lead, np.uint64),
                        _ragged_u64(n, seed=n)])[:n]
    got = de.uvarint_pack64(_to_t(v.view(np.int64)))
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == ref_pack([int(a) for a in v],
                                             backend="python")
    if n >= 63:
        lens, _ = de.uvarint_encode64(_to_t(v.view(np.int64)))
        assert set(lens.numpy().tolist()) == set(range(1, 11))


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


@pytest.mark.parametrize("c,r", [(1, 2), (3, 17), (6, 32), (257, 5)])
def test_fit_columns_splits_one_packed_output(c, r):
    """flags and d0 are views of one packed int64 tensor of C + ceil(C/2)
    words: d0 its first C words, the flags the C int32 after them, so
    ``fit_to_host`` can bring both to the host in one copy."""
    V = _to_t(_fit_matrix(c, r, seed=c + r))
    flags, d0 = de.fit_columns(V)
    assert flags.dtype == torch.int32 and d0.dtype == torch.int64
    assert flags.shape == d0.shape == (c,)
    assert d0.untyped_storage().data_ptr() == \
        flags.untyped_storage().data_ptr()
    assert flags.data_ptr() == d0.data_ptr() + 8 * c
    assert d0._base.shape == (de.packed_words(c),)
    packed = torch.empty(0, dtype=torch.int64).set_(
        d0.untyped_storage(), 0, (de.packed_words(c),))
    f2, d2 = de.split_fit(packed.clone(), c)
    assert torch.equal(f2, flags) and torch.equal(d2, d0)
    want_flags, want_d0 = fit_columns_ref(V.numpy())
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    np.testing.assert_array_equal(d0.numpy(), want_d0)
    hf, hd = de.fit_to_host(flags, d0)              # numpy, one copy
    assert hf.dtype == np.int32 and hd.dtype == np.int64
    np.testing.assert_array_equal(hf, want_flags)
    np.testing.assert_array_equal(hd, want_d0)
    with pytest.raises(ValueError):
        de.fit_to_host(flags.clone(), d0)


@pytest.mark.parametrize("c,r,offset", [(5, 7, 1), (33, 20, 3), (2, 2, 5)])
def test_fit_columns_takes_a_column_slice(c, r, offset):
    """Rows at a stride past their length (a column slice of a wider
    matrix, its rows off 16-byte alignment) give the slice's fit; a
    matrix whose values are not at stride 1 is refused."""
    W = _fit_matrix(c, r + offset, big=True, seed=r)
    V = _to_t(W)[:, offset:]
    assert not V.is_contiguous() or c == 1
    flags, d0 = de.fit_columns(V)
    want_flags, want_d0 = fit_columns_ref(np.ascontiguousarray(W[:, offset:]))
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    np.testing.assert_array_equal(d0.numpy(), want_d0)
    with pytest.raises(ValueError):
        de.fit_columns(_to_t(W)[:, ::2])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", LENGTHS)
def test_row_boundaries_matches_pallas(n, k):
    rng = np.random.RandomState(n * 10 + k)
    V = rng.randint(0, 3, size=(n, k)).astype(np.int64)
    want = np.asarray(ref_gs.row_boundaries(jnp.asarray(V.astype(np.int32)),
                                            interpret=True))
    got = gs.row_boundaries(_to_t(V)).numpy()
    np.testing.assert_array_equal(got.astype(np.int32), want)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("n", LENGTHS)
def test_delta_zigzag_varint_matches_pallas(style, n):
    x = _ticks(n, style, seed=n + 1)
    zz_w, lens_w, planes_w = ref_de.delta_zigzag_varint(jnp.asarray(x),
                                                        interpret=True)
    zz, lens, planes = de.delta_zigzag_varint(_to_t(x.view(np.int32)))
    np.testing.assert_array_equal(zz.numpy().view(np.uint32),
                                  np.asarray(zz_w))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_w))
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(planes_w).astype(np.uint8))
    assert planes.shape == (5, n)


def _symbols(n, hi, seed, outside=False):
    """int64 stream in [0, hi); with ``outside``, also negative values and
    values at or above ``hi``, which a histogram must ignore."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, hi, size=n).astype(np.int64)
    if outside and n:
        bad = rng.rand(n) < 0.2
        s[bad] = rng.choice([-1, -(1 << 40), hi, hi + 7, 1 << 40],
                            size=int(bad.sum()))
    return s


@pytest.mark.parametrize("n_bins", [1, 7, 64, 4096])
@pytest.mark.parametrize("n", LENGTHS)
def test_histogram_matches_pallas(n, n_bins):
    s = _symbols(n, n_bins, seed=n + n_bins, outside=True)
    # Pallas takes int32: keep the out-of-range values inside int32 there
    s32 = np.clip(s, -5, n_bins + 5).astype(np.int32)
    want = np.asarray(ref_gs.histogram(jnp.asarray(s32), n_bins,
                                       interpret=True))
    np.testing.assert_array_equal(
        gs.histogram(_to_t(s32.astype(np.int64)), n_bins).numpy(), want)
    got = gs.histogram(_to_t(s), n_bins)
    assert got.dtype == torch.int64 and got.shape == (n_bins,)
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(s[(s >= 0) & (s < n_bins)],
                                 minlength=n_bins))


@pytest.mark.parametrize("T", [1, 3, 40, 1000])
@pytest.mark.parametrize("n", LENGTHS)
def test_digram_codes_matches_pallas(n, T):
    s = _symbols(n, T, seed=n * 7 + T)
    want = np.asarray(ref_gs.digram_codes(jnp.asarray(s.astype(np.int32)),
                                          T, interpret=True))
    got = gs.digram_codes(_to_t(s), T)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_digram_codes_pass_int32():
    """T = 2^20: codes pass 2^31, where the Pallas kernel's int32 codes
    would wrap; the int64 plain version gives the exact products."""
    T = 1 << 20
    s = _symbols(4099, T, seed=3)
    got = gs.digram_codes(_to_t(s), T).numpy()
    assert got[0] == -1
    np.testing.assert_array_equal(got[1:], s[:-1] * T + s[1:])
    assert got.max() >= 1 << 31


@pytest.mark.parametrize("call,arg", [
    (de.delta_zigzag, torch.zeros(4, dtype=torch.int64)),       # dtype
    (de.delta_zigzag, torch.zeros((2, 2), dtype=torch.int32)),  # rank
    (de.uvarint_encode64, torch.zeros(4, dtype=torch.int32)),
    (de.uvarint_pack64, torch.zeros(4, dtype=torch.int32)),
    (de.uvarint_pack64, torch.zeros((2, 2), dtype=torch.int64)),
    (lambda x: de.delta_zigzag(x, -1), torch.zeros(4, dtype=torch.int32)),
    (de.fit_columns, torch.zeros((4, 1), dtype=torch.int64)),   # R < 2
    (gs.row_boundaries, torch.zeros((4, 3), dtype=torch.int64)[:, ::2]),
    (de.delta_zigzag_varint, torch.zeros(4, dtype=torch.int64)),
    (de.delta_zigzag_varint, torch.zeros(8, dtype=torch.int32)[::2]),
    (lambda x: gs.histogram(x, 4), torch.zeros(4, dtype=torch.int32)),
    (lambda x: gs.histogram(x, -1), torch.zeros(4, dtype=torch.int64)),
    (lambda x: gs.digram_codes(x, 4), torch.zeros((2, 2), dtype=torch.int64)),
    (lambda x: gs.digram_codes(x, 0), torch.zeros(4, dtype=torch.int64)),
])
def test_wrappers_reject_bad_inputs(call, arg):
    with pytest.raises((TypeError, ValueError)):
        call(arg)


def test_cpu_wrappers_launch_nothing():
    _build.reset_launches()
    de.delta_zigzag(torch.arange(9, dtype=torch.int32))
    de.uvarint_encode64(torch.arange(9, dtype=torch.int64))
    de.uvarint_pack64(torch.arange(9, dtype=torch.int64))
    de.delta_zigzag(torch.arange(9, dtype=torch.int32), 4)
    de.fit_columns(torch.zeros((3, 4), dtype=torch.int64))
    gs.row_boundaries(torch.zeros((3, 2), dtype=torch.int64))
    de.delta_zigzag_varint(torch.arange(9, dtype=torch.int32))
    gs.histogram(torch.arange(9, dtype=torch.int64), 4)
    gs.digram_codes(torch.arange(9, dtype=torch.int64), 9)
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


def test_thread_launch_counts_are_each_threads_own():
    """A thread's tally holds its own launches alone, whatever the threads
    beside it launch, and a reset of the counts leaves it running."""
    import threading
    start = threading.Barrier(8)
    seen = {}

    def body(i):
        before = _build.thread_launch_counts().get("k", 0)
        start.wait()
        for _ in range(100 * (i + 1)):
            _build.count_launch("k")
        seen[i] = _build.thread_launch_counts().get("k", 0) - before

    mine = _build.thread_launch_counts()
    _build.reset_launches()
    threads = [threading.Thread(target=body, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert seen == {i: 100 * (i + 1) for i in range(8)}
    assert _build.launch_counts() == {"k": 100 * 36}
    assert _build.thread_launch_counts() == mine
    _build.count_launch("k")
    _build.reset_launches()
    assert _build.thread_launch_counts().get("k", 0) == mine.get("k", 0) + 1
    _build.reset_launches()
