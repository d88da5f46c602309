"""The port's encode backends against the JAX package's ``python`` backend.

Every CPU backend of ``repro_torch.core.encode_backend`` (``python``,
``numpy``, and ``torch`` -- the kernels' plain PyTorch versions) must
produce exactly what the reference's scalar ``python`` path produces, on
the same inputs made with numpy from a seed.  ``cuda`` must refuse to run
without a card instead of falling back to the host.
"""

import numpy as np
import pytest
import torch

from repro.core import encode_backend as ref_eb
from repro.core.encoding import pack_uvarints as ref_pack
from repro.core.interprocess import arith_segments as ref_arith
from repro.core.interprocess import batch_fit_columns as ref_fit
from repro.core.patterns import IntraPatternTracker as RefTracker
from repro.core.sequitur import Sequitur as RefSequitur
from repro_torch.core import encode_backend as eb
from repro_torch.core.encoding import VarintRangeError, pack_uvarints
from repro_torch.core.interprocess import arith_segments, batch_fit_columns
from repro_torch.core.patterns import IntraPatternTracker
from repro_torch.core.recorder import Recorder, RecorderConfig
from repro_torch.core.sequitur import Sequitur
from repro_torch.core.timestamps import (compress_timestamps,
                                         compress_timestamps_blocked)

CPU_BACKENDS = ["python", "numpy", "torch"]


def _flat_ticks(n, seed):
    rng = np.random.RandomState(seed)
    flat = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
    flat[:n // 2] = np.sort(flat[:n // 2])                # monotone half
    if n > 4:
        flat[1:4] = flat[0]                               # zero deltas
        flat[-1], flat[-2] = 0, (1 << 32) - 1             # extremes
    return flat.astype(np.int64)


def _ragged_u64(n, seed):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 65, size=n)
    return [(int(rng.randint(0, 1 << 32, dtype=np.uint64))
             | (1 << max(0, int(b) - 1))) & ((1 << 64) - 1) if b else 0
            for b in bits]


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("n", [1, 5, 257, 4099])
def test_delta_zigzag_matches_reference(backend, n):
    flat = _flat_ticks(n, seed=n)
    want = ref_eb.delta_zigzag(flat, "python")
    got = eb.delta_zigzag(flat, backend)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_compress_timestamps_matches_reference(backend):
    from repro.core.timestamps import compress_timestamps as ref_compress
    ticks = _flat_ticks(2 * 600, seed=3).astype(np.uint32).reshape(-1, 2)
    assert (compress_timestamps(ticks, backend=backend)
            == ref_compress(ticks, backend="python"))


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("segment", [1, 3, 4, 7, 4096, 5000])
def test_delta_zigzag_segments_match_reference(backend, segment):
    """``segment`` restarts the deltas at every multiple of it: the result
    is the reference's ``python`` path run on each segment alone."""
    flat = _flat_ticks(4099, seed=segment)
    want = np.concatenate([ref_eb.delta_zigzag(flat[s:s + segment], "python")
                           for s in range(0, len(flat), segment)])
    got = eb.delta_zigzag(flat.astype(np.uint32), backend, segment)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


N_TS_RECORDS = 4500


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("ncols", [2, 3])
@pytest.mark.parametrize("block_records", [1, 7, 4096, N_TS_RECORDS + 1])
def test_compress_timestamps_blocked_matches_reference(backend, ncols,
                                                       block_records):
    """A flush's blocks, all encoded in one segmented ``delta_zigzag``
    call, equal the JAX package's blocks, each encoded on its own; (n, 2)
    entry/exit and (n, 3) sized ticks, one record a block up to one block
    for all."""
    from repro.core.timestamps import (
        compress_timestamps_blocked as ref_blocked)
    ticks = _flat_ticks(N_TS_RECORDS * ncols, seed=ncols * 31
                        + block_records).astype(np.uint32).reshape(-1, ncols)
    want = ref_blocked(ticks, block_records, backend="python")
    got = compress_timestamps_blocked(ticks, block_records, backend=backend)
    assert len(got) == -(-N_TS_RECORDS // block_records)
    assert got == want


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("n", [1, 3, 100, 2048])
def test_pack_uvarints_matches_reference(backend, n):
    vals = [0, 127, 128, 1 << 63, (1 << 64) - 1] + _ragged_u64(n, seed=n)
    assert pack_uvarints(vals, backend=backend) == ref_pack(vals,
                                                            backend="python")


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("bad", [-1, 1 << 64])
def test_pack_uvarints_range_guard(backend, bad):
    with pytest.raises(VarintRangeError):
        pack_uvarints([0, 5, bad, 7], backend=backend)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("big", [False, True])
def test_fit_classify_matches_reference(backend, big):
    rng = np.random.RandomState(7)
    base = (1 << 40) if big else 0
    V = np.concatenate([
        np.full((20, 16), base + 5),                              # constant
        base + 3 + np.arange(16)[None, :] * rng.randint(1, 9, (20, 1)),
        base + rng.randint(-999, 999, size=(20, 16)),             # no fit
    ]).astype(np.int64)
    want = ref_eb.fit_classify(V, "numpy")
    got = eb.fit_classify(V, backend)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(1, 2), (6, 32), (60, 16)])
def test_fit_classify_asks_the_wrapper_once(monkeypatch, shape):
    """The ``torch`` fit makes one ``fit_columns`` call over the whole
    matrix and brings both of its outputs back through ``fit_to_host``
    once; the ``numpy`` fit calls neither."""
    from repro_torch.kernels.delta_encode import ops as de
    calls = []
    for name in ("fit_columns", "fit_to_host"):
        real = getattr(de, name)
        monkeypatch.setattr(
            de, name, lambda *a, _r=real, _n=name: (calls.append(_n),
                                                    _r(*a))[1])
    rng = np.random.RandomState(shape[0])
    V = rng.randint(-3, 3, size=shape).astype(np.int64)
    V[0] = 4 + 5 * np.arange(shape[1])
    got = eb.fit_classify(V, "torch")
    assert calls == ["fit_columns", "fit_to_host"]
    for w, g in zip(ref_eb.fit_classify(V, "numpy"), got):
        np.testing.assert_array_equal(g, w)
    calls.clear()
    eb.fit_classify(V, "numpy")
    assert calls == []


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("n_cols,n_ranks", [(1, 2), (40, 8), (300, 16)])
def test_batch_fit_columns_matches_reference(backend, n_cols, n_ranks):
    rng = np.random.RandomState(n_cols)
    cols = []
    for i in range(n_cols):
        kind = i % 3
        if kind == 0:
            cols.append([int(rng.randint(-50, 50))] * n_ranks)
        elif kind == 1:
            a, b = int(rng.randint(1, 9)), int(rng.randint(-99, 99))
            cols.append([b + r * a + (1 << 33) for r in range(n_ranks)])
        else:
            cols.append([int(v) for v in rng.randint(-1000, 1000,
                                                     size=n_ranks)])
    # the two packages' RankPattern classes differ: compare their reprs
    assert repr(batch_fit_columns(cols, backend=backend)) == repr(ref_fit(
        cols, backend="python"))


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", [1, 2, 129, 4099])
def test_run_boundaries_matches_reference(backend, n, k):
    V = np.random.RandomState(n + k).randint(0, 4, size=(n, k))
    V = V.astype(np.int64) + ((1 << 35) if k == 3 else 0)
    np.testing.assert_array_equal(eb.run_boundaries(V, backend),
                                  ref_eb.run_boundaries(V, "python"))


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_arith_segments_matches_reference(backend, k):
    rng = np.random.RandomState(k)
    V = np.concatenate([
        np.arange(50)[:, None] * rng.randint(1, 5, size=k)[None, :] + 7,
        rng.randint(-100, 100, size=(17, k)),
        np.full((31, k), 42),
    ]).astype(np.int64)
    assert arith_segments(V, backend=backend) == ref_arith(V,
                                                           backend="python")


@pytest.fixture
def cpu_default(monkeypatch):
    """Grammar serialization follows the module default, which is
    ``cuda``: point it at the plain PyTorch versions on the CPU."""
    monkeypatch.setattr(eb, "_default_backend", "torch")


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_push_stream_matches_reference(backend, cpu_default):
    rng = np.random.RandomState(5)
    stream = np.repeat(rng.randint(0, 6, size=300),
                       rng.randint(1, 9, size=300)).tolist()
    ref = RefSequitur()
    ref.push_stream(stream, backend="python")
    s = Sequitur()
    s.push_stream(stream, backend=backend)
    assert s.serialize() == ref.serialize()


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_encode_many_matches_reference(backend):
    rng = np.random.RandomState(9)
    rows = ([(i * 8, 0) for i in range(60)]
            + [(5, 1), (9, 1), (13, 1)]
            + [(int(v), 2) for v in rng.randint(0, 99, size=20)])
    ref_tr = RefTracker()
    want = ref_tr.encode_many("k", rows, backend="python")
    tr = IntraPatternTracker()
    got = tr.encode_many("k", rows, backend=backend)
    assert repr(got) == repr(want)
    assert ({k: vars(v) for k, v in tr._runs.items()}
            == {k: vars(v) for k, v in ref_tr._runs.items()})


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("n", [0, 1, 7, 1024, 4099])
def test_encode_ticks_varint_matches_reference(backend, n):
    ticks = _flat_ticks(n, seed=n + 2)
    want = ref_eb.encode_ticks_varint(ticks, "python")
    assert eb.encode_ticks_varint(ticks, backend) == want
    # the stream is the uvarint coding of the zigzag deltas
    zz = eb.delta_zigzag(ticks, "python") if n else []
    assert want == ref_pack([int(v) for v in zz], backend="python")


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("n,n_bins", [(0, 3), (1, 4), (1000, 7),
                                      (5000, 64), (4099, 4096)])
def test_terminal_histogram_matches_reference(backend, n, n_bins):
    rng = np.random.RandomState(n + n_bins)
    stream = rng.randint(-2, n_bins + 3, size=n).astype(np.int64)
    want = ref_eb.terminal_histogram(stream, n_bins, "python")
    got = eb.terminal_histogram(stream, n_bins, backend)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("n,T", [(0, 3), (1, 3), (2, 1), (2000, 5),
                                 (4097, 40)])
def test_digram_histogram_matches_reference(backend, n, T):
    stream = np.random.RandomState(n * 3 + T).randint(
        0, T, size=n).astype(np.int64)
    want = ref_eb.digram_histogram(stream, T, "python")
    assert eb.digram_histogram(stream, T, backend) == want
    assert sum(want.values()) == max(0, n - 1)


@pytest.fixture
def card_on_cpu(monkeypatch):
    """A stand-in card: ``cuda`` resolves, and its tensors stay on the CPU
    so the wrappers run their plain versions; records each wrapper call."""
    from repro_torch.kernels.delta_encode import ops as de
    from repro_torch.kernels.grammar_stats import ops as gs
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(eb, "_to_device",
                        lambda a, b: torch.from_numpy(np.ascontiguousarray(a)))
    for mod, name in ((de, "delta_zigzag_varint"), (gs, "histogram"),
                      (gs, "digram_codes"), (gs, "digram_counts"),
                      (gs, "row_boundaries"), (gs, "row_run_starts"),
                      (de, "delta_zigzag"), (de, "uvarint_pack64"),
                      (de, "uvarint_encode64")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.append(_n) or _r(*a)))
    return calls


def test_cuda_route_takes_the_kernels_at_any_width(card_on_cpu):
    """``cuda`` hands values at or above 2^31 to the kernels, never to
    NumPy, and its answers equal the reference's ``python`` path."""
    big = np.asarray([(1 << 40) + 5, 3, (1 << 40) + 5, 1 << 33, 3, -7],
                     np.int64)
    np.testing.assert_array_equal(
        eb.terminal_histogram(big, 8, "cuda"),
        ref_eb.terminal_histogram(big, 8, "python"))
    T = 1 << 20                                       # codes pass 2^31
    s = np.random.RandomState(0).randint(0, T, size=3000).astype(np.int64)
    assert (eb.digram_histogram(s, T, "cuda")
            == ref_eb.digram_histogram(s, T, "python"))
    ticks = _flat_ticks(3000, seed=9)
    assert (eb.encode_ticks_varint(ticks, "cuda")
            == ref_eb.encode_ticks_varint(ticks, "python"))
    assert card_on_cpu == ["histogram", "digram_counts",
                           "delta_zigzag_varint"]


def test_cuda_route_finds_run_starts_on_the_card(card_on_cpu):
    """``push_stream`` and ``arith_segments`` on ``cuda`` take their run
    starts from one ``row_run_starts`` call each (``arith_segments`` with
    the row differences taken by the wrapper), never ``row_boundaries``;
    the grammar and the segments equal the reference's."""
    rng = np.random.RandomState(8)
    stream = np.repeat(rng.randint(0, 9, size=700),
                       rng.randint(1, 6, size=700)).tolist()
    ref_s, s = RefSequitur(), Sequitur()
    ref_s.push_stream(stream, backend="python")
    s.push_stream(stream, backend="cuda")
    V = np.concatenate([np.arange(0, 900, 3), rng.randint(0, 4, size=200),
                        np.full(50, 7)]).astype(np.int64).reshape(-1, 1)
    V = np.concatenate([V, V // 2], axis=1)
    assert arith_segments(V, "cuda") == ref_arith(V, "python")
    assert card_on_cpu == ["row_run_starts", "row_run_starts"]
    assert s.serialize() == ref_s.serialize()


def test_cuda_route_packs_and_encodes_a_flush_in_one_call(card_on_cpu):
    """``cuda`` packs a varint batch with one ``uvarint_pack64`` call (no
    byte planes, no host scatter) and encodes every block of a flush with
    one segmented ``delta_zigzag`` call; the bytes equal the reference's."""
    from repro.core.timestamps import (
        compress_timestamps_blocked as ref_blocked)
    vals = [0, 127, 128, 1 << 63, (1 << 64) - 1] + _ragged_u64(3000, seed=4)
    assert pack_uvarints(vals, backend="cuda") == ref_pack(vals,
                                                           backend="python")
    assert card_on_cpu == ["uvarint_pack64"]
    ticks = _flat_ticks(3 * 4500, seed=5).astype(np.uint32).reshape(-1, 3)
    got = compress_timestamps_blocked(ticks, 512, backend="cuda")
    assert len(got) == 9
    assert got == ref_blocked(ticks, 512, backend="python")
    assert card_on_cpu == ["uvarint_pack64", "delta_zigzag"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_backend_raises_without_card(no_card):
    flat = np.arange(10, dtype=np.int64)
    with pytest.raises(RuntimeError, match="CUDA device"):
        eb.delta_zigzag(flat, "cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        pack_uvarints(list(range(100)), backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        eb.fit_classify(np.zeros((3, 4), np.int64), "cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        eb.run_boundaries(np.zeros((3, 1), np.int64), "cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        eb.encode_ticks_varint(flat, "cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        eb.terminal_histogram(flat, 4, "cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        eb.digram_histogram(flat, 10, "cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Recorder(config=RecorderConfig(encode_backend="cuda"))


def test_cuda_is_the_default(no_card):
    assert eb.default_backend() == "cuda"
    assert RecorderConfig().encode_backend == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        Sequitur().serialize()          # follows the module default


def test_resolve_auto_crossover(no_card, monkeypatch):
    assert eb.resolve("python", 10 ** 9) == "python"
    assert eb.resolve("auto", 1) == "python"
    assert eb.resolve("auto", eb.CUDA_MIN_BATCH) == "numpy"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert eb.resolve("auto", eb.CUDA_MIN_BATCH) == "cuda"
    assert eb.resolve("auto", eb.CUDA_MIN_BATCH - 1) == "numpy"
    with pytest.raises(ValueError):
        eb.resolve("pallas", 10)
