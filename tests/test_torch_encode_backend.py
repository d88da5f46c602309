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
from repro_torch.core.timestamps import compress_timestamps

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
