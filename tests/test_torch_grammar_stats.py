"""The redesigned symbol-stream kernels' plain versions against the JAX
package: ``digram_counts`` (the distinct pair codes of a terminal stream
and their counts) and ``row_run_starts`` (the rows that start a run,
optionally over the rows' first difference).

On the CPU the wrappers run their plain PyTorch versions; each must equal
what the JAX package computes on the same numpy inputs -- its
``digram_histogram`` and ``row_boundaries`` paths and its Pallas kernels
in interpret mode -- exactly, since all of them are integer maps.  The
``cuda`` route of the batched pattern encoders is run through a stand-in
card whose tensors stay on the CPU.  ``test_torch_cuda.py`` holds the CUDA
kernels against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encode_backend as ref_eb
from repro.core.interprocess import arith_segments as ref_arith
from repro.core.patterns import IntraPatternTracker as RefTracker
from repro.core.sequitur import Sequitur as RefSequitur
from repro.kernels.grammar_stats import ops as ref_gs
from repro_torch.core import encode_backend as eb
from repro_torch.core.interprocess import arith_segments
from repro_torch.core.patterns import IntraPatternTracker
from repro_torch.core.sequitur import Sequitur
from repro_torch.kernels import _build
from repro_torch.kernels.grammar_stats import ops as gs
from repro_torch.kernels.grammar_stats.ref import (digram_counts_ref,
                                                   row_run_starts_ref)

DIGRAM_LENGTHS = [0, 1, 2, 3, 257, 4099]
# 241 is the largest T whose T^2 counters fit in a block's shared memory
# on the H100 (the dense route), 242 the smallest past it; 2^20 makes
# codes past 2^31
TERMINALS = [1, 6, 241, 242, 1 << 20]
DENSE_SIDE = [1, 6, 241, 242]       # codes within the Pallas kernel's int32
I64_MAX = (1 << 63) - 1


def _stream(n, T, seed):
    """int64 terminals in [0, T): runs of IOR's two hot terminals, then
    uniform values, so some codes repeat and some are rare."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, T, size=n).astype(np.int64)
    s[: n // 2: 2] = 0
    s[1: n // 2: 2] = T - 1
    return s


def _dict(codes, counts, T):
    return {(c // T, c % T): k
            for c, k in zip(codes.tolist(), counts.tolist())}


@pytest.mark.parametrize("T", TERMINALS)
@pytest.mark.parametrize("n", DIGRAM_LENGTHS)
def test_digram_counts_matches_python_path(n, T):
    """Every distinct pair and its count, against the JAX package's scalar
    walk; the codes come out in increasing order."""
    s = _stream(n, T, seed=n + T)
    codes, counts = gs.digram_counts(torch.from_numpy(s), T)
    assert codes.dtype == counts.dtype == torch.int64
    assert bool((codes[1:] > codes[:-1]).all())
    assert _dict(codes, counts, T) == ref_eb.digram_histogram(s, T, "python")
    assert int(counts.sum()) == max(0, n - 1)


@pytest.mark.parametrize("T", DENSE_SIDE)
@pytest.mark.parametrize("n", DIGRAM_LENGTHS)
def test_digram_counts_matches_numpy_path_in_key_order(n, T):
    """The JAX package's ``numpy`` path bincounts the codes: the same
    pairs, in the same order, as the port's ``torch`` dispatch."""
    s = _stream(n, T, seed=3 * n + T)
    want = ref_eb.digram_histogram(s, T, "numpy")
    codes, counts = digram_counts_ref(torch.from_numpy(s), T)
    assert list(_dict(codes, counts, T).items()) == list(want.items())
    assert list(eb.digram_histogram(s, T, "torch").items()) \
        == list(want.items())


@pytest.mark.parametrize("T", DENSE_SIDE)
@pytest.mark.parametrize("n", DIGRAM_LENGTHS[1:])
def test_digram_counts_matches_pallas_codes(n, T):
    """``np.unique`` over the codes of ``digram_codes_pallas`` (interpret
    mode; its -1 at position 0 dropped) gives the same codes and counts."""
    s = _stream(n, T, seed=5 * n + T)
    pallas = np.asarray(ref_gs.digram_codes(jnp.asarray(s.astype(np.int32)),
                                            T, interpret=True))
    want_codes, want_counts = np.unique(pallas[1:].astype(np.int64),
                                        return_counts=True)
    codes, counts = gs.digram_counts(torch.from_numpy(s), T)
    np.testing.assert_array_equal(codes.numpy(), want_codes)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


@pytest.mark.parametrize("bad", [-1, 6, 1 << 40, -(1 << 62)])
@pytest.mark.parametrize("where", [0, 1, 2, 100])
def test_digram_counts_raise_on_a_value_out_of_range(bad, where):
    """A value outside [0, T) anywhere -- even in a stream too short to
    have a pair -- raises instead of giving wrong counts."""
    s = _stream(max(where + 1, 1), 6, seed=where)
    s[where] = bad
    with pytest.raises(ValueError, match="outside"):
        gs.digram_counts(torch.from_numpy(s), 6)
    if len(s) >= 2:
        with pytest.raises(ValueError, match="outside"):
            eb.digram_histogram(s, 6, "torch")


@pytest.mark.parametrize("call", [
    lambda: gs.digram_counts(torch.zeros(4, dtype=torch.int64), 0),
    lambda: gs.digram_counts(torch.zeros(4, dtype=torch.int64),
                             gs.MAX_TERMINALS + 1),
    lambda: gs.digram_counts(torch.zeros(4, dtype=torch.int32), 4),
    lambda: gs.digram_counts(torch.zeros((2, 2), dtype=torch.int64), 4),
    lambda: gs.row_run_starts(torch.zeros((4, 0), dtype=torch.int64)),
    lambda: gs.row_run_starts(torch.zeros((1, 2), dtype=torch.int64),
                              diff=True),
    lambda: gs.row_run_starts(torch.zeros((4, 3), dtype=torch.int64)[:, ::2]),
    lambda: gs.row_run_starts(torch.zeros(4, dtype=torch.int64)),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()


def _rows(n, k, seed):
    """(n, k) int64 rows in runs of 1 to 7 equal rows."""
    rng = np.random.RandomState(seed)
    reps = rng.randint(1, 8, size=n)
    vals = rng.randint(0, 3, size=(n, k))
    return np.repeat(vals, reps, axis=0)[:n].astype(np.int64)


@pytest.mark.parametrize("n,k", [(1, 1), (257, 1), (4099, 2), (65535, 3)])
def test_row_run_starts_matches_pallas(n, k):
    """The starts are ``np.flatnonzero`` of ``row_boundaries_pallas``'s
    mask (interpret mode)."""
    V = _rows(n, k, seed=n + k)
    mask = np.asarray(ref_gs.row_boundaries(jnp.asarray(V.astype(np.int32)),
                                            interpret=True))
    got = gs.row_run_starts(torch.from_numpy(V))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.flatnonzero(mask))


def _arith_rows(n, k, seed, huge):
    """(n, k) int64 rows of arithmetic runs, random rows and constant
    runs; with ``huge`` the values lie near +-2^63, so the differences
    wrap."""
    rng = np.random.RandomState(seed)
    parts, left = [], n
    while left > 0:
        m = min(left, int(rng.randint(1, 40)))
        kind = rng.randint(3)
        base = rng.randint(-1000, 1000, size=k)
        if kind == 0:
            stride = rng.randint(-9, 9, size=k)
            parts.append(base + np.arange(m)[:, None] * stride)
        elif kind == 1:
            parts.append(rng.randint(-5, 5, size=(m, k)))
        else:
            parts.append(np.repeat(base[None, :], m, axis=0))
        left -= m
    V = np.concatenate(parts).astype(np.int64)
    if huge:
        V += np.where(rng.rand(n, k) < 0.5, I64_MAX - 2000,
                      -I64_MAX + 2000).astype(np.int64)
        V[n // 2:, 0] = I64_MAX - 3 * np.arange(n - n // 2) % 7
    return V


@pytest.mark.parametrize("huge", [False, True])
@pytest.mark.parametrize("n,k", [(2, 1), (3, 2), (257, 1), (4099, 2),
                                 (4099, 5)])
def test_row_run_starts_diff_matches_arith_segments(n, k, huge):
    """``diff=True`` finds the change points that the JAX package's
    ``arith_segments`` scans for -- the row-change mask over ``V[1:] -
    V[:-1]``, which wraps as NumPy's int64 does -- and the port's
    segments, taken from them, equal the reference's."""
    V = _arith_rows(n, k, seed=n * k + huge, huge=huge)
    with np.errstate(over="ignore"):
        d = V[1:] - V[:-1]
    want = np.flatnonzero(ref_eb.run_boundaries(d, "python"))
    np.testing.assert_array_equal(
        row_run_starts_ref(torch.from_numpy(V), diff=True).numpy(), want)
    np.testing.assert_array_equal(
        gs.row_run_starts(torch.from_numpy(V), diff=True).numpy(), want)
    for backend in ("python", "numpy", "torch"):
        assert arith_segments(V, backend) == ref_arith(V, "python")


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("backend", ["python", "numpy", "torch"])
@pytest.mark.parametrize("n,k", [(0, 1), (1, 1), (2, 2), (1023, 1),
                                 (1025, 3)])
def test_run_starts_backends_agree(n, k, backend, diff):
    """``encode_backend.run_starts`` is ``flatnonzero`` of the JAX
    package's mask on every backend, over the rows or their difference."""
    V = _arith_rows(max(n, 1), k, seed=n + k, huge=False)[:n]
    rows = V[1:] - V[:-1] if diff else V
    want = (np.flatnonzero(ref_eb.run_boundaries(rows, "python"))
            if len(rows) else np.zeros(0, np.int64))
    got = eb.run_starts(V, backend, diff=diff)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def card_on_cpu(monkeypatch):
    """A stand-in card: ``cuda`` resolves, its tensors stay on the CPU so
    the wrappers run their plain versions, grammars serialize on it, and
    every grammar_stats wrapper call is counted as a launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(eb, "_to_device",
                        lambda a, b: torch.from_numpy(np.ascontiguousarray(a)))
    for name in ("row_boundaries", "row_run_starts", "digram_codes",
                 "digram_counts", "histogram"):
        real = getattr(gs, name)
        monkeypatch.setattr(gs, name, lambda *a, _r=real, _n=name, **kw: (
            _build.count_launch(_n) or _r(*a, **kw)))
    _build.reset_launches()
    yield
    _build.reset_launches()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_run", [1, 3, 9])
def test_push_stream_on_cuda_matches_reference(card_on_cpu, seed, max_run):
    """The grammar built from runs found on the card equals the JAX
    package's, built from per-run pushes; one launch a stream."""
    rng = np.random.RandomState(seed)
    stream = np.repeat(rng.randint(0, 5, size=400),
                       rng.randint(1, max_run + 1, size=400)).tolist()
    ref = RefSequitur()
    ref.push_stream(stream, backend="python")
    s = Sequitur()
    s.push_stream(stream, backend="cuda")
    assert _build.launch_counts() == {"row_run_starts": 1}
    assert s.serialize() == ref.serialize()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_encode_many_on_cuda_matches_reference(card_on_cpu, seed, k):
    """``encode_many`` on ``cuda`` segments its rows from the change
    points found on the card (one launch, the differences taken there)
    and gives the JAX package's encodings and run state."""
    V = _arith_rows(600, k, seed=seed + 10 * k, huge=False)
    rows = [tuple(int(v) for v in r) for r in V]
    ref = RefTracker()
    want = ref.encode_many("k", rows, backend="python")
    tr = IntraPatternTracker()
    got = tr.encode_many("k", rows, backend="cuda")
    assert _build.launch_counts() == {"row_run_starts": 1}
    assert repr(got) == repr(want)
    assert ({key: vars(v) for key, v in tr._runs.items()}
            == {key: vars(v) for key, v in ref._runs.items()})


@pytest.mark.parametrize("T", [6, 300])
def test_digram_histogram_on_cuda_launches_digram_counts(card_on_cpu, T):
    """The read side's digram dispatch on ``cuda`` goes through one
    ``digram_counts`` call, never ``digram_codes``, and gives the JAX
    package's ``numpy`` path's keys in the same order."""
    s = _stream(5000, T, seed=T)
    got = eb.digram_histogram(s, T, "cuda")
    assert _build.launch_counts() == {"digram_counts": 1}
    assert list(got.items()) == list(
        ref_eb.digram_histogram(s, T, "numpy").items())
