"""The port's read side against the JAX package's: ``TraceReader.view()``
and every ``TraceView`` query, ``refreshed_view``, ``analysis`` and
``converters``.

One seeded multi-rank streaming workload (ThreadComm ranks, three flushed
epochs and a clean finalize, so stitched, merged and tail reads all
exist) is written once by the reference Recorder and once by the port's.
Over each directory and in each mode, the reference reader and the port's
reader must give value-identical answers to every query, and the port's
``digram_counts`` must agree on every encode backend it offers on the CPU
(``python``, ``numpy``, ``torch``) with the reference's grammar walk.
"""

import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from repro.core import analysis as ref_analysis
from repro.core import comm as ref_comm
from repro.core import converters as ref_converters
from repro.core import reader as ref_reader
from repro.core import recorder as ref_recorder
from repro.core.specs import REGISTRY as REF_REGISTRY
from repro_torch.core import analysis as port_analysis
from repro_torch.core import comm as port_comm
from repro_torch.core import converters as port_converters
from repro_torch.core import encode_backend as eb
from repro_torch.core import reader as port_reader
from repro_torch.core import recorder as port_recorder
from repro_torch.core import traceview as port_traceview
from repro_torch.core.specs import REGISTRY as PORT_REGISTRY

REF = SimpleNamespace(rec=ref_recorder, comm=ref_comm, registry=REF_REGISTRY,
                      backend="numpy")
PORT = SimpleNamespace(rec=port_recorder, comm=port_comm,
                       registry=PORT_REGISTRY, backend="torch")
PORT_BACKENDS = ("python", "numpy", "torch")
NRANKS = 3
_PATHS = ("/data/a.bin", "/data/b.bin", "/data/c.bin")


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """Grammar and cfg_index packing follow the port's module default,
    which is ``cuda``: point it at the plain PyTorch versions."""
    monkeypatch.setattr(eb, "_default_backend", "torch")


def world_calls(seed, nranks, n_ops=24):
    """Per-rank call lists of one SPMD plan drawn from ``seed``: runs of
    pwrite/pread/lseek with rank-linear, constant and irregular offsets,
    plain writes and reads, metadata calls, and a few rank-conditional
    ops so that several unique CFGs appear.  Each call is
    ``(name, args, ret, depth)``."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n_ops):
        ops.append((rng.choice(["all"] * 5 + ["even", "first"]),
                    rng.choice(["pwrite", "pwrite", "pread", "lseek",
                                "write", "read", "stat", "fsync"]),
                    rng.choice([1, 3, 6, 50, 400]),            # run length
                    rng.choice(["linear", "constant", "irregular"]),
                    rng.randrange(1 << 20), rng.randrange(4096),
                    rng.choice([64, 600, 4096, 70000]),        # size
                    rng.randint(0, 1),                         # depth
                    [rng.randrange(1 << 20) for _ in range(nranks)],
                    rng.randrange(len(_PATHS))))
    world = []
    for rank in range(nranks):
        fd = f"fd-{rank}"
        calls = [("open", (_PATHS[rank % len(_PATHS)], 2, 0o644), fd, 0)]
        for cond, kind, n, style, base, coef, size, depth, irr, p in ops:
            if (cond == "even" and rank % 2) or (cond == "first" and rank):
                continue
            start = {"linear": base + rank * coef, "constant": base,
                     "irregular": irr[rank]}[style]
            for i in range(n if kind in ("pwrite", "pread", "lseek") else 1):
                off = start + i * size
                if kind == "pwrite":
                    calls.append(("pwrite", (fd, b"p" * size, off), size,
                                  depth))
                elif kind == "pread":
                    calls.append(("pread", (fd, size, off), b"r" * 8, depth))
                elif kind == "lseek":
                    calls.append(("lseek", (fd, off, 0), off, depth))
                elif kind == "write":
                    calls.append(("write", (fd, b"w" * size), size, depth))
                elif kind == "read":
                    calls.append(("read", (fd, size), b"r" * 8, depth))
                elif kind == "stat":
                    calls.append(("stat", (_PATHS[p],), 4096, 0))
                else:
                    calls.append(("fsync", (fd,), 0, 0))
        calls.append(("close", (fd,), 0, 0))
        world.append(calls)
    return world


def feed(pkg, rec, calls, rng, t):
    """Record ``calls`` with seeded ticks that sometimes overlap; returns
    the next tick."""
    for name, args, ret, depth in calls:
        t0 = t + rng.randrange(0, 40)
        t1 = t0 + rng.randrange(1, 60)
        rec.record(pkg.registry.id_of(name), args, ret, depth, t0, t1)
        t = t0 + rng.randrange(1, 30)
    return t


def write_world(pkg, trace_dir, seed, nranks=NRANKS, epochs=3):
    """Every rank records its calls in ``epochs`` flushed chunks, then all
    finalize: the directory holds ``epochs`` segments and a merged trace."""
    world = world_calls(seed, nranks)

    def worker(comm, rank):
        rec = pkg.rec.Recorder(rank=rank, config=pkg.rec.RecorderConfig(
            trace_dir=trace_dir, encode_backend=pkg.backend))
        calls = world[rank]
        cuts = np.linspace(0, len(calls), epochs + 1).astype(int)
        rng, t = random.Random(seed * 31 + rank), 0
        for i in range(epochs):
            t = feed(pkg, rec, calls[cuts[i]:cuts[i + 1]], rng, t)
            if i < epochs - 1:
                rec.flush(comm)
        return rec.finalize(comm)

    pkg.comm.run_thread_world(nranks, worker)
    return trace_dir


def record_reprs(reader, rank):
    return [repr((r.func, r.args, r.ret, r.thread, r.depth, r.t_entry,
                  r.t_exit)) for r in reader.iter_records(rank)]


def answers(reader):
    """Every TraceView query of one reader, by name (``backend=None``: the
    grammar walk for ``digram_counts``)."""
    view = reader.view()
    ts = [view.timestamps(r) for r in range(reader.nranks)]
    ts = [t for t in ts if t is not None and len(t)]
    lo = int(min(t[:, 0].min() for t in ts))
    hi = int(max(t[:, 1].max() for t in ts))
    mid = (lo + hi) // 2
    out = {
        "io_summary": view.io_summary(),
        "size_histogram": view.size_histogram(),
        "size_histogram_edges": view.size_histogram(edges=(128, 1024)),
        "consistency_pairs": view.consistency_pairs(),
        "bandwidth_all": view.bandwidth_bounds(lo, hi + 1),
        "bandwidth_half": view.bandwidth_bounds(lo, mid),
        "total_records": view.total_records(),
        "total_terminal_counts": view.total_terminal_counts(),
        "digram_all": view.digram_counts(rank=None),
        "dfg": view.dfg(),
        "rank_divergence": view.rank_divergence(),
        "coverage": reader.coverage(),
    }
    for r in range(reader.nranks):
        out[r] = {
            "n_records": reader.n_records(r),
            "call_chains": view.call_chains(rank=r),
            "call_chains_lseek": view.call_chains(("lseek",), rank=r),
            "overlap": view.overlap_ratio(r),
            "overlap_window": view.overlap_ratio(r, t0=lo, t1=mid),
            "digrams": view.digram_counts(r),
            "dfg": view.dfg(r),
            "phases": view.phases(r),
            "records": record_reprs(reader, r),
            "records_no_ts": [repr((x.func, x.args, x.ret)) for x in
                              reader.iter_records(r, timestamps=False)],
        }
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    base = tmp_path_factory.mktemp("worlds")
    old = eb.default_backend()
    eb.set_default_backend("torch")       # as cpu_default, for this scope
    try:
        return {name: write_world(pkg, str(base / name), seed=7)
                for name, pkg in (("ref", REF), ("port", PORT))}
    finally:
        eb.set_default_backend(old)


def test_port_writes_the_reference_segments(worlds):
    """The two writers' directories hold the same segment files, so the
    read-side comparisons below run over equal inputs as well."""
    names = sorted(os.listdir(worlds["ref"]))
    assert names == sorted(os.listdir(worlds["port"]))
    assert sum(n.startswith("epoch_") for n in names) == 3
    for d in names:
        p = os.path.join(worlds["port"], d)
        if os.path.isdir(p):
            for f in sorted(os.listdir(p)):
                if f.endswith(".bin"):
                    with open(p + "/" + f, "rb") as a, open(
                            os.path.join(worlds["ref"], d, f), "rb") as b:
                        assert a.read() == b.read(), (d, f)


@pytest.mark.parametrize("mode", ["stitched", "merged", "tail"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_every_query_matches_reference(worlds, writer, mode):
    d = worlds[writer]
    got = answers(port_reader.TraceReader(d, mode=mode))
    want = answers(ref_reader.TraceReader(d, mode=mode))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert sum(got[r]["n_records"] for r in range(NRANKS)) \
        == got["total_records"] > 0


@pytest.mark.parametrize("mode", ["stitched", "merged"])
def test_digram_counts_every_backend(worlds, mode):
    """The expansion path of every CPU backend equals the reference's
    grammar walk and its numpy expansion, per rank and aggregated."""
    port = port_reader.TraceReader(worlds["port"], mode=mode).view()
    ref = ref_reader.TraceReader(worlds["port"], mode=mode).view()
    for rank in list(range(NRANKS)) + [None]:
        want = ref.digram_counts(rank)
        assert ref.digram_counts(rank, backend="numpy") == want
        for b in PORT_BACKENDS:
            assert port.digram_counts(rank, backend=b) == want, (rank, b)
        if rank is not None:
            assert sum(want.values()) == port.n_records(rank) - 1


def test_reader_shims_go_through_the_view(worlds, monkeypatch):
    reader = port_reader.TraceReader(worlds["port"])
    view = reader.view()
    assert reader.view() is view
    calls = []
    real = port_traceview.TraceView.iter_records
    monkeypatch.setattr(port_traceview.TraceView, "iter_records",
                        lambda self, *a, **k: (calls.append(a) or
                                              real(self, *a, **k)))
    n = sum(1 for _ in reader.all_records(timestamps=False))
    assert n == view.total_records()
    assert len(calls) == NRANKS


def test_refreshed_view_matches_fresh_view(tmp_path, monkeypatch):
    """A live stitched reader folds each committed epoch into its built
    view with ``refreshed_view``; after every epoch the folded view
    answers every query as a from-scratch port view and reference view
    over the same directory do."""
    sd = str(tmp_path / "live")
    (calls,) = world_calls(11, 1, n_ops=30)
    cuts = [0, 15, 30, 45, len(calls)]
    rec = port_recorder.Recorder(rank=0, config=port_recorder.RecorderConfig(
        trace_dir=sd, encode_backend="torch"))
    rng = random.Random(5)
    t = feed(PORT, rec, calls[:cuts[1]], rng, 0)
    rec.flush()
    reader = port_reader.TraceReader(sd, mode="stitched")
    answers(reader)                       # build and warm the view's memos
    folds = []
    real = port_traceview.refreshed_view
    monkeypatch.setattr(port_traceview, "refreshed_view",
                        lambda v, r, f: (folds.append(len(f)) or
                                         real(v, r, f)))
    for i in range(1, len(cuts) - 1):
        before = reader.view()
        t = feed(PORT, rec, calls[cuts[i]:cuts[i + 1]], rng, t)
        rec.flush()
        assert reader.refresh() == 1
        assert folds == [1] * i
        assert reader.view() is not before
        got = answers(reader)
        assert got == answers(port_reader.TraceReader(sd, mode="stitched"))
        assert got == answers(ref_reader.TraceReader(sd, mode="stitched"))
    rec.finalize()


def test_analysis_matches_reference(worlds):
    d = worlds["port"]
    pr, rr = port_reader.TraceReader(d), ref_reader.TraceReader(d)
    for p, r in ((pr, rr), (pr.view(), rr.view())):
        assert port_analysis.io_summary(p) == ref_analysis.io_summary(r)
        assert (port_analysis.size_histogram(p, edges=(128, 1024))
                == ref_analysis.size_histogram(r, edges=(128, 1024)))
        for rank in range(NRANKS):
            assert (port_analysis.call_chains(p, rank=rank)
                    == ref_analysis.call_chains(r, rank=rank))
            assert (port_analysis.overlap_ratio(p, rank)
                    == ref_analysis.overlap_ratio(r, rank))
        assert (port_analysis.consistency_pairs(p)
                == ref_analysis.consistency_pairs(r))


def _tree_bytes(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_converters_match_reference(worlds, tmp_path, writer):
    d = worlds[writer]
    n_port = port_converters.to_chrome_timeline(d, str(tmp_path / "p.json"))
    n_ref = ref_converters.to_chrome_timeline(d, str(tmp_path / "r.json"))
    assert n_port == n_ref > 0
    with open(tmp_path / "p.json") as a, open(tmp_path / "r.json") as b:
        assert json.load(a) == json.load(b)
    sizes = port_converters.to_columnar(d, str(tmp_path / "pc"))
    assert sizes == ref_converters.to_columnar(d, str(tmp_path / "rc"))
    assert _tree_bytes(tmp_path / "pc") == _tree_bytes(tmp_path / "rc")
    got = port_converters.read_columnar(str(tmp_path / "pc"))
    want = ref_converters.read_columnar(str(tmp_path / "rc"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
