"""The port's write path as a whole against the JAX package's.

The same calls, with the same data directory and a deterministic clock,
go through ``repro`` and ``repro_torch`` Recorders; every ``*.bin`` file
the two write must be byte-identical:

- one rank through the ``posix`` facade (one-shot and streaming);
- a 6-rank ThreadComm IOR run (paper Listing 3) in tree and flat finalize
  (6 is deliberately not a power of two);

and each package's ``TraceReader`` must read the other's trace back to
the same records.  The rank-state blob that tree finalize ships between
hops must cross over byte for byte.  Finally, counting wrappers prove that
the Recorder's finalize really routes through the kernel wrappers.
"""

import hashlib
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from repro.core import comm as ref_comm
from repro.core import interprocess as ref_ip
from repro.core import recorder as ref_recorder
from repro.core import reader as ref_reader
from repro.core.apis import posix as ref_posix
from repro.core.specs import REGISTRY as REF_REGISTRY
from repro_torch.core import comm as port_comm
from repro_torch.core import encode_backend as eb
from repro_torch.core import interprocess as port_ip
from repro_torch.core import recorder as port_recorder
from repro_torch.core import reader as port_reader
from repro_torch.core.apis import posix as port_posix
from repro_torch.core.patterns import IntraPatternTracker
from repro_torch.core.sequitur import Sequitur
from repro_torch.core.specs import REGISTRY as PORT_REGISTRY
from repro_torch.kernels import _build
from repro_torch.kernels.delta_encode import ops as de_ops
from repro_torch.kernels.grammar_stats import ops as gs_ops

REF = SimpleNamespace(rec=ref_recorder, comm=ref_comm, posix=ref_posix,
                      reader=ref_reader, registry=REF_REGISTRY)
PORT = SimpleNamespace(rec=port_recorder, comm=port_comm, posix=port_posix,
                       reader=port_reader, registry=PORT_REGISTRY)


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """Grammar and cfg_index packing follow the port's module default,
    which is ``cuda``: point it at the plain PyTorch versions."""
    monkeypatch.setattr(eb, "_default_backend", "torch")


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t


def _bin_digest(tdir):
    """sha256 over every ``*.bin`` file under ``tdir`` (metadata JSON
    carries the pid and host, never trace bytes)."""
    h = hashlib.sha256()
    n = 0
    for root, _dirs, files in sorted(os.walk(tdir)):
        for name in sorted(files):
            if name.endswith(".bin"):
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    h.update(os.path.relpath(path, tdir).encode() + b"\0"
                             + f.read())
                n += 1
    assert n, f"no trace files under {tdir}"
    return h.hexdigest()


def _facade_trace(pkg, base, datadir, backend, **cfg):
    """The reference encode tests' deterministic facade workload."""
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    os.makedirs(datadir, exist_ok=True)
    tdir = os.path.join(base, "trace")
    real = time.perf_counter
    time.perf_counter = _FakeClock()
    try:
        rec = pkg.rec.Recorder(rank=0, config=pkg.rec.RecorderConfig(
            trace_dir=tdir, encode_backend=backend, **cfg))
        pkg.rec.attach(rec)
        try:
            fd = pkg.posix.open(os.path.join(datadir, "f.bin"),
                                os.O_RDWR | os.O_CREAT, 0o644)
            for i in range(300):
                pkg.posix.pwrite(fd, b"x" * 512, 512 * i)
            pkg.posix.fsync(fd)
            pkg.posix.close(fd)
        finally:
            pkg.rec.detach()
        rec.finalize()
    finally:
        time.perf_counter = real
    return tdir


def _records(reader, rank):
    return [repr((r.func, r.args, r.ret, r.thread, r.depth, r.t_entry,
                  r.t_exit)) for r in reader.iter_records(rank)]


@pytest.mark.parametrize("backend", ["python", "numpy", "torch"])
def test_facade_trace_matches_reference(tmp_path, backend):
    datadir = str(tmp_path / "data")
    ref = _facade_trace(REF, str(tmp_path / "ref"), datadir, "python")
    port = _facade_trace(PORT, str(tmp_path / "port"), datadir, backend)
    assert _bin_digest(port) == _bin_digest(ref)
    offs = [r.arg("offset") for r in port_reader.TraceReader(ref)
            .iter_records(0) if r.func == "pwrite"]
    assert offs == [512 * i for i in range(300)]


def test_streaming_segments_match_reference(tmp_path):
    datadir = str(tmp_path / "data")
    ref = _facade_trace(REF, str(tmp_path / "ref"), datadir, "numpy",
                        flush_every_n_records=64, ts_block_records=50)
    port = _facade_trace(PORT, str(tmp_path / "port"), datadir, "torch",
                         flush_every_n_records=64, ts_block_records=50)
    epochs = sorted(d for d in os.listdir(port) if d.startswith("epoch_"))
    assert len(epochs) >= 4
    assert sorted(os.listdir(ref)) == sorted(os.listdir(port))
    for d in epochs + ["merged"]:
        assert "state.bin" in os.listdir(os.path.join(port, d)) \
            or d == "merged"
        assert _bin_digest(os.path.join(port, d)) == _bin_digest(
            os.path.join(ref, d)), d
    for mode in ("stitched", "merged"):
        assert (_records(port_reader.TraceReader(ref, mode=mode), 0)
                == _records(ref_reader.TraceReader(port, mode=mode), 0))


def _ior_trace(pkg, trace_dir, topology, backend, nprocs=6, n_iter=40,
               xfer=1 << 20):
    """IOR (paper Listing 3): every rank lseeks to its strided slot of one
    shared file and writes ``xfer`` bytes, ``n_iter`` times.  Ranks are
    threads; records are fed directly because the wrapper slot is
    process-global.  Ticks come from a per-rank seeded generator."""
    reg = pkg.registry
    fid = {n: reg.id_of(n) for n in ("open", "lseek", "write", "fsync",
                                     "close")}

    def worker(comm, rank):
        rec = pkg.rec.Recorder(rank=rank, config=pkg.rec.RecorderConfig(
            finalize_topology=topology, encode_backend=backend))
        rng = np.random.RandomState(rank)
        n = 2 * n_iter + 3
        ticks = np.cumsum(rng.randint(1, 40, size=2 * n)).reshape(n, 2)
        t = iter(ticks.tolist())
        fd = 3
        rec.record(fid["open"], ("/data/ior/shared.bin", 66, 0o644), fd, 0,
                   *next(t))
        for i in range(n_iter):
            off = rank * xfer + i * nprocs * xfer
            rec.record(fid["lseek"], (fd, off, 0), off, 0, *next(t))
            rec.record(fid["write"], (fd, xfer), xfer, 0, *next(t))
        rec.record(fid["fsync"], (fd,), 0, 0, *next(t))
        rec.record(fid["close"], (fd,), 0, 0, *next(t))
        rec.forget_handle(fd)
        return rec.finalize(comm, trace_dir=trace_dir)

    stats = pkg.comm.run_thread_world(nprocs, worker)
    assert stats[0] is not None and all(s is None for s in stats[1:])
    return trace_dir


@pytest.mark.parametrize("topology", ["tree", "flat"])
def test_ior_threadcomm_matches_reference(tmp_path, topology):
    ref = _ior_trace(REF, str(tmp_path / "ref"), topology, "numpy")
    port = _ior_trace(PORT, str(tmp_path / "port"), topology, "torch")
    assert _bin_digest(port) == _bin_digest(ref)
    # cross-read: each package's reader over the other's trace
    pr, rr = port_reader.TraceReader(ref), ref_reader.TraceReader(port)
    assert pr.nranks == rr.nranks == 6
    for rank in (0, 3, 5):
        assert _records(pr, rank) == _records(rr, rank)
        offs = [r.arg("offset") for r in pr.iter_records(rank)
                if r.func == "lseek"]
        assert offs == [rank * (1 << 20) + i * 6 * (1 << 20)
                        for i in range(40)]
        assert pr.n_records(rank) == 83


def test_rank_state_blob_round_trips(tmp_path):
    """A reference ``serialize_rank_state`` blob -- leaf and merged --
    deserializes in the port and re-serializes to the same bytes."""
    fid_w = REF_REGISTRY.id_of("pwrite")
    leaves = []
    for rank in range(3):
        rec = ref_recorder.Recorder(rank=rank)
        for i in range(30):
            rec.record(fid_w, (7, 4096, rank * 4096 + i * 3 * 4096), 4096,
                       0, 2 * i, 2 * i + 1)
        entries, cfg, _ts = rec.local_state()
        leaves.append(ref_ip.serialize_rank_state(
            ref_ip.make_rank_state(rank, entries, cfg, REF_REGISTRY)))
    merged = ref_ip.merge_serialized_states(
        ref_ip.merge_serialized_states(leaves[0], leaves[1]), leaves[2])
    for blob in leaves + [merged]:
        assert port_ip.serialize_rank_state(
            port_ip.deserialize_rank_state(blob)) == blob
    assert port_ip.merge_serialized_states(
        port_ip.merge_serialized_states(leaves[0], leaves[1]),
        leaves[2]) == merged


@pytest.fixture
def counted_wrappers(monkeypatch):
    """Wrap each kernel wrapper so that a CPU call counts like a launch:
    the counts then show which wrappers a CPU run went through."""
    def counting(module, name):
        real = getattr(module, name)

        def wrapper(*args):
            _build.count_launch(name)
            return real(*args)
        monkeypatch.setattr(module, name, wrapper)

    for module, name in ((de_ops, "delta_zigzag"),
                         (de_ops, "uvarint_encode64"),
                         (de_ops, "fit_columns"),
                         (gs_ops, "row_boundaries")):
        counting(module, name)
    _build.reset_launches()
    yield
    _build.reset_launches()


def test_finalize_routes_through_kernel_wrappers(tmp_path, counted_wrappers):
    _ior_trace(PORT, str(tmp_path / "tree"), "tree", "torch")
    tree = _build.launch_counts()
    assert tree.get("delta_zigzag", 0) == 6            # one per rank
    assert tree.get("uvarint_encode64", 0) > 0         # grammars, cfg_index
    assert "fit_columns" not in tree                   # tree fits in scalar
    _build.reset_launches()
    _ior_trace(PORT, str(tmp_path / "flat"), "flat", "torch")
    flat = _build.launch_counts()
    assert flat.get("delta_zigzag", 0) == 6
    assert flat.get("uvarint_encode64", 0) > 0
    assert flat.get("fit_columns", 0) == 1             # one batched fit
    # the Recorder does not segment runs itself; the batched pattern
    # encoders do, and they reach row_boundaries
    _build.reset_launches()
    IntraPatternTracker().encode_many("k", [(8 * i,) for i in range(100)],
                                      backend="torch")
    Sequitur().push_stream([1] * 50 + [2] * 50, backend="torch")
    assert _build.launch_counts().get("row_boundaries", 0) == 2
