"""The port's comparison baselines against the JAX package's, on the CPU.

``RecorderOld`` (peephole records) and ``DarshanLike`` (zlib'd counters and
24-byte DXT segments) must write the reference's bytes on the same calls:
seeded direct ``record`` calls (peephole hits and misses, changes of the
offset delta, handles, paths), and the same facade calls through each
package's ``ToolAdapter`` with one counter clock and one data directory.
The two packages run one after the other: each keeps a global attached
tool.
"""

import os
import time

import numpy as np
import pytest

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from repro.core import baselines as ref_bl
from repro.core import encoding as ref_enc
from repro.core import recorder as ref_recorder
from repro.core.apis import posix as ref_posix
from repro.core.apis import shardio as ref_shardio
from repro.core.specs import REGISTRY as REF_REGISTRY
from repro_torch.core import baselines as port_bl
from repro_torch.core import encoding as port_enc
from repro_torch.core import recorder as port_recorder
from repro_torch.core.apis import posix as port_posix
from repro_torch.core.apis import shardio as port_shardio
from repro_torch.core.specs import REGISTRY as PORT_REGISTRY

REF = (ref_bl, ref_enc, REF_REGISTRY)
PORT = (port_bl, port_enc, PORT_REGISTRY)


def _calls(pkg, seed: int, n: int = 600) -> list:
    """Seeded record calls for one package: strided runs whose delta
    changes, repeats of identical records, handles, paths and odd
    returns, with increasing ticks (wrapping past 2^32 once)."""
    _bl, enc, reg = pkg
    rng = np.random.RandomState(seed)
    fid = {name: reg.id_of(name) for name in (
        "pwrite", "pread", "write", "read", "lseek", "open", "close", "stat",
        "shard_write_at", "shard_read_at", "fsync")}
    t = (1 << 32) - 5000
    off, delta = 0, 64
    out = []
    for i in range(n):
        t0 = t + int(rng.randint(0, 50))
        t1 = t0 + int(rng.randint(0, 30))
        t = t1
        fd = int(rng.randint(3, 6))
        r = rng.rand()
        if r < 0.05:
            delta = int(rng.choice([64, 128, -64, 0, 4096]))
        if r < 0.45:
            off += delta
            out.append((fid["pwrite"], 0, 0, (fd, 64, off), 64, t0, t1))
        elif r < 0.55:
            out.append((fid["lseek"], 0, 0, (fd, off, 0), off, t0, t1))
            out.append((fid["write"], 0, 0, (fd, 512), 512, t0, t1))
        elif r < 0.62:
            out.append((fid["pread"], 0, 1, (fd, 256, off), 256, t0, t1))
        elif r < 0.67:
            out.append((fid["read"], 0, 0, (fd, 100), 37, t0, t1))
        elif r < 0.77:
            fh = enc.Handle(int(rng.randint(0, 3)))
            out.append((fid["shard_write_at"], 0, 0, (fh, 64, off), 64,
                        t0, t1))
        elif r < 0.81:
            fh = enc.Handle(int(rng.randint(0, 3)))
            out.append((fid["shard_read_at"], 1, 0, (fh, 8, off), 8, t0, t1))
        elif r < 0.86:
            out.append((fid["open"], 0, 0,
                        (f"/data/f{fd}.bin", os.O_RDWR, 0o644), fd, t0, t1))
        elif r < 0.90:
            out.append((fid["stat"], 0, 0, (f"/data/f{fd}.bin",),
                        "stat_result(st_size=1)", t0, t1))
        elif r < 0.95:
            out.append((fid["fsync"], 0, 0, (fd,), None, t0, t1))
        else:
            out.append((fid["close"], 0, 0, (fd,), 0, t0, t1))
        if rng.rand() < 0.1:        # an exact repeat of the last record
            out.append(out[-1])
    return out


def _direct(pkg, tool_name: str, seed: int, **kw):
    bl = pkg[0]
    tool = getattr(bl, tool_name)(3, **kw)
    for call in _calls(pkg, seed):
        tool.record(*call)
    return tool


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recorder_old_bytes_match_reference(seed, tmp_path):
    ref = _direct(REF, "RecorderOld", seed)
    port = _direct(PORT, "RecorderOld", seed)
    assert bytes(port._buf) == bytes(ref._buf)
    assert (port.nbytes, port.n_records) == (ref.nbytes, ref.n_records)
    # the calls hit and miss the peephole
    assert 0 < port._buf.count(port_bl.RecorderOld.REPEAT) < port.n_records
    ref_path, port_path = tmp_path / "ref", tmp_path / "port"
    assert port.write(str(port_path)) == ref.write(str(ref_path))
    assert ((port_path / "rank_3.rec2").read_bytes()
            == (ref_path / "rank_3.rec2").read_bytes())


@pytest.mark.parametrize("dxt", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_darshan_bytes_match_reference(seed, dxt, tmp_path):
    ref = _direct(REF, "DarshanLike", seed, dxt=dxt)
    port = _direct(PORT, "DarshanLike", seed, dxt=dxt)
    blob = port.serialize()
    assert blob == ref.serialize()
    assert port.n_records == ref.n_records
    # unified handles key the counters as the reference prints them
    assert any(str(k).startswith("Handle(id=") for k in port.files)
    head = len(blob) - sum(np.frombuffer(blob[:8], "<u4"))
    assert head == 8
    assert port.write(str(tmp_path / "p")) == ref.write(str(tmp_path / "r"))
    assert ((tmp_path / "p" / "rank_3.darshan").read_bytes()
            == (tmp_path / "r" / "rank_3.darshan").read_bytes())


def test_recorder_old_repeat_token_and_record_layout():
    _bl, enc, reg = PORT
    old = port_bl.RecorderOld(0)
    pw = reg.id_of("pwrite")
    old.record(pw, 0, 0, (3, 64, 0), 64, 10, 11)
    sig = enc.encode_signature(pw, 0, 0, (3, 64, 0), 64)
    first = len(sig) + 2 + 8
    assert bytes(old._buf) == (len(sig).to_bytes(2, "little") + sig
                               + (10).to_bytes(4, "little")
                               + (11).to_bytes(4, "little"))
    old.record(pw, 0, 0, (3, 64, 64), 64, 12, 13)     # first delta: a hit
    old.record(pw, 0, 0, (3, 64, 128), 64, 14, 15)    # same delta: a hit
    assert old.nbytes == first + 2 * 10
    assert bytes(old._buf[first:first + 2]) == b"\xff\xfe"
    old.record(pw, 0, 0, (3, 64, 256), 64, 16, 17)    # new delta: a miss
    assert old.nbytes > first + 3 * 10


class _CounterClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 3e-6
        return self.t


def _facade_calls(posix, shardio, datadir: str) -> None:
    fd = posix.open(os.path.join(datadir, "f.bin"), os.O_RDWR | os.O_CREAT,
                    0o644)
    for i in range(40):
        posix.pwrite(fd, b"x" * 64, i * 64)
    for i in range(10):
        posix.lseek(fd, 4096 * i, 0)
        posix.write(fd, b"y" * 16)
    posix.pread(fd, 64, 128)
    posix.fsync(fd)
    posix.close(fd)
    fh = shardio.shard_open(os.path.join(datadir, "s.bin"), 1)
    for i in range(20):
        shardio.shard_write_at(fh, b"z" * 32, 1000 + 32 * i)
    shardio.shard_read_at(fh, 32, 1000)
    shardio.shard_sync(fh)
    shardio.shard_close(fh)


def _through_adapter(monkeypatch, pkg, facades, recorder, tool, datadir):
    bl = pkg[0]
    with monkeypatch.context() as m:
        m.setattr(time, "perf_counter", _CounterClock())
        adapter = bl.ToolAdapter(tool, rank=tool.rank)
        recorder.attach(adapter)
        try:
            _facade_calls(*facades, datadir)
        finally:
            recorder.detach()
    return tool


@pytest.mark.parametrize("tool", ["RecorderOld", "DarshanLike",
                                  "DarshanLike-nodxt"])
def test_adapter_over_facades_matches_reference(monkeypatch, tmp_path, tool):
    name, _, nodxt = tool.partition("-")
    kw = {"dxt": False} if nodxt else {}
    datadir = str(tmp_path)
    ref = _through_adapter(monkeypatch, REF, (ref_posix, ref_shardio),
                           ref_recorder, getattr(ref_bl, name)(1, **kw),
                           datadir)
    port = _through_adapter(monkeypatch, PORT, (port_posix, port_shardio),
                            port_recorder, getattr(port_bl, name)(1, **kw),
                            datadir)
    assert port.n_records == ref.n_records > 70
    if name == "RecorderOld":
        assert bytes(port._buf) == bytes(ref._buf)
    else:
        assert port.serialize() == ref.serialize()
        assert sorted(map(str, port.files)) == sorted(map(str, ref.files))


def test_adapter_clock_reads_perf_counter(monkeypatch):
    clock = _CounterClock()
    monkeypatch.setattr(time, "perf_counter", clock)
    a = port_bl.ToolAdapter(port_bl.RecorderOld(0))
    assert a.now() == 3 and a.now() == 6
    assert a.enter() == 0 and a.enter() == 1
    a.exit()
    assert a.enter() == 1 and a.layer_enabled("anything")


@pytest.mark.parametrize("ret", [b"abc", bytearray(5), 7, 1.5, "s", True,
                                 None, (1, 2), object])
def test_scrub_matches_reference(ret):
    assert port_bl._scrub(ret) == ref_bl._scrub(ret)


# -- the two baseline tests of tests/test_recorder_system.py, on the port --


def _workload(datadir, n=50):
    fd = port_posix.open(os.path.join(datadir, "f.bin"),
                         os.O_RDWR | os.O_CREAT, 0o644)
    for i in range(n):
        port_posix.pwrite(fd, b"x" * 64, i * 64)
    port_posix.fsync(fd)
    port_posix.close(fd)


def test_baseline_adapters(tmp_path):
    datadir = str(tmp_path)
    old = port_bl.RecorderOld(0)
    port_recorder.attach(port_bl.ToolAdapter(old))
    try:
        _workload(datadir, n=40)
    finally:
        port_recorder.detach()
    assert old.n_records == 43
    assert old.nbytes > 0
    dar = port_bl.DarshanLike(0)
    port_recorder.attach(port_bl.ToolAdapter(dar))
    try:
        _workload(datadir, n=40)
    finally:
        port_recorder.detach()
    assert dar.n_records == 43
    blob = dar.serialize()
    assert 0 < len(blob) < old.nbytes  # counters < per-record trace


def test_peephole_compresses_regular_writes(tmp_path):
    old = port_bl.RecorderOld(0)
    port_recorder.attach(port_bl.ToolAdapter(old))
    try:
        _workload(str(tmp_path), n=500)
    finally:
        port_recorder.detach()
    # repeat tokens: ~10 bytes per repeated call, full record for the rest
    assert old.nbytes < 500 * 12 + 1000
