"""The tracer's durability path held against the JAX package, scenario by
scenario: every scenario of ``tests/test_async_flush.py``,
``tests/test_faults.py`` and ``tests/test_streaming.py`` that writes a
trace or returns a value, run through both packages with the same calls,
ticks, flush cadence and seeded ``FaultPlan``.

Each scenario is one function of a package namespace (``_torch_pkgs``):
it makes the reference test's calls, asserts the reference test's own
properties inside that package, and returns what it produced.  The port,
on its ``numpy`` and ``torch`` encode backends, must return exactly what
the reference returns on ``numpy``:

* every ``*.bin`` of every epoch segment, of ``merged/`` and ``state.bin``;
* the manifests, with the CRC of ``metadata.json`` left out (it embeds the
  pid and host);
* ``ranks_present``, ``epochs_resumed``, ``epochs_coalesced`` (and the
  other epoch counters) and the plan's ``counters``;
* the exception each faulty flush raises (type and message);
* ``check_trace_invariants``' report;
* the reader's rows in ``merged``, ``stitched`` and ``tail`` modes.

Trace directories differ between the runs, so paths in messages and
reports are replaced by ``<td>``.  Hypothesis-driven reference tests
become fixed seeded cases.  Crashes come from ``FaultPlan.crash_point``,
never from the clock.  Pure validation (malformed knobs, ``from_env``)
must give the same outcome in both packages; where the packages' default
encode backend enters, each is held to its own (``auto`` in the
reference, ``cuda`` in the port).
"""

import json
import os
import random
import shutil
import threading
import time
import warnings

import numpy as np
import pytest

from _torch_pkgs import BACKENDS, REF, bin_files, parity, port

both = parity()
PORTS = [port(b) for b in BACKENDS]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    for P in (REF, *PORTS):
        P.faults.uninstall()


# -- the reference tests' workloads, per package ------------------------------------


def stream_calls(P, rng, n_calls, rank, nranks):
    """``tests/test_streaming.py``'s mixed call list."""
    f = {name: P.REGISTRY.id_of(name)
         for name in ("open", "close", "pwrite", "lseek", "write", "stat")}
    fd = f"fd-{rank}"
    calls = [(f["open"], ("/data/f.bin", 2, 438), fd)]
    for i in range(n_calls):
        kind = rng.random()
        if kind < 0.5:
            off = rank * 4096 + i * nranks * 4096
            calls.append((f["pwrite"], (fd, b"x" * 4096, off), 4096))
        elif kind < 0.7:
            off = rng.randrange(1 << 20)
            calls.append((f["pwrite"], (fd, b"y" * 512, off), 512))
        elif kind < 0.85:
            off = rank * 256 + i * 256
            calls.append((f["lseek"], (fd, off, 0), off))
        elif kind < 0.95:
            calls.append((f["write"], (fd, b"z" * 128), 128))
        else:
            calls.append((f["stat"], ("/data/f.bin",), 4096))
    calls.append((f["close"], (fd,), 0))
    return calls


def fault_calls(P, rng, n_calls, rank, nranks):
    """``tests/test_faults.py``'s call list."""
    f = {name: P.REGISTRY.id_of(name)
         for name in ("open", "close", "pwrite", "lseek", "write")}
    fd = f"fd-{rank}"
    calls = [(f["open"], ("/data/f.bin", 2, 438), fd)]
    for i in range(n_calls):
        kind = rng.random()
        if kind < 0.6:
            off = rank * 4096 + i * nranks * 4096
            calls.append((f["pwrite"], (fd, b"x" * 4096, off), 4096))
        elif kind < 0.8:
            calls.append((f["lseek"], (fd, rank * 256 + i * 256, 0),
                          rank * 256 + i * 256))
        else:
            calls.append((f["write"], (fd, b"z" * 128), 128))
    calls.append((f["close"], (fd,), 0))
    return calls


def feed(rec, calls, t=0):
    for fid, args, ret in calls:
        rec.record(fid, args, ret, 0, t, t + 1)
        t += 2
    return t


def split(calls, bounds):
    out, prev = [], 0
    for b in bounds:
        out.append(calls[prev:b])
        prev = b
    out.append(calls[prev:])
    return out


def names(P, calls):
    return [P.REGISTRY.spec(fid).name for fid, _, _ in calls]


def funcs(reader):
    return [r.func for _, r in reader.all_records()]


def drive_streaming(P, td, rank_calls, bounds, **kw):
    """A flush at each boundary; SoloComm for one rank, else a ThreadComm
    world (flush is a collective).  Returns rank 0's stats."""
    def run(rec, calls, comm):
        parts = split(calls, bounds)
        t = 0
        for i, part in enumerate(parts):
            t = feed(rec, part, t)
            if i < len(parts) - 1:
                rec.flush(comm)
        return rec.finalize(comm)

    if len(rank_calls) == 1:
        return run(P.Recorder(rank=0, config=P.cfg(trace_dir=td, **kw)),
                   rank_calls[0], None)

    def worker(comm, rank):
        return run(P.Recorder(rank=rank, config=P.cfg(trace_dir=td, **kw)),
                   rank_calls[rank], comm)
    return P.comm.run_thread_world(len(rank_calls), worker)[0]


def drive_oneshot(P, td, rank_calls):
    if len(rank_calls) == 1:
        rec = P.Recorder(rank=0, config=P.cfg(trace_dir=td))
        feed(rec, rank_calls[0])
        return rec.finalize()

    def worker(comm, rank):
        rec = P.Recorder(rank=rank, config=P.cfg(trace_dir=td))
        feed(rec, rank_calls[rank])
        return rec.finalize(comm)
    return P.comm.run_thread_world(len(rank_calls), worker)[0]


# -- what a scenario returns ------------------------------------------------------


def norm(obj, td):
    """``obj`` with the trace directory's path replaced by ``<td>``."""
    if not td:
        return obj
    if isinstance(obj, str):
        return obj.replace(td, "<td>")
    if isinstance(obj, dict):
        return {norm(k, td): norm(v, td) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(norm(v, td) for v in obj)
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    return obj


def manifest(P, td):
    """The manifest without ``metadata.json``'s CRC."""
    try:
        m = P.tf.read_manifest(td)
    except Exception as e:  # noqa: BLE001  (the outcome is compared)
        return ("error", type(e).__name__)
    m = json.loads(json.dumps(m))
    for e in m.get("segments", []) + ([m["merged"]] if "merged" in m
                                      else []):
        e.get("crcs", {}).pop("metadata.json", None)
    return m


def rows(P, td, mode):
    """A reader's records (every field), its skipped segments, degraded
    epochs and partial ranks, or the error it raised."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r = P.TraceReader(td, mode=mode)
            recs = [(rank, repr((x.func, x.args, x.ret, x.thread, x.depth,
                                 x.t_entry, x.t_exit)))
                    for rank, x in r.all_records()]
        return norm({"records": recs, "nranks": r.nranks,
                     "skipped": r.skipped,
                     "degraded": dict(getattr(r, "degraded_epochs", {})),
                     "partial": list(getattr(r, "ranks_partial", []))}, td)
    except Exception as e:  # noqa: BLE001  (the outcome is compared)
        return ("error", type(e).__name__, norm(str(e), td))


def snap(P, td, modes=("merged", "stitched", "tail")):
    """Everything a trace directory holds that the packages must agree on."""
    out = {"bins": bin_files(td), "manifest": manifest(P, td),
           "invariants": norm(P.faults.check_trace_invariants(td), td)}
    for m in modes:
        out[m] = rows(P, td, m)
    return out


def counters(rec):
    return {k: getattr(rec, k) for k in (
        "epoch", "epochs_resumed", "epochs_coalesced", "epochs_restored",
        "epochs_degraded")}


def raised(fn, td):
    """Call ``fn``; the type and message of what it raised, or None."""
    try:
        fn()
    except BaseException as e:  # noqa: BLE001  (crashes are BaseException)
        cause = e.__cause__
        return (type(e).__name__, norm(str(e), td),
                None if cause is None else (type(cause).__name__,
                                            norm(str(cause), td)))
    return None


def tmpdir(P, base, name):
    d = os.path.join(base, f"{P.name}-{P.backend}", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.dirname(d), exist_ok=True)
    return d


# =================================================================================
# tests/test_async_flush.py
# =================================================================================


def _async_identical_solo(P, base, seed, n_flushes):
    rng = random.Random(seed)
    calls = stream_calls(P, rng, 40, 0, 1)
    bounds = sorted(rng.sample(range(1, len(calls)), n_flushes))
    snaps = {}
    for mode in ("sync", "async"):
        td = tmpdir(P, base, mode)
        rec = P.Recorder(config=P.cfg(trace_dir=td,
                                      async_flush=(mode == "async")))
        t = 0
        for i, part in enumerate(split(calls, bounds)):
            t = feed(rec, part, t)
            if i < n_flushes:
                rec.flush()
                rec.drain()
        rec.finalize()
        snaps[mode] = snap(P, td)
    assert snaps["sync"] == snaps["async"]
    return snaps["async"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed,n_flushes", [(0, 1), (7, 2), (2 ** 31, 3)])
def test_async_trace_byte_identical_solo(tmp_path, seed, n_flushes,
                                         backend):
    both("async_solo", lambda P, s, n: _async_identical_solo(
        P, str(tmp_path), s, n), backend, seed, n_flushes)


def _async_identical_threadcomm(P, base):
    nranks = 4
    rank_calls = [stream_calls(P, random.Random(100 + r), 30, r, nranks)
                  for r in range(nranks)]
    snaps = {}
    for mode in ("sync", "async"):
        td = tmpdir(P, base, mode)

        def worker(comm, rank, td=td, async_=(mode == "async")):
            rec = P.Recorder(rank=rank, config=P.cfg(trace_dir=td,
                                                     async_flush=async_))
            t = 0
            for i, part in enumerate(split(rank_calls[rank], [10, 20])):
                t = feed(rec, part, t)
                if i < 2:
                    rec.flush(comm)
                    rec.drain()
            return rec.finalize(comm)

        stats = P.comm.run_thread_world(nranks, worker)
        assert stats[0] is not None and stats[0].epochs == 3
        snaps[mode] = snap(P, td)
    assert snaps["sync"] == snaps["async"]
    return snaps["async"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_trace_byte_identical_threadcomm(tmp_path, backend):
    both("async_tc", lambda P: _async_identical_threadcomm(
        P, str(tmp_path)), backend)


def _async_error_on_drain(P, base, monkeypatch):
    td = tmpdir(P, base, "t")
    rec = P.Recorder(config=P.cfg(trace_dir=td, async_flush=True))
    feed(rec, stream_calls(P, random.Random(0), 10, 0, 1))
    boom = OSError("trace volume gone")

    def bad_run_flush(*a, **k):
        raise boom

    monkeypatch.setattr(P.streaming, "run_flush", bad_run_flush)
    rec.flush()                  # submits; must not raise here
    with pytest.raises(RuntimeError) as ei:
        rec.drain()
    assert ei.value.__cause__ is boom
    err = (type(ei.value).__name__, str(ei.value))
    monkeypatch.undo()
    feed(rec, stream_calls(P, random.Random(1), 8, 0, 1), 10 ** 6)
    rec.flush()
    rec.drain()
    stats = rec.finalize()
    assert stats is not None and stats.epochs >= 1
    assert P.TraceReader(td, mode="stitched").nranks == 1
    return err, stats.epochs, counters(rec), snap(P, td)


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_error_surfaces_on_drain_then_recovers(tmp_path, monkeypatch,
                                                     backend):
    both("async_drain", lambda P: _async_error_on_drain(
        P, str(tmp_path), monkeypatch), backend)


def _async_error_on_finalize(P, base, monkeypatch):
    td = tmpdir(P, base, "t")
    rec = P.Recorder(config=P.cfg(trace_dir=td, async_flush=True))
    feed(rec, stream_calls(P, random.Random(3), 10, 0, 1))
    monkeypatch.setattr(P.streaming, "run_flush",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("mid-commit failure")))
    rec.flush()
    err = raised(rec.finalize, td)
    assert err[0] == "RuntimeError"
    assert "background epoch commit failed" in err[1]
    monkeypatch.undo()
    return err, counters(rec), snap(P, td)


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_error_surfaces_on_finalize(tmp_path, monkeypatch, backend):
    both("async_finalize", lambda P: _async_error_on_finalize(
        P, str(tmp_path), monkeypatch), backend)


def _coalesce(P, base, monkeypatch):
    td = tmpdir(P, base, "t")
    gate, started = threading.Event(), threading.Event()
    real = P.streaming.run_flush

    def slow_run_flush(*a, **k):
        started.set()
        assert gate.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(P.streaming, "run_flush", slow_run_flush)
    rec = P.Recorder(config=P.cfg(trace_dir=td, async_flush=True))
    calls = stream_calls(P, random.Random(2), 30, 0, 1)
    t = feed(rec, calls[:10])
    rec.flush()
    assert started.wait(30)
    t = feed(rec, calls[10:20], t)
    rec.flush()                  # epoch 0 still committing: coalesce
    rec.flush()                  # again
    assert rec.epochs_coalesced == 2 and rec.epoch == 1
    gate.set()
    rec.drain()
    feed(rec, calls[20:], t)
    stats = rec.finalize()
    assert stats.n_records == len(calls)
    assert P.TraceReader(td, mode="stitched").n_records(0) == len(calls)
    monkeypatch.undo()
    return counters(rec), snap(P, td)


@pytest.mark.parametrize("backend", BACKENDS)
def test_overlapping_flushes_coalesce(tmp_path, monkeypatch, backend):
    both("coalesce", lambda P: _coalesce(P, str(tmp_path), monkeypatch),
         backend)


def _finalize_inflight(P, base, monkeypatch):
    td = tmpdir(P, base, "t")
    real = P.streaming.run_flush
    started, gate = threading.Event(), threading.Event()

    def slow_run_flush(*a, **k):
        started.set()
        assert gate.wait(30)
        return real(*a, **k)

    monkeypatch.setattr(P.streaming, "run_flush", slow_run_flush)
    rec = P.Recorder(config=P.cfg(trace_dir=td, async_flush=True))
    calls = stream_calls(P, random.Random(7), 24, 0, 1)
    t = feed(rec, calls[:12])
    rec.flush()                  # in flight until the gate opens
    assert started.wait(30)
    feed(rec, calls[12:], t)
    threading.Timer(0.2, gate.set).start()
    stats = rec.finalize()       # waits for the commit, then tail-flushes
    assert stats.epochs == 2
    assert P.TraceReader(td, mode="stitched").n_records(0) == len(calls)
    m = P.tf.read_manifest(td)
    assert len(m["segments"]) == 2 and "merged" in m
    monkeypatch.undo()
    return stats.epochs, counters(rec), snap(P, td)


@pytest.mark.parametrize("backend", BACKENDS)
def test_finalize_during_inflight_drains(tmp_path, monkeypatch, backend):
    both("inflight", lambda P: _finalize_inflight(
        P, str(tmp_path), monkeypatch), backend)


def _fold(size, fn, leaf):
    items = [leaf(r) for r in range(size)]
    while len(items) > 1:
        items = [fn(items[i], items[i + 1]) if i + 1 < len(items)
                 else items[i] for i in range(0, len(items), 2)]
    return items[0]


def _p2p_reduce(P):
    def worker(comm, rank):
        return comm.reduce_tree(f"[{rank}]", lambda a, b: a + b)
    out = []
    for size in (2, 3, 5, 8):
        res = P.comm.run_thread_world(size, worker)
        assert res[0] == _fold(size, lambda a, b: a + b, lambda r: f"[{r}]")
        assert all(r is None for r in res[1:])
        out.append(res)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_threadcomm_p2p_reduce_matches_reference(backend):
    both("p2p_reduce", _p2p_reduce, backend)


def _fifo(P):
    def worker(comm, rank):
        if rank == 0:
            comm.send("a", 1)
            comm.send("b", 1)
            return None
        return comm.recv(0), comm.recv(0)
    return P.comm.run_thread_world(2, worker)


@pytest.mark.parametrize("backend", BACKENDS)
def test_threadcomm_send_recv_fifo(backend):
    assert both("fifo", _fifo, backend)[1] == ("a", "b")


def _rounds(P):
    out = {}
    for size in (1, 2, 3, 5, 8, 13, 16):
        rounds = P.comm.reduce_rounds(size)
        senders = [src for perm in rounds for src, _ in perm]
        assert sorted(senders) == list(range(1, size))
        for perm in rounds:
            assert all(dst < src for src, dst in perm)
        out[size] = [list(perm) for perm in rounds]
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduce_rounds_cover_all_ranks_once(backend):
    both("rounds", _rounds, backend)


def _via_exchange(P):
    out = []
    for size in (1, 2, 3, 5, 8):
        payloads = [None] * size
        barrier = threading.Barrier(size)

        def make_exchange(rank):
            def exchange(payload, perm):
                payloads[rank] = payload
                barrier.wait()
                got = next((payloads[src] for src, dst in perm
                            if dst == rank), None)
                barrier.wait()
                return got
            return exchange

        results = [None] * size

        def worker(r):
            results[r] = P.comm.reduce_tree_via_exchange(
                r, size, f"[{r}]", lambda a, b: a + b, make_exchange(r))

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(size)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert results[0] == _fold(size, lambda a, b: a + b,
                                   lambda r: f"[{r}]")
        assert all(r is None for r in results[1:])
        out.append(results)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduce_tree_via_exchange_matches_reference(backend):
    both("exchange", _via_exchange, backend)


def _vote_any(P):
    def worker(comm, rank):
        return comm.vote_any(rank == 2), comm.vote_any(False)
    res = P.comm.run_thread_world(4, worker)
    assert res == [(True, False)] * 4
    return res, P.comm.SoloComm().vote_any(True), \
        P.comm.SoloComm().vote_any(False)


@pytest.mark.parametrize("backend", BACKENDS)
def test_vote_any_threadcomm(backend):
    assert both("vote_any", _vote_any, backend)[1:] == (True, False)


def _lockstep(P, base):
    td = tmpdir(P, base, "t")
    fid = P.REGISTRY.id_of("write")

    def worker(comm, rank):
        rec = P.Recorder(rank=rank, comm=comm, config=P.cfg(
            trace_dir=td, flush_every_n_records=20))
        for i in range(25 if rank == 0 else 5):
            rec.record(fid, (f"fd{rank}", b"x" * 8), 8, 0, 2 * i, 2 * i + 1)
        rec.maybe_flush(comm)
        first = rec.epoch
        rec.maybe_flush(comm)    # nobody due now: a no-op on every rank
        assert rec.epoch == first
        rec.finalize(comm)
        return first

    res = P.comm.run_thread_world(3, worker)
    assert res == [1] * 3
    reader = P.TraceReader(td, mode="stitched")
    assert reader.nranks == 3
    assert reader.n_records(0) == 25 and reader.n_records(1) == 5
    return res, snap(P, td)


@pytest.mark.parametrize("backend", BACKENDS)
def test_maybe_flush_lockstep(tmp_path, backend):
    both("lockstep", lambda P: _lockstep(P, str(tmp_path)), backend)


# =================================================================================
# tests/test_faults.py
# =================================================================================


def _plan_deterministic(P):
    decisions = []
    for _ in range(2):
        plan = P.FaultPlan(seed=123, drop_prob=0.3, delay_prob=0.3,
                           delay_s=0.01)
        decisions.append([plan.on_send(0, 1) for _ in range(200)])
    assert decisions[0] == decisions[1]
    assert "drop" in decisions[0] and 0.01 in decisions[0]
    return decisions[0], plan.counters


@pytest.mark.parametrize("backend", BACKENDS)
def test_fault_plan_is_deterministic(backend):
    both("plan", _plan_deterministic, backend)


def _torn_named(P, base):
    d = tmpdir(P, base, "t")
    plan = P.FaultPlan(torn_file="b.bin")
    a = plan.on_write(os.path.join(d, "a.bin"), b"\xff" * 64)
    b = plan.on_write(os.path.join(d, "b.bin"), b"\xff" * 64)
    assert a == b"\xff" * 64 and len(b) == 64 and b != a
    assert plan.counters["files_torn"] == 1
    return a, b, plan.counters


@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_write_mangles_only_the_named_file(tmp_path, backend):
    both("torn_named", lambda P: _torn_named(P, str(tmp_path)), backend)


def _enospc_sync(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(1), 28, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    t = feed(rec, calls[10:20], t)
    with P.faults.injected(P.FaultPlan(fail_write_at=1)) as plan:
        err = raised(rec.flush, sd)
    assert err[0] == "SegmentWriteError" and "disk full" in err[1]
    assert plan.counters["writes_failed"] == 1
    assert not [d for d in os.listdir(sd) if d.endswith(".tmp")]
    assert len(P.tf.read_manifest(sd)["segments"]) == 1
    assert rec.epochs_restored == 1
    mid = snap(P, sd)
    feed(rec, calls[20:], t)
    rec.finalize()
    for mode in ("stitched", "merged"):
        assert funcs(P.TraceReader(sd, mode=mode)) == names(P, calls)
    return err, dict(plan.counters), counters(rec), mid, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_enospc_flush_retains_delta_sync(tmp_path, backend):
    both("enospc_sync", lambda P: _enospc_sync(P, str(tmp_path)), backend)


def _enospc_async(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(2), 28, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd, async_flush=True))
    t = feed(rec, calls[:10])
    rec.flush()
    rec.drain()
    t = feed(rec, calls[10:20], t)
    with P.faults.injected(P.FaultPlan(fail_write_at=1)) as plan:
        rec.flush()
        err = raised(rec.drain, sd)
    assert err[0] == "RuntimeError" and "records were retained" in err[1]
    assert rec.epochs_restored == 1
    feed(rec, calls[20:], t)
    rec.finalize()
    for mode in ("stitched", "merged"):
        assert funcs(P.TraceReader(sd, mode=mode)) == names(P, calls)
    return err, dict(plan.counters), counters(rec), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_enospc_async_flush_retains_delta(tmp_path, backend):
    both("enospc_async", lambda P: _enospc_async(P, str(tmp_path)), backend)


def _crash_pre_rename(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(3), 28, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    t = feed(rec, calls[10:20], t)
    with P.faults.injected(P.FaultPlan(crash_point="pre-rename")) as plan:
        err = raised(rec.flush, sd)
    assert err[0] == "SimulatedCrash"
    debris = sorted(d for d in os.listdir(sd) if d.endswith(".tmp"))
    assert debris
    reader = P.TraceReader(sd, mode="stitched")
    assert reader.skipped == [] and funcs(reader) == names(P, calls[:10])
    assert rec.epochs_restored == 1
    mid = snap(P, sd)
    feed(rec, calls[20:], t)
    rec.finalize()
    assert not [d for d in os.listdir(sd) if d.endswith(".tmp")]
    for mode in ("stitched", "merged"):
        assert funcs(P.TraceReader(sd, mode=mode)) == names(P, calls)
    return err, debris, dict(plan.counters), counters(rec), mid, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_pre_rename_leaves_tmp_debris_and_retains_delta(tmp_path,
                                                              backend):
    both("pre_rename", lambda P: _crash_pre_rename(P, str(tmp_path)),
         backend)


def _crash_pre_manifest(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(4), 28, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    t = feed(rec, calls[10:20], t)
    with P.faults.injected(P.FaultPlan(crash_point="pre-manifest")):
        err = raised(rec.flush, sd)
    assert err[0] == "SimulatedCrash"
    orphan = os.path.join(sd, P.tf.segment_name(1))
    assert os.path.isdir(orphan)
    assert len(P.tf.read_manifest(sd)["segments"]) == 1
    assert funcs(P.TraceReader(sd, mode="stitched")) == names(P, calls[:10])
    orphan_bins = bin_files(orphan)
    feed(rec, calls[20:], t)
    rec.finalize()               # the retry overwrites the orphan
    for mode in ("stitched", "merged"):
        assert funcs(P.TraceReader(sd, mode=mode)) == names(P, calls)
    return err, orphan_bins, counters(rec), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_pre_manifest_orphan_segment_is_replaced(tmp_path, backend):
    both("pre_manifest", lambda P: _crash_pre_manifest(P, str(tmp_path)),
         backend)


def _torn_in_flight(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(5), 20, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    feed(rec, calls[10:], t)
    with P.faults.injected(P.FaultPlan(torn_file="merged_cst.bin")) as plan:
        rec.flush()              # the writer believes the write succeeded
    assert plan.counters["files_torn"] == 1
    entry = P.tf.read_manifest(sd)["segments"][1]
    reason = P.tf.validate_segment(sd, entry)
    assert reason is not None and "checksum" in reason
    path = os.path.join(sd, entry["name"], "merged_cst.bin")
    assert os.path.getsize(path) == entry["files"]["merged_cst.bin"]
    reader = P.TraceReader(sd, mode="stitched")
    assert [s["segment"] for s in reader.skipped] == [entry["name"]]
    assert reader.degraded and funcs(reader) == names(P, calls[:10])
    tail = P.TraceReader(sd, mode="tail")
    assert [s["segment"] for s in tail.skipped] == [entry["name"]]
    assert funcs(tail) == names(P, calls[:10])
    return norm(reason, sd), dict(plan.counters), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_in_flight_torn_write_caught_by_checksum(tmp_path, backend):
    both("torn_in_flight", lambda P: _torn_in_flight(P, str(tmp_path)),
         backend)


def _bit_rot(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(6), 20, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    feed(rec, calls[10:], t)
    rec.flush()
    rec.finalize()
    seg = P.tf.segment_name(0)
    P.faults.corrupt_file(os.path.join(sd, seg, "unique_cfgs.bin"), seed=9)
    reason = P.tf.validate_segment(sd, P.tf.read_manifest(sd)["segments"][0])
    assert reason is not None and "checksum" in reason
    reader = P.TraceReader(sd, mode="stitched")
    assert [s["segment"] for s in reader.skipped] == [seg]
    assert funcs(reader) == names(P, calls[10:])
    assert funcs(P.TraceReader(sd, mode="auto")) == names(P, calls)
    return norm(reason, sd), snap(P, sd, ("merged", "stitched", "tail",
                                          "auto"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_post_commit_bit_rot_caught_by_checksum(tmp_path, backend):
    both("bit_rot", lambda P: _bit_rot(P, str(tmp_path)), backend)


def _torn_tail_size(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(7), 20, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    feed(rec, calls[10:], t)
    rec.flush()
    seg = P.tf.segment_name(1)
    P.faults.tear_file(os.path.join(sd, seg, "timestamps.bin"))
    reader = P.TraceReader(sd, mode="stitched")
    assert [s["segment"] for s in reader.skipped] == [seg]
    assert funcs(reader) == names(P, calls[:10])
    return snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_torn_tail_caught_by_size_check(tmp_path, backend):
    both("torn_tail", lambda P: _torn_tail_size(P, str(tmp_path)), backend)


def _agree_full(P):
    def worker(comm, rank):
        return comm.agree(rank == 1)
    res = P.comm.run_thread_world(3, worker)
    for verdict, present in res:
        assert (verdict, present) == (True, frozenset({0, 1, 2}))
    return [(v, sorted(p)) for v, p in res]


@pytest.mark.parametrize("backend", BACKENDS)
def test_agree_without_timeout_is_vote_any_with_full_presence(backend):
    both("agree_full", _agree_full, backend)


def _agree_dead(P, dead, nranks, timeout):
    P.faults.install(P.FaultPlan(dead_ranks=(dead,)))
    try:
        def worker(comm, rank):
            return comm.agree(rank == 1, timeout=timeout)
        res = P.comm.run_thread_world(nranks, worker)
        counts = dict(P.faults.get_active().counters)
    finally:
        P.faults.uninstall()
    return [(v, sorted(p)) for v, p in res], counts


@pytest.mark.parametrize("backend", BACKENDS)
def test_agree_survivor_vote_excludes_unresponsive_subtree(backend):
    res, _ = both("agree_subtree", _agree_dead, backend, 2, 4, 0.5)
    assert res == [(True, [0, 1])] * 4


@pytest.mark.parametrize("backend", BACKENDS)
def test_agree_verdictless_rank_falls_back_to_its_own_flag(backend):
    res, _ = both("agree_verdictless", _agree_dead, backend, 0, 2, 0.4)
    assert res == [(True, [0, 1]), (True, [1])]


def _degraded(P, base, dead, mask):
    sd = tmpdir(P, base, "s")
    nranks = 4
    first = [fault_calls(P, random.Random(40 + r), 8, r, nranks)
             for r in range(nranks)]
    extra = [fault_calls(P, random.Random(50 + r), 5, r, nranks)
             for r in range(nranks)]
    plan = P.FaultPlan(dead_ranks=(dead,))
    P.faults.install(plan)

    def worker(comm, rank):
        rec = P.Recorder(rank=rank, config=P.cfg(trace_dir=sd,
                                                 flush_timeout_s=2.0))
        t = feed(rec, first[rank])
        rec.flush(comm)
        present = list(rec.last_flush_outcome.ranks_present)
        comm.barrier()
        if rank == 0:
            P.faults.uninstall()     # the mute rank recovers
        comm.barrier()
        t = feed(rec, extra[rank], t)
        rec.flush(comm)
        rec.finalize(comm)
        return (rec.epochs_restored, rec.epochs_degraded,
                rec.last_flush_outcome.lost_local, present)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = P.comm.run_thread_world(nranks, worker)
    lost = sorted(set(range(nranks)) - set(mask))
    for r in range(nranks):
        assert res[r][0] == (1 if r in lost else 0)
    assert res[0][1] == 1 and not any(r[2] for r in res)
    entry0 = P.tf.read_manifest(sd)["segments"][0]
    assert entry0["ranks_present"] == mask
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        reader = P.TraceReader(sd, mode="stitched")
        assert reader.degraded
        assert reader.degraded_epochs == {entry0["name"]: mask}
        assert reader.ranks_partial == lost
        cov = reader.coverage()
        assert cov["complete"] is False and cov["ranks_partial"] == lost
        merged = P.TraceReader(sd, mode="merged")
        assert merged.degraded_epochs == {entry0["name"]: mask}
        for r in range(nranks):
            want = names(P, first[r] + extra[r])
            assert [x.func for x in reader.iter_records(r)] == want
            assert [x.func for x in merged.iter_records(r)] == want
    with pytest.warns(RuntimeWarning, match="PARTIAL coverage"):
        P.TraceReader(sd, mode="stitched").view()
    return res, norm(cov, sd), dict(plan.counters), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dead,mask", [(1, [0, 2, 3]), (2, [0, 1])])
def test_degraded_flush_survives_unresponsive_rank(tmp_path, dead, mask,
                                                   backend):
    both("degraded", lambda P, d, m: _degraded(P, str(tmp_path), d, list(m)),
         backend, dead, tuple(mask))


def _degraded_equals_sync(P, base):
    def drive(sd, timeout):
        calls = [fault_calls(P, random.Random(60 + r), 10, r, 2)
                 for r in range(2)]

        def worker(comm, rank):
            rec = P.Recorder(rank=rank, config=P.cfg(
                trace_dir=sd, flush_timeout_s=timeout))
            t = feed(rec, calls[rank][:6])
            rec.flush(comm)
            feed(rec, calls[rank][6:], t)
            rec.flush(comm)
            return rec.finalize(comm)
        P.comm.run_thread_world(2, worker)

    sd_sync, sd_deg = tmpdir(P, base, "sync"), tmpdir(P, base, "deg")
    drive(sd_sync, None)
    drive(sd_deg, 5.0)
    m_sync, m_deg = P.tf.read_manifest(sd_sync), P.tf.read_manifest(sd_deg)
    assert [e["crcs"] for e in m_sync["segments"]] == \
        [e["crcs"] for e in m_deg["segments"]]
    assert "ranks_present" not in m_deg["segments"][0]
    assert m_sync["merged"]["crcs"] == m_deg["merged"]["crcs"]
    return snap(P, sd_sync), snap(P, sd_deg)


@pytest.mark.parametrize("backend", BACKENDS)
def test_degraded_protocol_matches_sync_flush_byte_for_byte(tmp_path,
                                                           backend):
    both("degraded_sync", lambda P: _degraded_equals_sync(P, str(tmp_path)),
         backend)


def _delayed(P, base):
    sd = tmpdir(P, base, "s")
    calls = [fault_calls(P, random.Random(70 + r), 10, r, 2)
             for r in range(2)]
    plan = P.FaultPlan(delay_prob=1.0, delay_s=0.05)
    P.faults.install(plan)

    def worker(comm, rank):
        rec = P.Recorder(rank=rank, config=P.cfg(trace_dir=sd,
                                                 flush_timeout_s=5.0))
        t = feed(rec, calls[rank][:6])
        rec.flush(comm)
        feed(rec, calls[rank][6:], t)
        rec.flush(comm)
        rec.finalize(comm)
        return rec.epochs_degraded + rec.epochs_restored

    try:
        res = P.comm.run_thread_world(2, worker)
    finally:
        P.faults.uninstall()
    assert res == [0, 0]
    reader = P.TraceReader(sd, mode="stitched")
    assert not reader.degraded
    for r in range(2):
        assert [x.func for x in reader.iter_records(r)] == \
            names(P, calls[r])
    return res, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_delayed_messages_within_timeout_do_not_degrade(tmp_path, backend):
    both("delayed", lambda P: _delayed(P, str(tmp_path)), backend)


def _stragglers(P, base):
    sd = tmpdir(P, base, "s")
    calls = [fault_calls(P, random.Random(80 + r), 8, r, 2)
             for r in range(2)]
    extra = [fault_calls(P, random.Random(90 + r), 5, r, 2)
             for r in range(2)]
    P.faults.install(P.FaultPlan(delay_prob=1.0, delay_s=1.0))

    def worker(comm, rank):
        rec = P.Recorder(rank=rank, config=P.cfg(trace_dir=sd,
                                                 flush_timeout_s=0.25))
        t = feed(rec, calls[rank])
        rec.flush(comm)
        comm.barrier()
        if rank == 0:
            P.faults.uninstall()
        comm.barrier()
        time.sleep(1.2)          # let the stragglers land in the queues
        t = feed(rec, extra[rank], t)
        rec.flush(comm)
        rec.finalize(comm)
        return rec.epochs_restored

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res = P.comm.run_thread_world(2, worker)
        assert res == [0, 1]
        entry0 = P.tf.read_manifest(sd)["segments"][0]
        assert entry0["ranks_present"] == [0]
        reader = P.TraceReader(sd, mode="stitched")
        assert reader.ranks_partial == [1]
        for r in range(2):
            assert [x.func for x in reader.iter_records(r)] == \
                names(P, calls[r] + extra[r])
    return res, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_stale_stragglers_from_degraded_epoch_are_discarded(tmp_path,
                                                            backend):
    both("stragglers", lambda P: _stragglers(P, str(tmp_path)), backend)


def _resume_state(P, base):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(10), 20, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    feed(rec, calls[10:], t)
    rec.flush()
    cum = P.streaming.resume_cumulative_state(sd)
    assert cum.n_epochs == 2
    blob = P.ip.serialize_rank_state(cum.to_rank_state())
    assert blob == P.ip.serialize_rank_state(rec._cum.to_rank_state())
    P.faults.corrupt_file(os.path.join(sd, P.tf.segment_name(0),
                                       "state.bin"), seed=3)
    err = raised(lambda: P.streaming.resume_cumulative_state(sd), sd)
    assert err[0] == "TraceFormatError" and "cannot resume" in err[1]
    return blob, err, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_resume_cumulative_state_folds_committed_segments(tmp_path,
                                                          backend):
    both("resume_state", lambda P: _resume_state(P, str(tmp_path)), backend)


def _merged_rows(P, td):
    return [(r.func, repr(r.args), repr(r.ret), r.t_entry, r.t_exit)
            for _, r in P.TraceReader(td, mode="merged").all_records()]


def _resumed(P, base):
    calls = fault_calls(P, random.Random(11), 28, 0, 1)
    clean = tmpdir(P, base, "clean")
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=clean))
    t = 0
    for lo, hi in ((0, 10), (10, 20), (20, None)):
        t = feed(rec, calls[lo:hi], t)
        rec.flush()
    rec.finalize()

    res = tmpdir(P, base, "resumed")
    rec_a = P.Recorder(rank=0, config=P.cfg(trace_dir=res))
    t = feed(rec_a, calls[:10])
    rec_a.flush()
    t = feed(rec_a, calls[10:20], t)
    rec_a.flush()
    del rec_a                    # killed: no finalize, no merged trace
    assert "merged" not in P.tf.read_manifest(res)
    rec_b = P.Recorder(rank=0, config=P.cfg(trace_dir=res))
    feed(rec_b, calls[20:], t)
    rec_b.flush()
    assert rec_b.epochs_resumed == 2
    rec_b.finalize()
    assert "merged" in P.tf.read_manifest(res)
    assert _merged_rows(P, clean) == _merged_rows(P, res)
    return counters(rec_b), snap(P, clean), snap(P, res)


@pytest.mark.parametrize("backend", BACKENDS)
def test_resumed_run_merged_identical_to_uninterrupted(tmp_path, backend):
    both("resumed", lambda P: _resumed(P, str(tmp_path)), backend)


def _readable_or_reported(P, base, plan_kw):
    sd = tmpdir(P, base, "s")
    calls = fault_calls(P, random.Random(77), 14, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:8])
    rec.flush()
    feed(rec, calls[8:], t)
    with P.faults.injected(P.FaultPlan(seed=5, **dict(plan_kw))) as plan:
        err = raised(rec.flush, sd)
    report = P.faults.check_trace_invariants(sd)
    assert report["readable"]
    served = len(P.tf.read_manifest(sd)["segments"]) - len(report["skipped"])
    assert report["n_records"] == 8 * served >= 8
    return err, dict(plan.counters), counters(rec), snap(P, sd)


PLANS = [(("fail_write_at", 1),), (("fail_write_at", 4),),
         (("crash_point", "pre-rename"),), (("crash_point", "pre-manifest"),),
         (("torn_file", "merged_cst.bin"),), (("torn_file", "timestamps.bin"),),
         (("torn_file", "state.bin"),)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plan_kw", PLANS, ids=lambda p: f"{p[0][0]}="
                         f"{p[0][1]}")
def test_surviving_trace_readable_or_reported(tmp_path, plan_kw, backend):
    both("readable", lambda P, p: _readable_or_reported(
        P, str(tmp_path), p), backend, plan_kw)


# =================================================================================
# tests/test_streaming.py
# =================================================================================


def _value_identical(got, want):
    gv, wv = got.view(), want.view()
    assert got.nranks == want.nranks
    assert list(got.all_records()) == list(want.all_records())
    assert gv.io_summary() == wv.io_summary()
    assert gv.size_histogram() == wv.size_histogram()
    for r in range(want.nranks):
        assert gv.call_chains(rank=r) == wv.call_chains(rank=r)
        assert gv.overlap_ratio(r) == wv.overlap_ratio(r)
    assert gv.consistency_pairs() == wv.consistency_pairs()
    return repr((gv.io_summary(), gv.size_histogram(),
                 gv.consistency_pairs(),
                 [gv.call_chains(rank=r) for r in range(want.nranks)],
                 [gv.overlap_ratio(r) for r in range(want.nranks)]))


def _equals_oneshot(P, base, seed, nranks, n_epochs, n_calls):
    rng = random.Random(seed)
    rank_calls = [stream_calls(P, random.Random(seed * 1000 + r), n_calls,
                               r, nranks) for r in range(nranks)]
    total = len(rank_calls[0])
    bounds = sorted(rng.sample(range(1, total), min(n_epochs - 1,
                                                    total - 1)))
    sd, od = tmpdir(P, base, "stream"), tmpdir(P, base, "oneshot")
    drive_streaming(P, sd, rank_calls, bounds)
    drive_oneshot(P, od, rank_calls)
    want = P.TraceReader(od)
    assert P.tf.is_stream_dir(sd)
    views = []
    for mode in ("stitched", "merged", "auto"):
        got = P.TraceReader(sd, mode=mode)
        assert got.skipped == []
        views.append(_value_identical(got, want))
    return views, snap(P, sd), bin_files(od)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", [(1, 1, 2, 8), (12, 2, 3, 25),
                                  (99, 3, 5, 60), (2 ** 32 - 1, 4, 4, 17)],
                         ids=lambda c: f"ranks{c[1]}-epochs{c[2]}")
def test_streaming_equals_oneshot(tmp_path, case, backend):
    both("oneshot", lambda P, *c: _equals_oneshot(P, str(tmp_path), *c),
         backend, *case)


def _multirank_explicit(P, base):
    nranks, n_calls = 4, 40
    rank_calls = [stream_calls(P, random.Random(7 + r), n_calls, r, nranks)
                  for r in range(nranks)]
    sd, od = tmpdir(P, base, "s"), tmpdir(P, base, "o")
    stats = drive_streaming(P, sd, rank_calls, [10, 20, 30])
    assert stats is not None and stats.epochs == 4
    drive_oneshot(P, od, rank_calls)
    a = _value_identical(P.TraceReader(sd, mode="stitched"),
                         P.TraceReader(od))
    b = _value_identical(P.TraceReader(sd, mode="merged"), P.TraceReader(od))
    return a, b, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_streaming_matches_oneshot_multirank_explicit(tmp_path, backend):
    both("multirank", lambda P: _multirank_explicit(P, str(tmp_path)),
         backend)


def _tail_latest(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(1), 30, 0, 1)
    drive_streaming(P, sd, [calls], [10, 25])
    tail = P.TraceReader(sd, mode="tail")
    assert tail.view().n_records(0) == len(calls) - 25
    full = P.TraceReader(sd, mode="stitched")
    assert full.view().n_records(0) == len(calls)
    assert funcs(full)[25:] == funcs(tail)
    return snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tail_mode_serves_latest_epoch(tmp_path, backend):
    both("tail_latest", lambda P: _tail_latest(P, str(tmp_path)), backend)


def _truncated(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(2), 30, 0, 1)
    drive_streaming(P, sd, [calls], [10, 20])
    victim = os.path.join(sd, P.tf.segment_name(1), "merged_cst.bin")
    with open(victim, "r+b") as f:
        f.truncate(max(os.path.getsize(victim) // 2, 1))
    reader = P.TraceReader(sd, mode="stitched")
    assert len(reader.skipped) == 1
    assert "epoch_00001" in reader.skipped[0]["segment"]
    assert "truncated or corrupt" in reader.skipped[0]["reason"]
    assert funcs(reader) == names(P, calls[:10] + calls[20:])
    assert P.TraceReader(sd, mode="auto").view().n_records(0) == len(calls)
    return snap(P, sd, ("merged", "stitched", "tail", "auto"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_truncated_segment_is_skipped_and_reported(tmp_path, backend):
    both("truncated", lambda P: _truncated(P, str(tmp_path)), backend)


def _tail_skips_corrupt(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(11), 30, 0, 1)
    drive_streaming(P, sd, [calls], [10, 20])
    newest = os.path.join(sd, P.tf.segment_name(2), "unique_cfgs.bin")
    with open(newest, "ab") as f:
        f.write(b"junk")
    tail = P.TraceReader(sd, mode="tail")
    assert [s["segment"] for s in tail.skipped] == ["epoch_00002"]
    assert funcs(tail) == names(P, calls[10:20])
    return snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tail_mode_skips_corrupt_newest_segment(tmp_path, backend):
    both("tail_corrupt", lambda P: _tail_skips_corrupt(P, str(tmp_path)),
         backend)


def _missing_segment(P, base):
    sd = tmpdir(P, base, "s")
    drive_streaming(P, sd, [stream_calls(P, random.Random(3), 20, 0, 1)],
                    [10])
    shutil.rmtree(os.path.join(sd, P.tf.segment_name(0)))
    reader = P.TraceReader(sd, mode="stitched")
    assert reader.skipped and "missing" in reader.skipped[0]["reason"]
    return snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_missing_segment_directory_is_reported(tmp_path, backend):
    both("missing", lambda P: _missing_segment(P, str(tmp_path)), backend)


def _tmp_invisible(P, base):
    sd = tmpdir(P, base, "s")
    drive_streaming(P, sd, [stream_calls(P, random.Random(4), 20, 0, 1)],
                    [10])
    debris = os.path.join(sd, P.tf.segment_name(7) + ".tmp")
    os.makedirs(debris)
    with open(os.path.join(debris, "merged_cst.bin"), "wb") as f:
        f.write(b"partial")
    reader = P.TraceReader(sd, mode="stitched")
    assert reader.skipped == [] and reader.n_segments == 2
    return snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_uncommitted_tmp_segment_is_invisible(tmp_path, backend):
    both("tmp_invisible", lambda P: _tmp_invisible(P, str(tmp_path)),
         backend)


def _all_corrupt(P, base):
    sd = tmpdir(P, base, "s")
    drive_streaming(P, sd, [stream_calls(P, random.Random(5), 8, 0, 1)], [4])
    for d in ("merged", P.tf.segment_name(0), P.tf.segment_name(1)):
        shutil.rmtree(os.path.join(sd, d))
    err = raised(lambda: P.TraceReader(sd, mode="stitched"), sd)
    assert err[0] == "TraceFormatError"
    assert "no intact epoch segments" in err[1]
    return err, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_segments_corrupt_is_a_format_error(tmp_path, backend):
    both("all_corrupt", lambda P: _all_corrupt(P, str(tmp_path)), backend)


def _mixed_version(P, base):
    sd = tmpdir(P, base, "s")
    drive_streaming(P, sd, [stream_calls(P, random.Random(6), 20, 0, 1)],
                    [10])
    meta_path = os.path.join(sd, P.tf.segment_name(1), "metadata.json")
    meta = json.load(open(meta_path))
    meta["format_version"] = P.tf.FORMAT_VERSION + 1
    blob = json.dumps(meta)
    blob += " " * (os.path.getsize(meta_path) - len(blob))
    with open(meta_path, "w") as f:
        f.write(blob)
    errs = [raised(lambda: P.tf.read_stream_trace(sd), sd),
            raised(lambda: P.TraceReader(sd, mode="stitched"), sd)]
    for e in errs:
        assert e[0] == "TraceFormatError" and "mixed format_version" in e[1]
    return errs


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_format_version_rejected(tmp_path, backend):
    both("mixed_version", lambda P: _mixed_version(P, str(tmp_path)),
         backend)


def _retention(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(8), 40, 0, 1)
    drive_streaming(P, sd, [calls], [10, 20, 30], max_epochs_retained=2)
    m = P.tf.read_manifest(sd)
    kept = [e["name"] for e in m["segments"]]
    assert kept == [P.tf.segment_name(2), P.tf.segment_name(3)]
    on_disk = sorted(d for d in os.listdir(sd)
                     if d.startswith(P.tf.SEGMENT_PREFIX))
    assert on_disk == kept and "merged" not in m
    assert funcs(P.TraceReader(sd)) == names(P, calls[20:])
    return snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_retention_ring_keeps_newest_epochs(tmp_path, backend):
    both("retention", lambda P: _retention(P, str(tmp_path)), backend)


def _restart_appends(P, base, resume):
    sd = tmpdir(P, base, "s")
    calls_a = stream_calls(P, random.Random(20), 12, 0, 1)
    drive_streaming(P, sd, [calls_a], [6])
    assert "merged" in P.tf.read_manifest(sd)
    calls_b = stream_calls(P, random.Random(21), 8, 0, 1)
    if resume:
        drive_streaming(P, sd, [calls_b], [4])
    else:
        with pytest.warns(RuntimeWarning, match="no merged trace"):
            drive_streaming(P, sd, [calls_b], [4], resume=False)
    m = P.tf.read_manifest(sd)
    epochs = [e["epoch"] for e in m["segments"]]
    assert epochs == sorted(epochs) == [0, 1, 2, 3]
    assert ("merged" in m) == resume
    if not resume:
        assert not os.path.exists(os.path.join(sd, "merged"))
    want = names(P, calls_a + calls_b)
    for mode in ("stitched", "merged") if resume else ("auto",):
        assert funcs(P.TraceReader(sd, mode=mode)) == want
    return snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_restarted_run_appends_to_existing_trace_dir(tmp_path, backend):
    both("restart", lambda P: _restart_appends(P, str(tmp_path), True),
         backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_restart_without_resume_keeps_append_only_behavior(tmp_path,
                                                           backend):
    both("restart_noresume", lambda P: _restart_appends(
        P, str(tmp_path), False), backend)


def _failed_write(P, base, monkeypatch):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(22), 30, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:10])
    rec.flush()
    t = feed(rec, calls[10:20], t)
    real = P.streaming.trace_format.write_trace
    monkeypatch.setattr(P.streaming.trace_format, "write_trace",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("disk full")))
    err = raised(rec.flush, sd)
    monkeypatch.setattr(P.streaming.trace_format, "write_trace", real)
    assert err[0] in ("OSError", "SegmentWriteError")
    assert "disk full" in err[1]
    assert rec._cum.n_epochs == 1 and rec.epochs_restored == 1
    feed(rec, calls[20:], t)
    rec.finalize()
    assert "merged" in P.tf.read_manifest(sd)
    for mode in ("stitched", "merged"):
        assert funcs(P.TraceReader(sd, mode=mode)) == names(P, calls)
    return err, counters(rec), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_failed_segment_write_keeps_state_consistent(tmp_path, monkeypatch,
                                                     backend):
    both("failed_write", lambda P: _failed_write(
        P, str(tmp_path), monkeypatch), backend)


def _multi_wrap(P, base):
    sd = tmpdir(P, base, "s")
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    calls_a = stream_calls(P, random.Random(30), 6, 0, 1)
    t = feed(rec, calls_a)
    rec.flush()
    gap = 5 * (2 ** 32)
    feed(rec, stream_calls(P, random.Random(31), 6, 0, 1), t + gap)
    rec.flush()
    rec.finalize()
    ts_s = P.TraceReader(sd, mode="stitched").ts_store.load_unwrapped(0)
    ts_m = P.TraceReader(sd, mode="merged").ts_store.load_unwrapped(0)
    np.testing.assert_array_equal(ts_m, ts_s)
    n_a = len(calls_a)
    assert int(ts_m[n_a, 0]) - int(ts_m[n_a - 1, 0]) >= 2 * (2 ** 32)
    assert int(ts_m[n_a, 0]) == t + gap
    assert bool(np.all(np.diff(ts_m[:, 0]) >= 0))
    return ts_m.tolist(), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_merged_mode_preserves_multi_wrap_epoch_gaps(tmp_path, backend):
    both("multi_wrap", lambda P: _multi_wrap(P, str(tmp_path)), backend)


def _cumulative_fold(P, seed, nranks, n_epochs):
    rng = random.Random(seed)
    cum = P.streaming.CumulativeState()
    ref, occ = None, None
    for _ in range(n_epochs):
        n_calls = rng.randrange(3, 25)
        epoch_seed = rng.randrange(1 << 30)
        states = []
        for r in range(nranks):
            rec = P.Recorder(rank=r, config=P.cfg())
            feed(rec, stream_calls(P, random.Random(epoch_seed + r),
                                   n_calls, r, nranks))
            entries, cfg, _, _ = rec.take_epoch()
            states.append(P.ip.make_rank_state(r, entries, cfg, P.REGISTRY))
        delta = P.ip.tree_reduce_states(states)
        ref, occ = P.ip.append_epoch_state(ref, occ, delta)
        cum.append(delta)
    blob = P.ip.serialize_rank_state(cum.to_rank_state())
    assert blob == P.ip.serialize_rank_state(ref)
    return blob


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", [(0, 1, 1), (5, 3, 2), (17, 6, 4),
                                  (2 ** 32 - 1, 2, 3)],
                         ids=lambda c: f"ranks{c[1]}-epochs{c[2]}")
def test_cumulative_state_matches_reference_fold(case, backend):
    both("cum_fold", _cumulative_fold, backend, *case)


def _gather_tree(P):
    def worker(comm, rank):
        return comm.gather_tree(f"payload-{rank}")
    res = P.comm.run_thread_world(5, worker)
    assert res[0] == [f"payload-{r}" for r in range(5)]
    assert all(r is None for r in res[1:])
    assert P.comm.SoloComm().gather_tree(b"x") == [b"x"]
    return res


@pytest.mark.parametrize("backend", BACKENDS)
def test_gather_tree_orders_by_rank(backend):
    both("gather_tree", _gather_tree, backend)


def _blocked_store(P):
    ticks = np.arange(1, 2 * 100 + 1, dtype=np.uint32).reshape(100, 2)
    blocks = P.ts.compress_timestamps_blocked(ticks, block_records=16)
    assert [n for _, n, _, _, _ in blocks] == [16] * 6 + [4]
    assert P.ts.unpack_ts_blocks(P.ts.pack_ts_blocks(blocks)) == blocks
    raw, index = bytearray(), [[]]
    for blob, n, t_min, t_max, n_bytes in blocks:
        assert n_bytes is None
        index[0].append([len(raw), len(blob), n, t_min, t_max])
        raw.extend(blob)
    store = P.ts.BlockedTimestampStore(bytes(raw), index)
    assert np.array_equal(store.load(0), ticks)
    assert store.blocks_touched == 7
    before = store.blocks_touched
    w = store.window(0, int(ticks[40, 0]), int(ticks[41, 0]))
    assert store.blocks_touched - before == 1
    assert np.array_equal(w, ticks[40:41])
    before = store.blocks_touched
    w2 = store.window(0, 10 ** 9, 10 ** 9 + 5)
    assert len(w2) == 0 and store.blocks_touched == before
    assert store.window(1, 0, 10) is None
    return P.ts.pack_ts_blocks(blocks), w.tolist()


@pytest.mark.parametrize("backend", BACKENDS)
def test_blocked_store_roundtrip_and_window(backend):
    both("blocked_store", _blocked_store, backend)


def _windowed_view(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(9), 200, 0, 1)
    drive_streaming(P, sd, [calls], [64, 128], ts_block_records=16)
    view = P.TraceReader(sd, mode="stitched").view()
    store = view.ts_store
    total = store.n_blocks(0)
    assert total > 8
    before = store.blocks_touched
    bounds = view.bandwidth_bounds(10, 40)
    touched = store.blocks_touched - before
    assert 1 <= touched < total
    assert bounds["n_calls"] > 0
    assert bounds["hi_MBps"] >= bounds["lo_MBps"] >= 0.0
    before = store.blocks_touched
    ratio = view.overlap_ratio(0, 10, 40)
    touched2 = store.blocks_touched - before
    assert 1 <= touched2 < total
    assert view.n_records(0) == len(calls)
    return total, touched, bounds, ratio, touched2, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_windowed_view_queries_touch_only_intersecting_blocks(tmp_path,
                                                             backend):
    both("windowed_view", lambda P: _windowed_view(P, str(tmp_path)),
         backend)


def _autoflush_n(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(10), 50, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd,
                                          flush_every_n_records=20))
    feed(rec, calls)
    assert rec.epoch == len(calls) // 20
    rec.finalize()
    m = P.tf.read_manifest(sd)
    assert len(m["segments"]) == rec.epoch
    assert sum(e["n_records"] for e in m["segments"]) == len(calls)
    assert funcs(P.TraceReader(sd, mode="stitched")) == names(P, calls)
    return counters(rec), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_autoflush_every_n_records(tmp_path, backend):
    both("autoflush_n", lambda P: _autoflush_n(P, str(tmp_path)), backend)


def _autoflush_interval(P, base, monkeypatch):
    fake = [0.0]
    monkeypatch.setattr(P.recorder.time, "perf_counter", lambda: fake[0])
    sd = tmpdir(P, base, "s")
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd,
                                          flush_interval_s=5.0))
    fid = P.REGISTRY.id_of("stat")
    rec.record(fid, ("/a",), 1, 0, 0, 1)
    first = rec.epoch
    fake[0] = 6.0
    rec.record(fid, ("/a",), 1, 0, 2, 3)
    monkeypatch.undo()
    assert (first, rec.epoch) == (0, 1)
    return counters(rec), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_autoflush_interval(tmp_path, monkeypatch, backend):
    both("autoflush_interval", lambda P: _autoflush_interval(
        P, str(tmp_path), monkeypatch), backend)


def _autoflush_failure(P, base, monkeypatch):
    sd = tmpdir(P, base, "s")
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd,
                                          flush_every_n_records=5))
    fid = P.REGISTRY.id_of("stat")
    monkeypatch.setattr(P.streaming.trace_format, "write_trace",
                        lambda *a, **k: (_ for _ in ()).throw(
                            OSError("disk full")))
    with pytest.warns(RuntimeWarning, match="auto-flush failed"):
        for i in range(6):
            rec.record(fid, ("/a",), 1, 0, 2 * i, 2 * i + 1)
    assert rec._autoflush_broken
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for i in range(10):
            rec.record(fid, ("/a",), 1, 0, 100 + 2 * i, 101 + 2 * i)
    err = raised(rec.flush, sd)
    monkeypatch.undo()
    assert err[0] in ("OSError", "SegmentWriteError")
    assert "disk full" in err[1]
    return err, counters(rec)


@pytest.mark.parametrize("backend", BACKENDS)
def test_autoflush_failure_never_breaks_app_calls(tmp_path, monkeypatch,
                                                  backend):
    both("autoflush_failure", lambda P: _autoflush_failure(
        P, str(tmp_path), monkeypatch), backend)


def _needs_trace_dir(P):
    rec = P.Recorder(rank=0, config=P.cfg())
    err = raised(rec.flush, "")
    assert err[0] == "ValueError" and "trace_dir" in err[1]
    return err


@pytest.mark.parametrize("backend", BACKENDS)
def test_flush_requires_trace_dir(backend):
    both("needs_dir", _needs_trace_dir, backend)


KNOBS = ("flush_every_n_records", "flush_interval_s", "max_epochs_retained",
         "ts_block_records", "encode_backend")


def _from_env(P, monkeypatch):
    monkeypatch.setenv("RECORDER_FLUSH_EVERY_N_RECORDS", "5000")
    monkeypatch.setenv("RECORDER_FLUSH_INTERVAL_S", "2.5")
    monkeypatch.setenv("RECORDER_MAX_EPOCHS_RETAINED", "8")
    monkeypatch.setenv("RECORDER_TS_BLOCK_RECORDS", "1024")
    cfg = P.RecorderConfig.from_env()
    got = {k: getattr(cfg, k) for k in KNOBS}
    # each package's own default encode backend
    assert got.pop("encode_backend") == P.RecorderConfig().encode_backend
    return got


@pytest.mark.parametrize("backend", BACKENDS)
def test_from_env_parses_flush_knobs(monkeypatch, backend):
    assert both("from_env", lambda P: _from_env(P, monkeypatch), backend) \
        == {"flush_every_n_records": 5000, "flush_interval_s": 2.5,
            "max_epochs_retained": 8, "ts_block_records": 1024}


def test_default_encode_backends_are_each_packages_own():
    assert REF.RecorderConfig().encode_backend == "auto"
    assert PORTS[0].RecorderConfig().encode_backend == "cuda"


def _rejects_knob(P, kw):
    err = raised(lambda: P.RecorderConfig(**dict(kw)), "")
    assert err[0] == "ValueError" and kw[0][0] in err[1]
    return err


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kw", [
    (("flush_every_n_records", 0),), (("flush_every_n_records", -5),),
    (("flush_interval_s", 0.0),), (("flush_interval_s", -1.0),),
    (("max_epochs_retained", 0),), (("ts_block_records", 0),)],
    ids=lambda kw: f"{kw[0][0]}={kw[0][1]}")
def test_constructor_rejects_malformed_knobs(kw, backend):
    both("rejects_knob", _rejects_knob, backend, kw)


def _env_rejects(P, monkeypatch, var, val):
    monkeypatch.setenv(var, val)
    err = raised(P.RecorderConfig.from_env, "")
    monkeypatch.delenv(var)
    assert err[0] == "ValueError" and var in err[1]
    return err


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("var,val", [
    ("RECORDER_FLUSH_EVERY_N_RECORDS", "soon"),
    ("RECORDER_FLUSH_EVERY_N_RECORDS", "0"),
    ("RECORDER_FLUSH_INTERVAL_S", "fast"),
    ("RECORDER_FLUSH_INTERVAL_S", "-1"),
    ("RECORDER_MAX_EPOCHS_RETAINED", "-3"),
    ("RECORDER_TS_BLOCK_RECORDS", "zero"),
])
def test_from_env_rejects_malformed_knobs(monkeypatch, var, val, backend):
    both("env_rejects", lambda P, a, b: _env_rejects(P, monkeypatch, a, b),
         backend, var, val)


def _tick_wrap(P, base):
    td = tmpdir(P, base, "t")
    fid = P.REGISTRY.id_of("write")
    rec = P.Recorder(config=P.cfg(trace_dir=td, ts_block_records=8))
    wrap = 1 << 32
    true_ticks = []

    def run(t, n):
        for _ in range(n):
            rec.record(fid, ("fd", b"x" * 8), 8, 0, t, t + 1)
            true_ticks.append((t, t + 1))
            t += 3

    run(wrap - 30, 20)
    rec.flush()
    run(wrap + 100, 10)
    rec.flush()
    run(3 * wrap + 7, 10)
    rec.finalize()
    got = P.TraceReader(td, mode="stitched").view().timestamps_unwrapped(0)
    assert np.array_equal(got, np.asarray(true_ticks, dtype=np.int64))
    assert (np.diff(got[:, 0]) > 0).all()
    entries = [r.t_entry for r in P.TraceReader(td, mode="stitched")
               .iter_records(0)]
    assert entries == [t & (wrap - 1) for t, _ in true_ticks]
    return got.tolist(), snap(P, td)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_wrap_unwrapped_monotonic(tmp_path, backend):
    both("tick_wrap", lambda P: _tick_wrap(P, str(tmp_path)), backend)


def _tick_wrap_merged(P, base):
    td = tmpdir(P, base, "t")
    fid = P.REGISTRY.id_of("write")
    rec = P.Recorder(config=P.cfg(trace_dir=td, ts_block_records=8))
    wrap = 1 << 32
    b = 5 * wrap + 11
    for i in range(12):
        rec.record(fid, ("fd", b"x" * 8), 8, 0, b + 3 * i, b + 3 * i + 1)
    rec.flush()
    s2 = 6 * wrap - 5
    for i in range(8):
        rec.record(fid, ("fd", b"x" * 8), 8, 0, s2 + 3 * i, s2 + 3 * i + 1)
    rec.finalize()
    got = P.TraceReader(td, mode="merged").view().timestamps_unwrapped(0)
    assert got[:, 0].tolist() == [b + 3 * i for i in range(12)] + \
        [s2 + 3 * i for i in range(8)]
    assert (got[:, 1] - got[:, 0] == 1).all()
    return got.tolist(), snap(P, td)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_wrap_survives_merged_trace(tmp_path, backend):
    both("tick_wrap_merged", lambda P: _tick_wrap_merged(P, str(tmp_path)),
         backend)


def _windowed_bandwidth(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(11), 150, 0, 1)
    drive_streaming(P, sd, [calls], [50, 100], ts_block_records=16)
    reader = P.TraceReader(sd, mode="stitched")
    view = reader.view()
    recs = list(reader.iter_records(0))

    def rec_bytes(rc):
        if rc.func not in P.specs.DATA_FUNCS:
            return 0
        spec = P.REGISTRY.spec(P.REGISTRY.id_of(rc.func))
        for a, v in zip(spec.args, rc.args):
            if a.role in (P.specs.Role.BUF, P.specs.Role.SIZE) and \
                    isinstance(v, int):
                return v
        return rc.ret if isinstance(rc.ret, int) else 0

    out = []
    for t0, t1 in ((10, 40), (0, 10 ** 6), (95, 215), (240, 260), (33, 34)):
        want = [rc for rc in recs
                if rc.t_entry < t1 and (rc.t_exit or rc.t_entry) >= t0]
        b = view.bandwidth_bounds(t0, t1)
        assert b["exact"] is True and b["n_calls"] == len(want)
        assert b["bytes"] == sum(rec_bytes(rc) for rc in want)
        assert b["lo_MBps"] == b["hi_MBps"]
        out.append(b)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_windowed_bandwidth_exact_vs_record_iterator(tmp_path, backend):
    both("bandwidth", lambda P: _windowed_bandwidth(P, str(tmp_path)),
         backend)


def _refresh_folds(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(90), 70, 0, 1)
    bounds = [0, 18, 35, 52, len(calls)]
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[bounds[0]:bounds[1]])
    rec.flush()
    reader = P.TraceReader(sd, mode="stitched")
    out = []
    for i in range(1, len(bounds) - 1):
        view = reader.view()
        view.io_summary()
        view.call_chains()
        view.consistency_pairs()
        old_view, old_total = view, view.total_records()
        t = feed(rec, calls[bounds[i]:bounds[i + 1]], t)
        rec.flush()
        assert reader.refresh() == 1 and reader.refresh() == 0
        out.append(_value_identical(reader,
                                    P.TraceReader(sd, mode="stitched")))
        assert old_view.total_records() == old_total
    assert reader.n_segments == len(bounds) - 1
    return out, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_folds_each_new_epoch_value_identically(tmp_path, backend):
    both("refresh_folds", lambda P: _refresh_folds(P, str(tmp_path)),
         backend)


def _refresh_live_world(P, base):
    sd = tmpdir(P, base, "s")
    nranks = 4
    rank_calls = [stream_calls(P, random.Random(100 + r), 20, r, nranks)
                  for r in range(nranks)]
    half = [len(c) // 2 for c in rank_calls]
    b_open = threading.Barrier(nranks + 1)
    b_go = threading.Barrier(nranks + 1)

    def worker(comm, rank):
        rec = P.Recorder(rank=rank, config=P.cfg(trace_dir=sd))
        t = feed(rec, rank_calls[rank][:half[rank]])
        rec.flush(comm)
        b_open.wait()
        b_go.wait()
        feed(rec, rank_calls[rank][half[rank]:], t)
        rec.flush(comm)

    world = threading.Thread(target=P.comm.run_thread_world,
                             args=(nranks, worker), daemon=True)
    world.start()
    b_open.wait()
    reader = P.TraceReader(sd, mode="stitched")
    view = reader.view()
    view.io_summary()
    for r in range(nranks):
        view.n_records(r)
    b_go.wait()
    world.join(timeout=30)
    assert not world.is_alive()
    assert reader.refresh() == 1
    return _value_identical(reader, P.TraceReader(sd, mode="stitched")), \
        snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_multirank_under_live_world(tmp_path, backend):
    both("refresh_live", lambda P: _refresh_live_world(P, str(tmp_path)),
         backend)


def _refresh_tail(P, base):
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(91), 40, 0, 1)
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, calls[:14])
    rec.flush()
    tail = P.TraceReader(sd, mode="tail")
    n0 = tail.view().total_records()
    assert tail.refresh() == 0
    feed(rec, calls[14:27], t)
    rec.flush()
    assert tail.refresh() == 1
    assert tail._tail_name == P.tf.segment_name(1)
    want = P.TraceReader(sd, mode="tail")
    assert tail.view().total_records() == want.view().total_records() != n0
    assert list(tail.all_records()) == list(want.all_records())
    return n0, tail.view().total_records(), snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_tail_advances_to_newest_segment(tmp_path, backend):
    both("refresh_tail", lambda P: _refresh_tail(P, str(tmp_path)), backend)


def _refresh_noops(P, base):
    td = tmpdir(P, base, "plain")
    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=td))
    feed(rec, stream_calls(P, random.Random(92), 10, 0, 1))
    rec.finalize()
    assert P.TraceReader(td).refresh() == 0
    sd = tmpdir(P, base, "s")
    drive_streaming(P, sd, [stream_calls(P, random.Random(93), 20, 0, 1)],
                    [10])
    auto = P.TraceReader(sd, mode="auto")
    assert auto._serving == "merged"
    total = auto.view().total_records()
    assert auto.refresh() == 0 and auto.view().total_records() == total
    assert P.TraceReader(sd, mode="stitched").refresh() == 0
    return bin_files(td), total, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
def test_refresh_single_and_merged_are_noops(tmp_path, backend):
    both("refresh_noops", lambda P: _refresh_noops(P, str(tmp_path)),
         backend)


def _partial_commit(P, base, crash_point):
    """A seeded crash at ``crash_point`` while a reader loop opens and
    refreshes the directory; readers see only exact committed prefixes,
    and a resumed run converges.  The reader thread's observations depend
    on the schedule, so only their validity is asserted; the returned
    result is the directory and what a fresh reader sees after the crash
    and after the resume."""
    sd = tmpdir(P, base, "s")
    calls = stream_calls(P, random.Random(94), 60, 0, 1)
    bounds = [0, 16, 31, 47, len(calls)]
    parts = [calls[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]
    stop = threading.Event()
    observed, errors = [], []

    def reader_loop():
        rdr = None
        while not stop.is_set():
            try:
                if rdr is None:
                    rdr = P.TraceReader(sd, mode="stitched")
                else:
                    rdr.refresh()
                observed.append(rdr.view().total_records())
                rdr._view = None
            except P.TraceFormatError:
                rdr = None
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))
                return

    rec = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec, parts[0])
    rec.flush()
    th = threading.Thread(target=reader_loop, daemon=True)
    th.start()
    t = feed(rec, parts[1], t)
    with P.faults.injected(P.FaultPlan(crash_point=crash_point)):
        err = raised(rec.flush, sd)
    assert err[0] == "SimulatedCrash"
    committed = 2 if crash_point == "post-commit" else 1
    mid = P.TraceReader(sd, mode="stitched")
    assert mid.n_segments == committed and mid.skipped == []
    mid_snap = snap(P, sd)
    del rec
    rec2 = P.Recorder(rank=0, config=P.cfg(trace_dir=sd))
    t = feed(rec2, parts[2], t)
    rec2.flush()
    assert rec2.epochs_resumed == committed
    feed(rec2, parts[3], t)
    rec2.flush()
    stop.set()
    th.join(timeout=30)
    assert not th.is_alive() and errors == []
    valid, acc = set(), 0
    for e in P.tf.read_manifest(sd)["segments"]:
        acc += e["n_records"]
        valid.add(acc)
    assert set(observed) <= valid
    final = P.TraceReader(sd, mode="stitched")
    assert final.n_segments == committed + 2
    lost = 0 if crash_point == "post-commit" else len(parts[1])
    assert final.view().total_records() == len(calls) - lost
    return err, counters(rec2), mid_snap, snap(P, sd)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("crash_point",
                         ["pre-rename", "pre-manifest", "post-commit"])
def test_reader_never_observes_partial_commit_across_crash(
        tmp_path, crash_point, backend):
    both("partial_commit", lambda P, c: _partial_commit(P, str(tmp_path), c),
         backend, crash_point)
