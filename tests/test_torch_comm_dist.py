"""``TorchDistComm``: the port's ``Comm`` across processes, on the CPU.

Each world is ``run_process_world``'s: N spawned processes sharing a
``FileStore`` in ``tmp_path``, each with a deadline of its own.  The
method checks run once a world size (1, 2, 3 and 5 processes) and are read
by one test a method; a small IOR (tree, flat, and streaming at one
cadence) at 4 processes must write ``.bin`` files byte-identical to the
JAX package's ``ThreadComm`` trace of the same calls and to the port's;
a seeded ``FaultPlan`` that mutes a rank must take the degraded path it
takes under ``ThreadComm``; a dead peer ends its peers' waits at once.
"""

import hashlib
import os
import time

import pytest
import torch

import _torch_dist_workers as workers
from repro.core import comm as ref_comm
from repro_torch.core import comm as port_comm
from repro_torch.core import encode_backend as eb
from repro_torch.core import trace_format
from repro_torch.distributed import dumps

SIZES = [1, 2, 3, 5]
DEADLINE_S = 60.0


def _reference_fold(size, fn, leaf):
    items = [leaf(r) for r in range(size)]
    while len(items) > 1:
        items = [fn(items[i], items[i + 1]) if i + 1 < len(items)
                 else items[i] for i in range(0, len(items), 2)]
    return items[0]


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"n{n}")
def world(request, tmp_path_factory):
    """One world a size runs ``workers.methods``; the tests below read its
    per-rank results."""
    size = request.param
    shared = str(tmp_path_factory.mktemp(f"methods{size}"))
    res = port_comm.run_process_world(
        size, workers.methods, (shared,), deadline_s=DEADLINE_S,
        workdir=os.path.join(shared, "world"))
    return size, res


def test_send_recv_fifo_per_pair(world):
    size, res = world
    for dst in range(size):
        for src in range(size):
            assert res[dst]["fifo"][src] == [("msg", src, dst, i)
                                             for i in range(3)]


def test_recv_timeout_raises_and_leaves_nothing_behind(world):
    size, res = world
    for r in range(size):
        assert 0.2 <= res[r]["timeout"] < 5.0      # CommTimeout, on time
        assert res[r]["after_timeout"] == ("late", r)
        assert res[r]["left_behind"] is False


def test_gather(world):
    size, res = world
    want = [("g", r) for r in range(size)]
    for r in range(size):
        assert res[r]["gather"][0] == (want if r == 0 else None)
        assert res[r]["gather"][1] == (want if r == size - 1 else None)


def test_bcast(world):
    size, res = world
    big = bytes(range(256)) * 4096
    for r in range(size):
        assert res[r]["bcast"] == [("b", 0, big), ("b", size - 1, big)]
        assert res[r]["bcast_none"] is None


def test_scatter(world):
    size, res = world
    assert [res[r]["scatter"] for r in range(size)] == [
        ("s", r) for r in range(size)]


def test_barrier(world):
    size, res = world
    for r in range(size):
        assert res[r]["barrier"] == sorted(f"arrived-{size}-{q}"
                                           for q in range(size))


def test_vote_any(world):
    size, res = world
    for r in range(size):
        assert res[r]["vote_any"] == [True, False, True]
        assert res[r]["agree"] == (True, frozenset(range(size)))


def test_reduce_tree_and_gather_tree_fold_like_the_reference(world):
    size, res = world
    assert res[0]["reduce_tree"] == _reference_fold(
        size, lambda a, b: a + b, lambda r: f"[{r}]")
    assert res[0]["gather_tree"] == [("t", r) for r in range(size)]
    for r in range(1, size):
        assert res[r]["reduce_tree"] is None
        assert res[r]["gather_tree"] is None


def test_dup_is_isolated_under_a_second_thread(world):
    size, res = world
    for r in range(size):
        for i, (fg, bg) in enumerate(zip(res[r]["dup"]["fg"],
                                         res[r]["dup"]["bg"])):
            want_fg = _reference_fold(size, lambda a, b: a + b,
                                      lambda q: f"[{q}:{i}]")
            want_bg = _reference_fold(size, lambda a, b: a + b,
                                      lambda q: f"<{q}:{i}>")
            assert fg[0] == (want_fg if r == 0 else None)
            assert bg[0] == (want_bg if r == 0 else None)
            assert fg[1] == ("fg", i) and bg[1] == ("bg", i)
            assert fg[2] == ([("fg", q, i) for q in range(size)]
                             if r == 0 else None)
            assert bg[2] == ([("bg", q, i) for q in range(size)]
                             if r == 0 else None)


def test_payloads_refuse_a_device_tensor():
    assert len(dumps({"x": torch.arange(3), "y": b"\0" * 9})) > 0
    with pytest.raises(TypeError, match="cannot travel"):
        dumps([1, {"t": torch.empty(2, device="meta")}])


def test_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="initialised"):
        port_comm.TorchDistComm()


def test_takes_rank_size_and_store_from_the_default_group(tmp_path):
    """Ranks that join a gloo default group themselves build their comm
    with ``TorchDistComm()``, as under ``torchrun``."""
    res = port_comm.run_process_world(
        2, workers.default_group, (str(tmp_path / "init"),),
        deadline_s=DEADLINE_S, workdir=str(tmp_path / "world"))
    assert res == [(0, 2, [("rank", 0), ("rank", 1)], "word"),
                   (1, 2, None, "word")]


@pytest.mark.parametrize("how", ["raise", "exit"])
def test_dead_peer_ends_the_waits_on_it(tmp_path, how):
    """Rank 2 raises, or dies; ranks 0 and 1, waiting on it with the 60 s
    default patience, end with an error at once, and the world fails."""
    t = time.monotonic()
    with pytest.raises(port_comm.WorldError) as info:
        port_comm.run_process_world(3, workers.peer_dies, (how,),
                                    deadline_s=DEADLINE_S,
                                    workdir=str(tmp_path))
    assert time.monotonic() - t < 30
    err = info.value
    assert sorted(err.errors) == [2]
    assert ("exit" if how == "exit" else "ValueError") in err.errors[2]
    for r in (0, 1):
        kind, msg, waited = err.results[r]
        assert kind == "RuntimeError" and "peer failed" in msg
        assert waited < 10


def test_world_past_its_deadline_is_killed(tmp_path):
    """Rank 1 never returns: past the deadline the world is killed and
    the call raises, naming rank 1."""
    t = time.monotonic()
    with pytest.raises(port_comm.WorldError) as info:
        port_comm.run_process_world(2, workers.hangs, deadline_s=15.0,
                                    workdir=str(tmp_path))
    assert time.monotonic() - t < 45
    assert "no result" in info.value.errors[1]


# ---------------------------------------------------------------------------
# traces across processes
# ---------------------------------------------------------------------------


def _bins(tdir):
    """Relative path -> sha256 of every ``*.bin`` under ``tdir``."""
    out = {}
    for root, _dirs, files in os.walk(tdir):
        for name in files:
            if name.endswith(".bin"):
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, tdir)] = hashlib.sha256(
                        f.read()).hexdigest()
    assert out, f"no trace files under {tdir}"
    return out


def _thread_world(comm_mod, fn, *args):
    return comm_mod.run_thread_world(
        workers.NPROCS, lambda comm, rank: fn(comm, rank, *args))


@pytest.fixture(scope="module")
def ior_traces(tmp_path_factory):
    """The IOR jobs on 4 processes (the port, ``numpy`` backend), on 4
    port ThreadComm threads and on 4 JAX-package ThreadComm threads."""
    base = tmp_path_factory.mktemp("ior")
    saved = eb.default_backend()
    eb.set_default_backend("numpy")
    try:
        procs = port_comm.run_process_world(
            workers.NPROCS, workers.ior_rank_all,
            ("repro_torch", str(base / "procs"), "numpy"),
            deadline_s=DEADLINE_S, workdir=str(base / "world"))
        port = _thread_world(port_comm, workers.ior_rank_all, "repro_torch",
                             str(base / "port"), "numpy")
        ref = _thread_world(ref_comm, workers.ior_rank_all, "repro",
                            str(base / "ref"), "numpy")
    finally:
        eb.set_default_backend(saved)
    return base, procs, port, ref


@pytest.mark.parametrize("job", ["tree", "flat", "stream"])
def test_ior_across_processes_matches_threadcomm(ior_traces, job):
    base, procs, port, ref = ior_traces
    n = 2 * workers.N_ITER + 3
    for res in (procs, port, ref):
        assert res[0][job] == n
        assert all(r[job] is None for r in res[1:])
    got = _bins(base / "procs" / job)
    assert got == _bins(base / "port" / job)
    assert got == _bins(base / "ref" / job)
    if job == "stream":
        assert sum(d.startswith("epoch_") for d in os.listdir(
            base / "procs" / job)) == -(-n // 20)
        assert any(p.startswith("merged") for p in got)


def test_seeded_drop_takes_the_threadcomm_degraded_path(tmp_path):
    """Rank 2 mute in the first flush at 4 ranks: rank 3's subtree goes
    with it, both retry, and the epochs, masks and bytes are ThreadComm's."""
    saved = eb.default_backend()
    eb.set_default_backend("numpy")
    try:
        procs = port_comm.run_process_world(
            workers.NPROCS, workers.degraded_rank,
            ("repro_torch", str(tmp_path / "procs"), 2),
            deadline_s=DEADLINE_S, workdir=str(tmp_path / "world"))
        threads = _thread_world(port_comm, workers.degraded_rank,
                                "repro_torch", str(tmp_path / "threads"), 2)
    finally:
        eb.set_default_backend(saved)
    assert procs == threads
    assert [r[0] for r in procs] == [0, 0, 1, 1]    # ranks 2, 3 retried
    assert procs[0][1] == 1                          # one degraded epoch
    for sd in ("procs", "threads"):
        entry = trace_format.read_manifest(str(tmp_path / sd))["segments"][0]
        assert entry["ranks_present"] == [0, 1]
    assert _bins(tmp_path / "procs") == _bins(tmp_path / "threads")
