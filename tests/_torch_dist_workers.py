"""Per-rank bodies of ``tests/test_torch_comm_dist.py``.

Spawned processes import this module by name (the ``tests`` directory is
on the path pytest gives them), so it imports neither JAX nor the test
module.  The IOR and degraded-flush bodies take the package to trace with
(``"repro_torch"`` in the spawned ranks, ``"repro"`` or ``"repro_torch"``
on ThreadComm threads in the test process), so every side runs the same
calls."""

from __future__ import annotations

import importlib
import os
import random
import threading
import time

NPROCS = 4
N_ITER = 40
XFER = 1 << 20


def methods(comm, rank, shared_dir):
    """Every ``Comm`` method once or more; returns what this rank saw."""
    from repro_torch.core.comm import CommTimeout

    size = comm.size
    out = {}
    # FIFO per pair: three messages to every rank (itself too), sends to
    # the destinations interleaved
    for i in range(3):
        for dst in range(size):
            comm.send(("msg", rank, dst, i), dst)
    out["fifo"] = {src: [comm.recv(src) for _ in range(3)]
                   for src in range(size)}
    # a timed receive that expires takes nothing: the message sent after
    # it is the next receive's
    peer_in, peer_out = (rank + 1) % size, (rank - 1) % size
    t = time.monotonic()
    try:
        comm.recv(peer_in, timeout=0.2)
        out["timeout"] = None
    except CommTimeout:
        out["timeout"] = time.monotonic() - t
    comm.barrier()
    comm.send(("late", peer_out), peer_out)
    out["after_timeout"] = comm.recv(peer_in)
    key = comm._t._box("p2p", peer_in, rank, comm._t._taken[("p2p",
                                                             peer_in)])
    out["left_behind"] = comm._t._call("check", [key])
    out["gather"] = [comm.gather(("g", rank), root=root)
                     for root in (0, size - 1)]
    big = bytes(range(256)) * 4096
    out["bcast"] = [comm.bcast(("b", root, big) if rank == root else None,
                               root=root)
                    for root in (0, size - 1)]
    out["bcast_none"] = comm.bcast(None)
    out["scatter"] = comm.scatter(
        [("s", r) for r in range(size)] if rank == size - 1 else None,
        root=size - 1)
    with open(os.path.join(shared_dir, f"arrived-{size}-{rank}"), "w"):
        pass
    comm.barrier()
    out["barrier"] = sorted(f for f in os.listdir(shared_dir)
                            if f.startswith(f"arrived-{size}-"))
    out["vote_any"] = [comm.vote_any(rank == size - 1),
                       comm.vote_any(False), comm.vote_any(True)]
    out["reduce_tree"] = comm.reduce_tree(f"[{rank}]", lambda a, b: a + b)
    out["gather_tree"] = comm.gather_tree(("t", rank))
    out["dup"] = dup_isolation(comm, rank)
    out["agree"] = comm.agree(rank == size - 1, timeout=5.0)
    return out


def dup_isolation(comm, rank, rounds=20):
    """A second thread runs collectives on ``comm.dup("bg")`` while this
    one runs them on ``comm``; each must see only its own."""
    bg = comm.dup("bg")
    assert comm.dup("bg") is bg
    seen = {}

    def background():
        seen["bg"] = [(bg.reduce_tree(f"<{rank}:{i}>", lambda a, b: a + b),
                       bg.bcast(("bg", i) if rank == 0 else None),
                       bg.gather(("bg", rank, i)))
                      for i in range(rounds)]

    t = threading.Thread(target=background)
    t.start()
    fg = [(comm.reduce_tree(f"[{rank}:{i}]", lambda a, b: a + b),
           comm.bcast(("fg", i) if rank == 0 else None),
           comm.gather(("fg", rank, i)))
          for i in range(rounds)]
    t.join(timeout=60)
    assert not t.is_alive(), "the dup's thread did not finish"
    return {"fg": fg, "bg": seen["bg"]}


def peer_dies(comm, rank, how):
    """Rank 2 raises or exits; the others wait on it with the comm's
    default patience and must end at the next poll with an error."""
    if rank == 2:
        if how == "exit":
            os._exit(3)
        raise ValueError("rank 2 gives up")
    t = time.monotonic()
    try:
        comm.recv(2)
    except RuntimeError as e:
        return (type(e).__name__, str(e), time.monotonic() - t)
    return None


def hangs(comm, rank):
    if rank == 1:
        time.sleep(3600)
    return rank


def _pkg(name, backend):
    """The package's recorder module and registry; the port gets
    ``backend`` as its encode default (its grammar packing follows the
    default, ``cuda``, which a spawned rank starts from; the test process
    sets and restores it around its ThreadComm runs)."""
    importlib.import_module(f"{name}.core.apis")   # populate the registry
    if name == "repro_torch":
        importlib.import_module(f"{name}.core.encode_backend"
                                ).set_default_backend(backend)
    return (importlib.import_module(f"{name}.core.recorder"),
            importlib.import_module(f"{name}.core.specs").REGISTRY)


def ior_rank(comm, rank, pkg, trace_dir, topology, backend, flush_every=0):
    """IOR (paper Listing 3) at ``NPROCS`` ranks x ``N_ITER`` iterations,
    ticks from a per-rank seed; with ``flush_every``, an explicit flush
    every that many records (multi-rank flushes are collective)."""
    rec_mod, registry = _pkg(pkg, backend)
    fid = {n: registry.id_of(n) for n in ("open", "lseek", "write", "fsync",
                                          "close")}
    cfg = rec_mod.RecorderConfig(finalize_topology=topology,
                                 encode_backend=backend,
                                 trace_dir=trace_dir if flush_every else None)
    rec = rec_mod.Recorder(rank=rank, config=cfg)
    rng = random.Random(rank)
    n = 2 * N_ITER + 3
    ticks = iter([(2 * i + rng.randrange(2), 2 * i + 1 + rng.randrange(2))
                  for i in range(n)])
    done = 0

    def record(f, args, ret):
        nonlocal done
        rec.record(f, args, ret, 0, *next(ticks))
        done += 1
        if flush_every and done % flush_every == 0:
            rec.flush(comm)

    fd = 3
    record(fid["open"], ("/data/ior/shared.bin", 66, 0o644), fd)
    for i in range(N_ITER):
        off = rank * XFER + i * comm.size * XFER
        record(fid["lseek"], (fd, off, 0), off)
        record(fid["write"], (fd, XFER), XFER)
    record(fid["fsync"], (fd,), 0)
    record(fid["close"], (fd,), 0)
    rec.forget_handle(fd)
    stats = rec.finalize(comm, trace_dir=trace_dir)
    return None if stats is None else stats.n_records


def ior_rank_all(comm, rank, pkg, root, backend):
    """``ior_rank`` tree, flat and streaming every 20 records, each into
    ``root/<name>``."""
    return {name: ior_rank(comm, rank, pkg, os.path.join(root, name),
                           topology, backend, flush)
            for name, topology, flush in (("tree", "tree", 0),
                                          ("flat", "flat", 0),
                                          ("stream", "tree", 20))}


def _calls(registry, rank, n_calls, seed):
    rng = random.Random(seed + rank)
    fids = {name: registry.id_of(name)
            for name in ("open", "close", "pwrite", "lseek", "write")}
    fd = f"fd-{rank}"
    calls = [(fids["open"], ("/data/f.bin", 2, 438), fd)]
    for i in range(n_calls):
        kind = rng.random()
        if kind < 0.6:
            off = rank * 4096 + i * NPROCS * 4096
            calls.append((fids["pwrite"], (fd, b"x" * 4096, off), 4096))
        elif kind < 0.8:
            calls.append((fids["lseek"], (fd, rank * 256 + i * 256, 0),
                          rank * 256 + i * 256))
        else:
            calls.append((fids["write"], (fd, b"z" * 128), 128))
    calls.append((fids["close"], (fd,), 0))
    return calls


def degraded_rank(comm, rank, pkg, trace_dir, dead):
    """A seeded ``FaultPlan`` mutes rank ``dead``'s sends for the first
    flush (every rank installs the same plan): the survivors commit a
    degraded epoch, then the rank recovers and the next flush covers the
    rest."""
    rec_mod, registry = _pkg(pkg, "numpy")
    faults = importlib.import_module(f"{pkg}.core.faults")
    faults.install(faults.FaultPlan(seed=7, dead_ranks=(dead,)))
    rec = rec_mod.Recorder(rank=rank, config=rec_mod.RecorderConfig(
        trace_dir=trace_dir, flush_timeout_s=2.0, encode_backend="numpy"))
    comm.barrier()      # the flush's timeouts start from the same moment
    t = 0
    for f, args, ret in _calls(registry, rank, 8, 40):
        rec.record(f, args, ret, 0, t, t + 1)
        t += 2
    rec.flush(comm)
    comm.barrier()
    faults.uninstall()                  # the mute rank recovers
    comm.barrier()
    for f, args, ret in _calls(registry, rank, 5, 50):
        rec.record(f, args, ret, 0, t, t + 1)
        t += 2
    rec.flush(comm)
    rec.finalize(comm)
    return (rec.epochs_restored, rec.epochs_degraded,
            rec.last_flush_outcome.lost_local)


def default_group(comm, rank, init_file):
    """``TorchDistComm()`` in a gloo default group that the rank joins
    itself, as under ``torchrun``: it takes the group's rank, size and
    store, and a gather, a bcast and a barrier go through."""
    import torch.distributed as dist

    from repro_torch.core.comm import TorchDistComm

    # the world lives on one host: let gloo bind the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=comm.size)
    try:
        own = TorchDistComm(timeout=30.0)
        got = own.gather(("rank", own.rank))
        word = own.bcast("word" if own.rank == 0 else None)
        own.barrier()
        return own.rank, own.size, got, word
    finally:
        dist.destroy_process_group()


#: the calls of a durability rank and the records after which it flushes
DURABLE_CALLS, DURABLE_BOUNDS = 24, (8, 14, 20)


def durability_rank(comm, rank, pkg, trace_dir, part, backend="numpy"):
    """Rank 1 mute in epoch 0 (a seeded ``FaultPlan`` on every rank, then
    recovered), flushes after ``DURABLE_BOUNDS`` records, a finalize.
    ``part`` "whole" runs it all; "crash" stops at epoch 2, whose commit
    crashes at ``pre-manifest`` on rank 0 (the process dies holding the
    epoch's records); "resume" is the restarted job: it records epoch 2's
    and epoch 3's calls again, at the same ticks, into the same directory
    and finalizes.  Returns the epoch counters and the first flush's
    ``ranks_present``."""
    rec_mod, registry = _pkg(pkg, backend)
    faults = importlib.import_module(f"{pkg}.core.faults")
    calls = _calls(registry, rank, DURABLE_CALLS - 2, 60)
    bounds = (0,) + DURABLE_BOUNDS + (len(calls),)
    rec = rec_mod.Recorder(rank=rank, config=rec_mod.RecorderConfig(
        trace_dir=trace_dir, flush_timeout_s=2.0, encode_backend=backend))

    def feed(epoch):
        for i in range(bounds[epoch], bounds[epoch + 1]):
            f, args, ret = calls[i]
            rec.record(f, args, ret, 0, 2 * i, 2 * i + 1)

    present = None
    if part in ("whole", "crash"):
        faults.install(faults.FaultPlan(seed=7, dead_ranks=(1,)))
        comm.barrier()      # the flush's timeouts start from one moment
        feed(0)
        rec.flush(comm)
        present = list(rec.last_flush_outcome.ranks_present)
        comm.barrier()
        faults.uninstall()                  # the mute rank recovers
        comm.barrier()
        feed(1)
        rec.flush(comm)
        if part == "crash" and rank == 0:
            faults.install(faults.FaultPlan(crash_point="pre-manifest"))
    feed(2)
    rec.flush(comm)
    feed(3)
    rec.finalize(comm)
    return (present, rec.epochs_resumed, rec.epochs_restored,
            rec.epochs_degraded)
