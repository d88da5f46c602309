"""Communicator abstraction for the finalization collectives (paper §3.3).

Recorder's inter-process compression needs gather (CSTs, CFGs to rank 0),
bcast (terminal remaps back out) and -- for the scalable tree finalize --
``reduce_tree``: a pairwise reduction over *adjacent rank* pairs that runs
in ceil(log2(size)) rounds.  In round k (stride s = 2**k), every rank with
``rank % 2s == s`` ships its accumulated value to ``rank - s``, which folds
it with ``fn(left, right)``; after the last round rank 0 holds the full
reduction.  ``fn`` must accept (lower-rank-block value, adjacent
higher-rank-block value) -- Recorder passes
``interprocess.merge_serialized_states``, so the values on the wire are
opaque byte strings and any byte-transport backend can carry them.

The original uses MPI; here the carrier is the host-process group.

Implementations:

  SoloComm    single process (the common real-runtime case per host group
              of size 1, and the degenerate default).
  ThreadComm  N real threads with barrier semantics -- used in tests to
              exercise the SPMD finalize path concurrently.  Implements
              true point-to-point ``send``/``recv`` over per-pair
              mailboxes, so ``reduce_tree`` runs the genuine log-round
              pairwise schedule (no shared-slot barrier walk).

A multi-host communicator over ``torch.distributed`` is not part of this
package yet; :func:`reduce_tree_via_exchange` is the schedule a collective
byte exchange plugs into.

Point-to-point transports advertise ``has_p2p``; the base ``reduce_tree``
then runs the distributed schedule directly on ``send``/``recv``.
Transports without p2p fall back to gather + fold adjacent pairs in
log-rounds at the root -- the same association order, hence byte-identical
results; only the communication pattern differs.

``vote_any`` is the cadence collective of the streaming flusher: every
rank contributes a local boolean and all ranks learn the OR, so non-SPMD
ranks decide to flush (or to coalesce an epoch while a background commit
is in flight) in lockstep.  ``dup`` hands out an independent collective
context (the MPI_Comm_dup analogue): the Recorder's background flusher
runs its collectives on a dup'd comm so they can never interleave with
the application's foreground collectives on the primary one.

Simulated large-scale ranks (the 16K-process experiments) do not go through
a Comm at all: benchmarks call the pure functions in ``interprocess.py``
directly on lists of rank states (``tree_finalize_ranks`` mirrors the
collective's pairing exactly).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

#: seconds a ThreadComm recv waits before concluding the peer is gone
#: (the default; per-call ``recv(..., timeout=)`` and the degraded
#: collectives override it with the configured flush timeout)
_RECV_TIMEOUT_S = 60.0


class CommTimeout(RuntimeError):
    """A point-to-point receive (or a timed collective built on one) gave
    up waiting for a peer.  The degraded flush protocol catches this to
    substitute an absent rank's contribution; anything else propagating it
    means a peer really is gone."""


def reduce_rounds(size: int) -> List[List[Tuple[int, int]]]:
    """The (src, dst) pairs of every round of the log-round tree schedule:
    in the round of stride ``s``, rank ``r`` with ``r % 2s == s`` ships its
    accumulated value to ``r - s``.  Shared by the p2p path, the collective
    exchange path and the ThreadComm tests, so every transport provably
    runs the same pairing (and therefore the same association order as the
    gather fallback)."""
    rounds: List[List[Tuple[int, int]]] = []
    s = 1
    while s < size:
        rounds.append([(r, r - s) for r in range(s, size, 2 * s)])
        s *= 2
    return rounds


def reduce_tree_via_exchange(rank: int, size: int, obj: Any,
                             fn: Callable[[Any, Any], Any],
                             exchange: Callable[[Optional[Any], list], Any],
                             root: int = 0) -> Optional[Any]:
    """The log-round schedule on a COLLECTIVE byte mover: every rank calls
    ``exchange(payload_or_None, perm)`` once per round with the identical
    perm list (SPMD -- e.g. a collective permute), and the call returns the
    payload addressed to this rank (None for non-receivers).  Senders ship
    their accumulated value and drop out; receivers fold.  Association
    order matches :func:`reduce_rounds`, hence byte-identical to every
    other topology."""
    assert root == 0, "tree reduction is rooted at rank 0"
    val = obj
    for perm in reduce_rounds(size):
        senders = {src for src, _ in perm}
        receivers = {dst for _, dst in perm}
        got = exchange(val if rank in senders else None, perm)
        if rank in senders:
            val = None
        elif rank in receivers:
            val = fn(val, got)
    return val if rank == 0 else None


class Comm:
    rank: int
    size: int
    #: transports with independent pairwise send/recv set this True; the
    #: base reduce_tree then runs the distributed schedule on them
    has_p2p: bool = False

    def gather(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        raise NotImplementedError

    def bcast(self, obj: Any, root: int = 0) -> Any:
        raise NotImplementedError

    def scatter(self, objs: Optional[List[Any]], root: int = 0) -> Any:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def send(self, obj: Any, dest: int) -> None:
        """Point-to-point send (only on transports with ``has_p2p``)."""
        raise NotImplementedError

    def recv(self, source: int, timeout: Optional[float] = None) -> Any:
        """Point-to-point receive (only on transports with ``has_p2p``).
        ``timeout`` overrides the transport's default patience; expiry
        raises :class:`CommTimeout`."""
        raise NotImplementedError

    def dup(self, key: str = "dup") -> "Comm":
        """An independent collective context over the same ranks (the
        MPI_Comm_dup analogue): collectives on the dup never interleave
        with collectives on the parent, so a background thread (the async
        epoch flusher) can safely run its own collective sequence.  Every
        rank must dup with the same ``key``.  The base implementation
        returns ``self`` -- correct for single-rank comms and for
        transports whose collectives are already tagged; concurrent
        multi-rank transports must override."""
        return self

    def vote_any(self, flag: bool) -> bool:
        """Collective boolean OR: every rank passes its local flag, every
        rank returns whether ANY rank's flag was set.  The streaming
        flusher's cadence collective (one barrier-sized exchange), so
        non-SPMD ranks flush in lockstep."""
        votes = self.gather(bool(flag))
        return bool(self.bcast(any(votes) if votes is not None else None))

    def reduce_tree(self, obj: Any, fn: Callable[[Any, Any], Any],
                    root: int = 0) -> Optional[Any]:
        """Pairwise tree reduction; root returns the folded value, other
        ranks None.  On p2p transports this runs the true distributed
        log-round schedule (:func:`reduce_rounds`): a sender ships its
        accumulated value once and is done; a receiver folds one incoming
        value per round.  Transports without p2p fall back to gather +
        fold adjacent pairs in log-rounds at the root (same association
        order, hence identical results)."""
        if self.has_p2p and self.size > 1:
            return self._reduce_tree_p2p(obj, fn, root)
        gathered = self.gather(obj, root=root)
        if gathered is None:
            return None
        items = list(gathered)
        while len(items) > 1:
            items = [fn(items[i], items[i + 1])
                     if i + 1 < len(items) else items[i]
                     for i in range(0, len(items), 2)]
        return items[0]

    def _reduce_tree_p2p(self, obj: Any, fn: Callable[[Any, Any], Any],
                         root: int = 0) -> Optional[Any]:
        assert root == 0, "tree reduction is rooted at rank 0"
        val = obj
        for perm in reduce_rounds(self.size):
            for src, dst in perm:
                if self.rank == src:
                    self.send(val, dst)
                    return None  # shipped: this rank is done contributing
                if self.rank == dst:
                    val = fn(val, self.recv(src))
                    break
        return val if self.rank == 0 else None

    def gather_tree(self, obj: Any, root: int = 0) -> Optional[List[Any]]:
        """Gather through the pairwise reduction tree instead of a direct
        rank-0 fan-in: per-rank payloads travel as concatenated
        ``(rank, value)`` lists through :meth:`reduce_tree`, so every hop
        carries one merged list and the root never receives ``size``
        simultaneous messages (the transport Recorder uses for per-rank
        timestamp payloads during streaming flushes and tree finalize).
        Root returns the values in rank order; other ranks return None."""
        merged = self.reduce_tree([(self.rank, obj)], lambda a, b: a + b,
                                  root=root)
        if merged is None:
            return None
        return [v for _, v in sorted(merged, key=lambda rv: rv[0])]

    # -- degraded (fault-tolerant) collectives --------------------------------
    #
    # The timed collectives below are entirely barrier-free: they run on
    # tagged point-to-point messages only, so a dead or unresponsive rank
    # stalls exactly the peers waiting on it for exactly the configured
    # timeout -- never the whole world forever.  Every invocation bumps a
    # per-comm sequence counter used as the message tag; because the alive
    # ranks invoke collectives in lockstep (collective call discipline),
    # a receiver can discard any message tagged below its expectation
    # (a straggler from an earlier, already-degraded collective) without
    # ambiguity.  Callers must therefore issue all timed collectives on
    # one comm object in the same order on every participating rank.

    def _bump_seq(self) -> int:
        s = getattr(self, "_p2p_seq", 0) + 1
        self._p2p_seq = s
        return s

    def _recv_tagged(self, source: int, tag: int,
                     timeout: Optional[float]) -> Any:
        """Receive from ``source`` discarding stale (lower-tagged)
        messages; raises :class:`CommTimeout` on expiry and RuntimeError
        on a future tag (a protocol bug, not a fault)."""
        while True:
            t, payload = self.recv(source, timeout=timeout)
            if t == tag:
                return payload
            if t > tag:
                raise RuntimeError(
                    f"rank {self.rank}: tag {t} from rank {source} is ahead "
                    f"of expected {tag} -- timed collectives were not "
                    f"invoked in lockstep")
            # t < tag: a delayed straggler from an earlier collective

    def reduce_tree_partial(self, obj: Any, fn: Callable[[Any, Any], Any],
                            absent: Callable[[int, int], Any],
                            timeout: Optional[float]) -> Optional[Any]:
        """The log-round tree reduction with per-hop receive timeouts:
        when the peer owning ranks ``[src, hi)`` never delivers, its whole
        subtree contribution is substituted with ``absent(src, hi)`` (an
        explicitly-empty block), so the fold stays structurally complete
        and rank 0 still finishes within O(log N) timeouts.  Root returns
        the folded value, other ranks None."""
        assert self.has_p2p, "reduce_tree_partial needs a p2p transport"
        tag = self._bump_seq()
        val = obj
        s = 1
        r = self.rank
        while s < self.size:
            if r % (2 * s) == s:
                self.send((tag, val), r - s)
                return None
            if r % (2 * s) == 0 and r + s < self.size:
                src = r + s
                try:
                    got = self._recv_tagged(src, tag, timeout)
                except CommTimeout:
                    got = absent(src, min(src + s, self.size))
                val = fn(val, got)
            s *= 2
        return val if r == 0 else None

    def verdict_patience(self, timeout: Optional[float]) -> Optional[float]:
        """How long a non-root rank should wait for rank 0's
        post-collective verdict.  Rank 0 may legitimately spend one full
        ``timeout`` per tree round absorbing dead subtrees before it can
        fan anything out, so a verdict wait equal to the per-hop timeout
        would race rank 0's own patience and spuriously self-degrade;
        scale it by tree depth plus one round of slack for rank 0's local
        work (the segment commit)."""
        if timeout is None:
            return None
        rounds = max(1, (self.size - 1).bit_length())
        return timeout * (rounds + 1)

    def bcast_p2p(self, obj: Any, timeout: Optional[float]) -> Any:
        """Rank 0 fans ``obj`` out over point-to-point sends; other ranks
        receive it with a timeout (:class:`CommTimeout` on expiry -- the
        caller decides what a missing verdict means).  A flat fan-out, not
        a tree: an absent interior rank must not cut its subtree off from
        the verdict."""
        assert self.has_p2p, "bcast_p2p needs a p2p transport"
        tag = self._bump_seq()
        if self.rank == 0:
            for dst in range(1, self.size):
                self.send((tag, obj), dst)
            return obj
        return self._recv_tagged(0, tag, timeout)

    def agree(self, flag: bool, timeout: Optional[float] = None
              ) -> Tuple[bool, frozenset]:
        """Survivor vote: boolean OR over the ranks that answered in time.

        Returns ``(verdict, present)`` where ``present`` is the set of
        ranks whose votes reached rank 0.  With no timeout (or no p2p
        transport) this is exactly :meth:`vote_any` with full presence;
        with a timeout it is the degraded protocol's barrier replacement:
        unresponsive ranks are voted around, and a rank that cannot even
        reach rank 0's verdict falls back to its own flag with
        self-only presence (its caller then treats the step as failed
        locally instead of deadlocking)."""
        if self.size == 1:
            return bool(flag), frozenset({self.rank})
        if timeout is None or not self.has_p2p:
            return self.vote_any(flag), frozenset(range(self.size))
        leaf = (bool(flag), (self.rank,))
        folded = self.reduce_tree_partial(
            leaf, lambda a, b: (a[0] or b[0], a[1] + b[1]),
            lambda lo, hi: (False, ()), timeout)
        if self.rank == 0:
            verdict, present = bool(folded[0]), frozenset(folded[1])
            self.bcast_p2p((verdict, sorted(present)), timeout)
            return verdict, present
        try:
            verdict, present = self.bcast_p2p(
                None, self.verdict_patience(timeout))
        except CommTimeout:
            return bool(flag), frozenset({self.rank})
        return bool(verdict), frozenset(present)


class SoloComm(Comm):
    rank = 0
    size = 1

    def gather(self, obj, root=0):
        return [obj]

    def bcast(self, obj, root=0):
        return obj

    def scatter(self, objs, root=0):
        assert objs is not None and len(objs) == 1
        return objs[0]

    def barrier(self):
        pass


class _ThreadWorld:
    def __init__(self, size: int,
                 failed: Optional[threading.Event] = None):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots: List[Any] = [None] * size
        self.root_box: List[Any] = [None]
        # shared with sub-worlds: one rank failing must unblock every
        # barrier AND every pending point-to-point recv everywhere
        self.failed = failed if failed is not None else threading.Event()
        self._mail: Dict[Tuple[int, int], "queue.Queue[Any]"] = {}
        self._sub: Dict[str, "_ThreadWorld"] = {}
        self._lock = threading.Lock()

    def mailbox(self, src: int, dst: int) -> "queue.Queue[Any]":
        with self._lock:
            q = self._mail.get((src, dst))
            if q is None:
                q = self._mail[(src, dst)] = queue.Queue()
            return q

    def subworld(self, key: str) -> "_ThreadWorld":
        """The shared sub-world behind ``ThreadComm.dup(key)``: every rank
        duping with the same key lands on the same world object."""
        with self._lock:
            w = self._sub.get(key)
            if w is None:
                w = self._sub[key] = _ThreadWorld(self.size,
                                                 failed=self.failed)
            return w

    def abort(self) -> None:
        """Break every barrier (this world and all sub-worlds) and flag
        pending receives; called when any rank dies."""
        self.failed.set()
        try:
            self.barrier.abort()
        except Exception:
            pass
        with self._lock:
            subs = list(self._sub.values())
        for w in subs:
            w.abort()


class ThreadComm(Comm):
    """Barrier-synchronized communicator over threads in one process."""

    has_p2p = True

    def __init__(self, world: _ThreadWorld, rank: int):
        self._w = world
        self.rank = rank
        self.size = world.size

    def dup(self, key: str = "dup") -> "ThreadComm":
        return ThreadComm(self._w.subworld(key), self.rank)

    def send(self, obj: Any, dest: int) -> None:
        from . import faults

        plan = faults.get_active()
        q = self._w.mailbox(self.rank, dest)
        if plan is not None:
            act = plan.on_send(self.rank, dest)
            if act == "drop":
                return
            if isinstance(act, float):
                t = threading.Timer(act, q.put, args=(obj,))
                t.daemon = True
                t.start()
                return
        q.put(obj)

    def recv(self, source: int, timeout: Optional[float] = None) -> Any:
        """Blocking per-pair FIFO receive.  Each (src, dst) channel is its
        own queue, so a fast sender racing ahead into the next collective
        cannot overtake its earlier message; a failed peer (the world's
        ``failed`` flag, set by ``run_thread_world``) unblocks the wait
        with an error instead of deadlocking.  Polling backs off
        exponentially (1ms -> 50ms) so short timeouts stay responsive
        without spinning the long waits."""
        q = self._w.mailbox(source, self.rank)
        limit = _RECV_TIMEOUT_S if timeout is None else timeout
        waited = 0.0
        poll = 0.001
        while True:
            try:
                return q.get(timeout=poll)
            except queue.Empty:
                if self._w.failed.is_set():
                    raise RuntimeError(
                        f"rank {self.rank}: peer failed while receiving "
                        f"from rank {source}") from None
                waited += poll
                if waited >= limit:
                    raise CommTimeout(
                        f"rank {self.rank}: timed out receiving from rank "
                        f"{source} after {limit:g}s") from None
                poll = min(poll * 2, 0.05)

    def gather(self, obj, root=0):
        self._w.slots[self.rank] = obj
        self._w.barrier.wait()
        out = list(self._w.slots) if self.rank == root else None
        self._w.barrier.wait()
        return out

    def bcast(self, obj, root=0):
        if self.rank == root:
            self._w.root_box[0] = obj
        self._w.barrier.wait()
        out = self._w.root_box[0]
        self._w.barrier.wait()
        return out

    def scatter(self, objs, root=0):
        if self.rank == root:
            assert objs is not None and len(objs) == self.size
            self._w.slots[:] = objs
        self._w.barrier.wait()
        out = self._w.slots[self.rank]
        self._w.barrier.wait()
        return out

    def barrier(self):
        self._w.barrier.wait()

    def vote_any(self, flag):
        """Barrier-piggybacked OR: one slot write + two barrier waits
        (half the cost of gather + bcast), every rank reads the verdict."""
        self._w.slots[self.rank] = bool(flag)
        self._w.barrier.wait()
        out = any(self._w.slots)
        self._w.barrier.wait()
        return out


def run_thread_world(size: int, fn: Callable[[Comm, int], Any]) -> List[Any]:
    """Run ``fn(comm, rank)`` on ``size`` threads; returns per-rank results."""
    world = _ThreadWorld(size)
    results: List[Any] = [None] * size
    errors: List[Optional[BaseException]] = [None] * size

    def worker(r: int) -> None:
        try:
            results[r] = fn(ThreadComm(world, r), r)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors[r] = e
            world.abort()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results
