"""The cross-process byte transport of the port's multi-process ``Comm``.

Counterpart of the transport half of the JAX package's
``distributed/sharding.py`` (``PpermuteByteTransport``, ``global_any``);
its parameter-sharding rules are not ported yet.  Where the reference
moves payloads between jax host processes with a collective permutation,
:class:`StoreByteTransport` keeps them on the key-value ``Store`` of a
``torch.distributed`` group (a ``FileStore`` behind
``init_process_group(init_method="file://...")``, the ``TCPStore`` that
``torchrun`` sets up):

- a per-pair FIFO mailbox: message ``n`` from rank ``s`` to rank ``d`` on
  channel ``ch`` is the key ``<prefix>/<ch>/<s>-><d>/<n>``; the receiver
  waits for it by polling ``check``, then reads and deletes it.  A receive
  that times out has taken nothing, so a message that arrives later is the
  next receive's, as in a queue -- a posted gloo ``recv`` cannot be
  withdrawn;
- rounds (``barrier``, ``bcast``, ``any``) on counters and one value a
  round, numbered per transport, whose last rank out deletes their keys;
- ``sub(key)``: the same ranks under ``<prefix>/<key>``, with mailboxes and
  rounds of its own (the ``dup`` of a comm);
- a world-wide ``failed`` key: a rank that fails sets it (``mark_failed``),
  as does the launcher when a process dies, and every wait polls it, so
  waits on a dead peer end in an error instead of sitting out their
  timeout.

Payloads are host bytes (the Recorder ships serialized rank states); the
card never sees them.  :func:`dumps` pickles a payload and refuses a CUDA
tensor inside it.
"""

from __future__ import annotations

import io
import pickle
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

#: first and longest sleep between two polls of a waited-for key (seconds)
POLL_S = (0.0005, 0.02)
#: the key prefix of a world's mailboxes and rounds
PREFIX = "repro"


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise TypeError(
                f"a {obj.device} tensor cannot travel between processes; "
                f"move it to the CPU first")
        return NotImplemented


def dumps(obj: Any) -> bytes:
    """Pickle ``obj`` for the wire; a CUDA tensor inside it raises
    TypeError."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


class StoreByteTransport:
    """Mailboxes and rounds between the ``size`` ranks sharing ``store``.

    Every rank must use the same ``prefix`` and run rounds in the same
    order.  Store calls are serialized by one lock per world, so a
    background thread on a ``sub`` transport and the foreground never use
    the store at once.
    """

    def __init__(self, store: Any, rank: int, size: int,
                 prefix: str = PREFIX, *, _world: Optional[Tuple] = None):
        self.store = store
        self.rank = rank
        self.size = size
        self.prefix = prefix
        # (failed key, store lock) shared with every sub-transport
        self._world = _world or (f"{prefix}/failed", threading.Lock())
        self._lock = threading.Lock()       # this transport's counters
        self._sent: Dict[Tuple[str, int], int] = {}
        self._taken: Dict[Tuple[str, int], int] = {}
        self._rounds: Dict[str, int] = {}

    def sub(self, key: str) -> "StoreByteTransport":
        """The same ranks on keys of their own under ``<prefix>/<key>``."""
        return StoreByteTransport(self.store, self.rank, self.size,
                                  f"{self.prefix}/{key}", _world=self._world)

    # -- the store, one call at a time --------------------------------------

    def _call(self, method: str, *args) -> Any:
        with self._world[1]:
            return getattr(self.store, method)(*args)

    def mark_failed(self, why: str) -> None:
        """Tell every rank's waits that a peer is gone."""
        self._call("set", self._world[0], why.encode())

    def failed(self) -> bool:
        return self._call("check", [self._world[0]])

    def wait(self, key: str, timeout: Optional[float], what: str) -> None:
        """Block until ``key`` exists.  Raises TimeoutError after
        ``timeout`` seconds (None: no limit) and RuntimeError once a peer
        has failed; polls back off from ``POLL_S[0]`` to ``POLL_S[1]``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        poll = POLL_S[0]
        while not self._call("check", [key]):
            if self.failed():
                raise RuntimeError(f"rank {self.rank}: peer failed while "
                                   f"{what}")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"rank {self.rank}: timed out {what} "
                                   f"after {timeout:g}s")
            time.sleep(poll)
            poll = min(2 * poll, POLL_S[1])

    # -- mailboxes ----------------------------------------------------------

    def _box(self, channel: str, src: int, dst: int, n: int) -> str:
        return f"{self.prefix}/{channel}/{src}->{dst}/{n}"

    def put(self, channel: str, dst: int, blob: bytes) -> None:
        """Deliver ``blob`` to ``dst``'s mailbox from this rank; messages
        are numbered in the order they are delivered."""
        with self._lock:
            n = self._sent.get((channel, dst), 0)
            self._sent[(channel, dst)] = n + 1
            self._call("set", self._box(channel, self.rank, dst, n), blob)

    def take(self, channel: str, src: int, timeout: Optional[float]) -> bytes:
        """The next message from ``src`` on ``channel`` (see :meth:`wait`
        for the errors); on expiry nothing is consumed."""
        n = self._taken.get((channel, src), 0)
        key = self._box(channel, src, self.rank, n)
        self.wait(key, timeout, f"receiving from rank {src}")
        blob = self._call("get", key)
        self._call("delete_key", key)
        self._taken[(channel, src)] = n + 1
        return blob

    # -- rounds ---------------------------------------------------------------

    def _round(self, name: str) -> str:
        with self._lock:
            g = self._rounds.get(name, 0)
            self._rounds[name] = g + 1
        return f"{self.prefix}/{name}/{g}"

    def _arrive(self, key: str, what: str) -> None:
        """Count this rank in; the last one in opens the round."""
        if self._call("add", f"{key}/in", 1) == self.size:
            self._call("set", f"{key}/go", b"1")
        self.wait(f"{key}/go", None, what)

    def _leave(self, key: str, names: Tuple[str, ...]) -> None:
        """Count this rank out; the last one out deletes the round's keys."""
        if self._call("add", f"{key}/out", 1) == self.size:
            for name in names + ("out",):
                self._call("delete_key", f"{key}/{name}")

    def barrier(self) -> None:
        key = self._round("barrier")
        self._arrive(key, "at a barrier")
        self._leave(key, ("in", "go"))

    def bcast(self, blob: Optional[bytes], root: int) -> bytes:
        """``root``'s ``blob`` to every rank, stored once."""
        key = self._round("bcast")
        if self.rank == root:
            self._call("set", f"{key}/v", blob)
        else:
            self.wait(f"{key}/v", None, f"waiting for rank {root}'s "
                                        f"broadcast")
            blob = self._call("get", f"{key}/v")
        self._leave(key, ("v",))
        return blob

    def any(self, flag: bool) -> bool:
        """Boolean OR of every rank's ``flag``, on every rank."""
        key = self._round("any")
        if flag:
            self._call("add", f"{key}/yes", 1)
        self._arrive(key, "at a vote")
        verdict = self._call("add", f"{key}/yes", 0) > 0
        self._leave(key, ("yes", "in", "go"))
        return verdict


def global_any(flag: bool, transport: StoreByteTransport) -> bool:
    """Cross-process boolean OR (the flush-cadence vote); identity with one
    process."""
    if transport.size == 1:
        return bool(flag)
    return transport.any(bool(flag))
