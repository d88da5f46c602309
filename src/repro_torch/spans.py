"""Spans and counters inside the port: where the host's time goes.

Off by default.  Off, :func:`span` returns one shared no-op context and
:func:`count` returns at once, so an instrumented call site costs one test
of the module's ``enabled`` flag: no clock is read and no span is made.
:func:`enable` is the only switch (no environment variable, no
configuration field).

On, a span records ``(name, id, parent id, thread id, start ns, end ns,
attrs)`` on ``time.perf_counter_ns()``.  Its parent is the innermost span
open on its own thread when it starts (0 for none); a step or batch index
goes in ``attrs``, so that the spans of one step share it.  Closed spans
wait in a ring of :data:`RING` entries, the oldest dropped and counted,
until :func:`collect` hands them and the counters to its caller and
clears them.  Nothing else writes them out.

The spans and counters of the port (``layer.phase``):

  ``recorder.record_calls``, ``recorder.record_ns`` (counters)
      ``Recorder.record``'s calls and the nanoseconds inside them, the
      wait for the recorder's lock included, an auto-flush left out.
  ``recorder.flush`` (``epoch``)
      children ``flush.snapshot``, ``flush.reduce``, ``flush.encode_ts``,
      ``flush.materialize``, ``flush.write``, ``flush.fold``,
      ``flush.barrier``; under ``async_flush`` the background thread's
      ``flush.commit`` holds the commit's children on its own thread.
  ``recorder.finalize``
      streaming: ``finalize.drain``, ``finalize.tail_flush`` (the flush's
      children nest under it), ``finalize.merged``, ``finalize.barrier``;
      one-shot: ``finalize.local_state``, ``finalize.reduce``,
      ``finalize.merge``, ``finalize.write``, ``finalize.barrier``.
  ``train.step`` (``step``)
      ``train.data``, ``train.cast``, ``train.forward``,
      ``train.backward``, ``train.optimizer``, ``train.readback`` (the host
      waits there for the device).
  ``serve.generate`` (``batch``)
      ``serve.prefill``, ``serve.seat``, ``serve.first_token`` (the host
      waits there for the device), ``serve.decode``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple

RING = 65536

enabled = False

_lock = threading.Lock()
_ring: deque = deque(maxlen=RING)
_counters: Dict[str, int] = {}
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()


class Record(NamedTuple):
    name: str
    id: int
    parent: int
    tid: int
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]


class _Noop:
    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP = _Noop()


class Span:
    """An open span.  ``keep`` False only reads the clock: the caller keeps
    the time itself (:func:`timed`)."""

    __slots__ = ("name", "attrs", "keep", "id", "parent", "start_ns",
                 "end_ns")

    def __init__(self, name: str, attrs: Dict[str, Any], keep: bool):
        self.name = name
        self.attrs = attrs
        self.keep = keep

    def __enter__(self) -> "Span":
        if self.keep:
            stack = _stack()
            self.parent = stack[-1] if stack else 0
            self.id = next(_ids)
            stack.append(self.id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.keep:
            _stack().pop()
            _keep(Record(self.name, self.id, self.parent,
                         threading.get_ident(), self.start_ns, self.end_ns,
                         self.attrs))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _stack() -> List[int]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _keep(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_ring) == RING:
            _dropped += 1
        _ring.append(rec)


def span(name: str, **attrs):
    """A span around the block while spans are on; else the shared no-op."""
    if not enabled:
        return NOOP
    return Span(name, attrs, True)


def timed(name: str, **attrs) -> Span:
    """A span whose caller also keeps its time (``.start_ns``,
    ``.end_ns``, ``.seconds``): the clock is read whether spans are on or
    off, and the span is recorded only while they are on, so that a
    boundary is read once for both."""
    return Span(name, attrs, enabled)


def count(name: str, n: int = 1) -> None:
    if not enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False


def collect() -> Dict[str, Any]:
    """``{"spans": [Record, ...], "counters": {name: n}, "dropped": n}``
    since the last collect, oldest span first; clears them."""
    global _dropped
    with _lock:
        out = {"spans": list(_ring), "counters": dict(_counters),
               "dropped": _dropped}
        _ring.clear()
        _counters.clear()
        _dropped = 0
    return out
