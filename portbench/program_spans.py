"""The program's own spans and counters (``repro_torch.spans``), read
against the device trace of a traced run.

Anchors put the program's clock (``time.perf_counter_ns``) on the
trace's: the host clock read right after each ``torch.cuda.synchronize()``
of the profiled sub-window, two at its start and one at its end.  The
first call under the profiler returns 2-3 ms after the trace records its
end (H100, PyTorch 2.11), so the second anchor pairs with the end of the
trace's second ``cudaDeviceSynchronize``.  The profiler's own exit
synchronises once more after the last anchor, so the last anchor pairs
with the ``cudaDeviceSynchronize`` that ended nearest to where the second
pair's offset puts it.  The two pairs give the offset between the clocks
twice; where they differ by more than ``MAX_DRIFT_US`` nothing is put
down to spans.

Each idle instant of the sub-window (no operation on the card, by
``profiler.read_events``' rule) is put down to the innermost span open on
the window's thread at that instant, by intersecting intervals, or to
``(no span)``.

``METRICS`` reads per-layer metrics from the ``ctx`` that the harness
hands to ``metrics/*.py``, with three things added: ``program_spans``
and ``program_counters`` (what ``repro_torch.spans.collect()`` returned
over the window) and ``profile["idle_by_span"]`` (:func:`idle_by_span`).
Each reader returns None where it finds nothing to read.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .profiler import DEVICE_CATS, _merge

MAX_DRIFT_US = 200.0
NO_SPAN = "(no span)"
ANCHOR_CALL = "cudaDeviceSynchronize"


def clock_offset(events: List[Dict[str, Any]], anchors_ns: Sequence[int]
                 ) -> Optional[Tuple[float, float]]:
    """``(offset_us, drift_us)``: a program time ``t_ns`` lies at
    ``t_ns / 1e3 + offset_us`` on the trace's clock; ``drift_us`` is how
    far the last anchor's offset lies from the second's.  None without
    three anchors and three ``cudaDeviceSynchronize`` calls in the
    trace."""
    ends = sorted(float(e["ts"]) + float(e["dur"]) for e in events
                  if e.get("cat") == "cuda_runtime" and "dur" in e
                  and e.get("name") == ANCHOR_CALL)
    if len(anchors_ns) < 3 or len(ends) < 3:
        return None
    first = ends[1] - anchors_ns[1] / 1e3
    at = anchors_ns[-1] / 1e3 + first
    last = min(ends[2:], key=lambda e: abs(e - at)) - anchors_ns[-1] / 1e3
    return (first + last) / 2, last - first


def idle_gaps(events: List[Dict[str, Any]]
              ) -> Optional[Tuple[float, float, List[Tuple[float, float]]]]:
    """``(w0, w1, gaps)`` in the trace's microseconds: the sub-window, from
    the end of its first synchronisation to the end of its last, and the
    intervals in it with no operation on the card, as
    ``profiler.read_events`` counts them.  None without two
    synchronisations."""
    syncs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat") == "cuda_runtime" and "dur" in e
                   and "Synchronize" in e.get("name", ""))
    if len(syncs) < 2:
        return None
    w0, w1 = syncs[0][1], syncs[-1][1]
    dev = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev.append((a, b))
    gaps, t = [], w0
    for a, b in _merge(dev):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    return w0, w1, gaps


def innermost(spans: Sequence[Any], tid: int
              ) -> List[Tuple[int, int, str]]:
    """``[(start_ns, end_ns, name)]`` in time order: at each instant the
    innermost span open on thread ``tid``.  Spans of one thread nest, so
    the latest started of those open is the innermost; time in no span is
    left out."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Any] = []
    t = None

    def close_until(to: Optional[int]) -> None:
        nonlocal t
        while stack and (to is None or stack[-1].end_ns <= to):
            top = stack.pop()
            if top.end_ns > t:
                out.append((t, top.end_ns, top.name))
                t = top.end_ns
        if stack and to is not None and to > t:
            out.append((t, to, stack[-1].name))
            t = to

    for s in sorted((s for s in spans if s.tid == tid),
                    key=lambda s: (s.start_ns, -s.end_ns)):
        if t is None:
            t = s.start_ns
        close_until(s.start_ns)
        t = max(t, s.start_ns)
        stack.append(s)
    if stack:
        close_until(None)
    return out


def attribute(gaps_us: Sequence[Tuple[float, float]],
              segments_ns: Sequence[Tuple[int, int, str]],
              offset_us: float) -> Dict[str, float]:
    """Seconds of the gaps under each segment's name, the rest under
    ``NO_SPAN``; both lists in time order."""
    segs = [(a / 1e3 + offset_us, b / 1e3 + offset_us, name)
            for a, b, name in segments_ns]
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for g0, g1 in gaps_us:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        covered = 0.0
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b = max(segs[k][0], g0), min(segs[k][1], g1)
            if b > a:
                out[segs[k][2]] += (b - a) * 1e-6
                covered += b - a
            k += 1
        out[NO_SPAN] += (g1 - g0 - covered) * 1e-6
    return dict(out)


def idle_by_span(events: List[Dict[str, Any]], anchors_ns: Sequence[int],
                 spans: Sequence[Any], tid: int) -> Optional[Dict[str, Any]]:
    """``{"window_s", "idle_s", "drift_us", "by_span": {name: seconds}}``
    of the profiled sub-window, or None where the anchors are missing or
    drift apart by more than ``MAX_DRIFT_US``."""
    clock, window = clock_offset(events, anchors_ns), idle_gaps(events)
    if clock is None or window is None or abs(clock[1]) > MAX_DRIFT_US:
        return None
    w0, w1, gaps = window
    by = attribute(gaps, innermost(spans, tid), clock[0])
    return {"window_s": (w1 - w0) * 1e-6,
            "idle_s": sum(b - a for a, b in gaps) * 1e-6,
            "drift_us": clock[1], "by_span": by}


def top_idle(idle: Dict[str, Any], n: int = 10) -> List[List[Any]]:
    """The ``n`` spans under which most idle time fell, then
    ``NO_SPAN``: ``[[name, seconds], ...]`` (the breakdown's
    ``idle_by_span``)."""
    by = idle["by_span"]
    top = sorted((k for k in by if k != NO_SPAN), key=lambda k: -by[k])[:n]
    return [[k, by[k]] for k in top] + [[NO_SPAN, by.get(NO_SPAN, 0.0)]]


def span_table(spans: Sequence[Any], n: int = 10) -> List[List[Any]]:
    """The ``n`` span names of most self time (a span's time less its
    children's): ``[[name, count, total ms, self ms], ...]`` (the
    breakdown's ``spans``)."""
    child_ns: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s.parent:
            child_ns[s.parent] += s.end_ns - s.start_ns
    rows: Dict[str, List[Any]] = {}
    for s in spans:
        row = rows.setdefault(s.name, [s.name, 0, 0.0, 0.0])
        dur = s.end_ns - s.start_ns
        row[1] += 1
        row[2] += dur * 1e-6
        row[3] += (dur - child_ns.get(s.id, 0)) * 1e-6
    return sorted(rows.values(), key=lambda r: -r[3])[:n]


# -- readers of the per-layer metrics ----------------------------------------

TRAIN_PHASES = ("train.forward", "train.backward", "train.optimizer")


def idle_share(ctx: Dict[str, Any], names: Sequence[str],
               invert: bool = False) -> Optional[float]:
    """Share of the sub-window (%) idle while the window's thread was
    innermost in one of ``names`` (with ``invert``, in none of them)."""
    idle = (ctx.get("profile") or {}).get("idle_by_span")
    if not idle or not idle["window_s"]:
        return None
    by = idle["by_span"]
    secs = sum(v for k, v in by.items() if (k in names) != invert)
    return 100.0 * secs / idle["window_s"]


def record_us(ctx: Dict[str, Any]) -> Optional[float]:
    c = ctx.get("program_counters") or {}
    calls = c.get("recorder.record_calls")
    return c["recorder.record_ns"] / calls / 1e3 if calls else None


def span_ms(ctx: Dict[str, Any], names: Sequence[str]) -> Optional[float]:
    """Milliseconds of the window's spans named in ``names``, summed."""
    ns = [s.end_ns - s.start_ns for s in ctx.get("program_spans") or ()
          if s.name in names]
    return sum(ns) * 1e-6 if ns else None


Reader = Callable[[Dict[str, Any]], Optional[float]]

# name -> (unit, layer, the end-to-end metric it moves, source, reader)
METRICS: Dict[str, Tuple[str, str, str, str, Reader]] = {
    "idle_forward.train": (
        "%", "train step", "train_tokens_per_s", "device_trace",
        lambda ctx: idle_share(ctx, ("train.forward",))),
    "idle_backward.train": (
        "%", "train step", "train_tokens_per_s", "device_trace",
        lambda ctx: idle_share(ctx, ("train.backward",))),
    "idle_optimizer.train": (
        "%", "train step", "train_tokens_per_s", "device_trace",
        lambda ctx: idle_share(ctx, ("train.optimizer",))),
    "idle_other.train": (
        "%", "train step", "train_tokens_per_s", "device_trace",
        lambda ctx: idle_share(ctx, TRAIN_PHASES, invert=True)),
    "record_us.serve": (
        "us", "record path", "serve_tokens_per_s", "host_clock", record_us),
    "flush_compress_ms.serve": (
        "ms", "streaming flush", "ttft_p95_ms", "host_clock",
        lambda ctx: span_ms(ctx, ("flush.reduce", "flush.encode_ts",
                                  "flush.materialize"))),
    "flush_write_ms.serve": (
        "ms", "streaming flush", "ttft_p95_ms", "host_clock",
        lambda ctx: span_ms(ctx, ("flush.write",))),
    "finalize_merge_ms.serve": (
        "ms", "finalize", "serve_tokens_per_s", "host_clock",
        lambda ctx: span_ms(ctx, ("finalize.merged",))),
}
