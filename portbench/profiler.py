"""Reads a short steady sub-window of a run with ``torch.profiler``.

The profiler drops launches over a long window, so a traced run profiles
a few steps or batches inside its window.  From the trace: the kernels'
device time by name, the seconds in which some operation ran on the card
(``busy_s``), the sub-window's length (``window_s``), the idle gaps with
what the host was doing in each, and the port's kernel calls counted
where they launch (``kernels._build.launch_counts``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _launches() -> Dict[str, int]:
    from repro_torch.kernels import _build
    return _build.launch_counts()


@contextlib.contextmanager
def subwindow(out: Dict[str, Any]) -> Iterator[None]:
    """Profile the block's device activity (CUDA only: tracing the host's
    operations would slow the host by more than the work it measures).
    ``out["_prof"]`` keeps the profiler; :func:`read_profile` reads it once
    the window has closed."""
    before = _launches()
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    after = _launches()
    out["_prof"] = prof
    out["host_window_s"] = t1 - t0
    out["launches"] = {k: after.get(k, 0) - before.get(k, 0)
                       for k in after if after.get(k, 0) != before.get(k, 0)}


def read_profile(out: Dict[str, Any], work_dir: str) -> None:
    """Fill ``out`` from the profiler that :func:`subwindow` kept."""
    prof = out.pop("_prof", None)
    if prof is None:
        return
    path = os.path.join(work_dir, "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    out.update(read_events(events, out["host_window_s"]))


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def read_events(events: List[Dict[str, Any]], host_window_s: float
                ) -> Dict[str, Any]:
    """busy_s, window_s, kernels ({name: [count, seconds]}) and the ten
    longest idle gaps ([[the CUDA call the host was in, seconds], ...]).
    The sub-window runs from the end of its first device synchronisation
    to the end of its last, as the runtime calls in the trace show; a
    trace without them falls back on the host clock's length, from the
    first device operation."""
    runtime = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") == "cuda_runtime" and "dur" in e)
    syncs = [r for r in runtime if "Synchronize" in r[2]]
    dev_all = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                     for e in events
                     if e.get("cat") in DEVICE_CATS and "dur" in e)
    if len(syncs) >= 2:
        w0, w1 = syncs[0][1], syncs[-1][1]
    elif dev_all:
        w0 = dev_all[0][0]
        w1 = w0 + host_window_s * 1e6
    else:
        return {"busy_s": 0.0, "window_s": host_window_s, "kernels": {},
                "idle_gaps": []}
    dev, kernels = [], {}
    for a, b, e in dev_all:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        dev.append((a, b))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += (b - a) * 1e-6
    busy = _merge(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "kernels": kernels,
            "idle_gaps": [[_host_call(runtime, (a + b) / 2), (b - a) * 1e-6]
                          for a, b in longest]}


def _host_call(runtime: List[Tuple[float, float, str]], t: float) -> str:
    """The CUDA runtime call the host was in at ``t``, or what it last
    called ("python after <call>") when it was in none."""
    last = None
    for a, b, name in runtime:
        if a <= t <= b:
            return name
        if b < t:
            last = name
    return f"host after {last}" if last else "host"


def device_ops(kernels: Dict[str, List[float]], n: int = 10
               ) -> List[List[Any]]:
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:n]
    return [[name[:160], secs] for name, (_, secs) in top]


def kernel_seconds(prof: Dict[str, Any], names: Tuple[str, ...]) -> float:
    """Device seconds of the kernels whose names contain one of ``names``."""
    return sum(s for k, (_, s) in prof["kernels"].items()
               if any(n in k for n in names))

