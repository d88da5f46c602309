"""Runs one cell once: set-up, the measured window, the check, the result.

A job module (``jobs/<kind>.py``) gives a ``Job`` with ``setup()``,
``window()``, ``release()`` and ``check()``; this module times set-up,
reads the peak memory once the window has closed, frees the program's
state, runs the check, lets the per-layer readers (``metrics/*.py``) read
what the window left, and builds the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from . import cells
from .profiler import read_profile

BANNED = ("jax", "jaxlib", "flax", "repro")
CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of BANNED, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in BANNED})


class Run:
    """What a job needs from the harness: the cell, the seed and the
    window, the device, a scratch directory under TMPDIR, spans, and the
    port's configuration built from the configuration file."""

    def __init__(self, cell: Dict[str, Any], seed: int, seconds: float,
                 trace: bool, device: str, t_start: Optional[float] = None):
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.marks: Dict[str, float] = {}
        self.cell = cell
        self.model = cell["model"]
        self.mix = cell["mix"]
        self.seed = int(seed) % (1 << 63)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.work = tempfile.mkdtemp(prefix="portbench-")
        self.spans: Dict[str, List[float]] = {}
        self.profile: Dict[str, Any] = {}
        self.counters: Dict[str, Any] = {}

    # -- helpers for the jobs ------------------------------------------------

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def now(self) -> float:
        return time.perf_counter()

    def mark(self, name: str) -> None:
        """Seconds from the process's start to the end of a set-up phase."""
        self.sync()
        self.marks[name] = time.perf_counter() - self.t_start

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Host-clock span of a call into the program, device work
        included (it synchronises at the end)."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
            self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def port_config(self):
        """The port's configuration of ``model["arch"]`` with every field
        the configuration file gives set to the file's value."""
        from repro_torch.configs import get_config
        cfg = get_config(self.model["arch"])
        fields = {f.name for f in dataclasses.fields(cfg)}
        over = {k: v for k, v in self.model.items()
                if k in fields and k != "name"}
        cfg = cfg.replace(**over)
        for k, v in over.items():
            if getattr(cfg, k) != v:
                raise ValueError(f"{k}: the port holds {getattr(cfg, k)!r}, "
                                 f"the configuration file {v!r}")
        return cfg

    def encode_backend(self) -> str:
        return self.mix["encode_backend"] if self.cuda else "numpy"

    def recorder_config(self, trace_dir: str):
        from repro_torch.core import encode_backend
        from repro_torch.core.recorder import RecorderConfig
        backend = self.encode_backend()
        encode_backend.set_default_backend(backend)
        return RecorderConfig(trace_dir=trace_dir, encode_backend=backend)

    def warm_recorder(self) -> None:
        """A throwaway traced job with a flush and a finalize, so that the
        encode kernels are built and loaded before the window."""
        import os
        from repro_torch.core.apis import posix
        from repro_torch.core.recorder import session
        d = os.path.join(self.work, "warm")
        os.makedirs(d)
        path = os.path.join(d, "data.bin")
        with open(path, "wb") as f:
            f.write(bytes(1 << 16))
        with session(self.recorder_config(os.path.join(d, "trace"))) as rec:
            fd = posix.open(path, os.O_RDONLY, 0o644)
            for i in range(64):
                posix.pread(fd, 512, 512 * i)
                if i == 31:
                    rec.flush()
            posix.close(fd)
        shutil.rmtree(d)

    def close(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)


def device_info(cuda: bool) -> Dict[str, Any]:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def card_reading(query: str = "name,power.limit") -> Optional[str]:
    """``nvidia-smi``'s reading of the card, or None without one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _checks(readings: Dict[str, float], limits: Dict[str, Any]
            ) -> Dict[str, Dict[str, Any]]:
    return {k: {"value": v, "limit": limits.get(k)}
            for k, v in readings.items()}


def _correct(checks: Dict[str, Dict[str, Any]]) -> bool:
    compared = [c for c in checks.values() if c["limit"] is not None]
    return bool(compared) and all(
        c["value"] is not None and not math.isnan(c["value"])
        and c["value"] <= c["limit"] for c in compared)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: Optional[float] = None,
             model_override: Optional[Dict[str, Any]] = None,
             mix_override: Optional[Dict[str, Any]] = None,
             after_check: Optional[Callable[[Run, Any], Any]] = None
             ) -> Dict[str, Any]:
    """One run of cell ``name``; returns the result (``checks`` last).
    The overrides let the CPU tests run a cell at a small size;
    ``after_check(run, job)``, given, runs after the check and its value
    is the result's ``after_check`` (``control.py``'s readings)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cells.load_cell(name)
    cell["model"] = {**cell["model"], **(model_override or {})}
    cell["mix"] = {**cell["mix"], **(mix_override or {})}
    job_kind = cells.load_job(cell["mix"]["job"])
    run = Run(cell, seed, seconds, trace, device, t_start)
    try:
        job = job_kind.Job(run)
        job.setup()
        run.sync()
        setup_s = time.perf_counter() - t_start
        clocks = CLOCKS and run.cuda and card_reading(CLOCKS)
        e2e = job.window()
        clocks = [clocks, CLOCKS and run.cuda and card_reading(CLOCKS)]
        run.mark("window")
        dev = device_info(run.cuda)
        read_profile(run.profile, run.work)
        job.release()
        gc.collect()
        if run.cuda:
            torch.cuda.empty_cache()
        readings = job.check()
        run.mark("check")
        extra = after_check(run, job) if after_check else None
    finally:
        run.close()
    checks = _checks(readings, cell["limits"])
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        ctx = {"cell": cell, "run": run, "e2e": e2e, "job": job,
               "profile": run.profile, "spans": run.spans,
               "counters": run.counters}
        for mname in cells.metric_names():
            mod = cells.load_metric(mname)
            if mod.MOVES not in e2e:
                continue
            value = mod.read(ctx)
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
        dev["busy_s"] = run.profile.get("busy_s")
        dev["window_s"] = run.profile.get("window_s")
    else:
        units = job.UNITS
        metrics = {k: {"value": v, "unit": units[k]} for k, v in e2e.items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result: Dict[str, Any] = {
        "correct": _correct(checks) and job.failed == 0,
        "attempted": job.attempted, "failed": job.failed,
        "metrics": metrics, "device": dev}
    if trace and run.profile:
        from .profiler import device_ops
        result["breakdown"] = {
            "device_ops": device_ops(run.profile["kernels"]),
            "idle_gaps": run.profile["idle_gaps"]}
    if run.cuda:
        result["card"] = card_reading()
    result["work"] = dict(job.work_summary(), setup_marks=run.marks,
                          clocks=clocks,
                          diagnostics=getattr(job, "diagnostics", None))
    if after_check:
        result["after_check"] = extra
    result["checks"] = checks
    return result

