"""TraceService: the always-on thread-pool front end.

Composes the watcher, the incremental view cache, and the query engine
into one object a monitoring dashboard (or the ``repro_torch.launch.traceserve``
CLI) talks to:

* ``jobs()`` -- manifest-scan of every trace directory under the root.
* ``query(job, family, params)`` -- synchronous answer from a snapshot at
  most ``max_staleness_s`` behind the job's directory; ``submit`` is the
  same through the worker pool (concurrent clients).
* ``league_table()`` / ``stragglers(job)`` -- cross-job comparisons;
  ``stragglers`` attaches per-rank reasons (lagging / partial coverage /
  DFG-divergent).
* ``phases(job, rank)`` / ``anomalies(job)`` -- structural observability
  straight from the grammar (``core/dfg.py``).
* an optional background *watch thread* that refreshes cache-resident
  jobs every ``watch_interval_s``, so interactive queries mostly hit a
  fresh snapshot and pay dictionary-lookup latency.

Staleness contract: a query's answer reflects every segment committed up
to at most ``max_staleness_s`` before the query started (default from the
service; per-call override).  Refreshes are per-segment incremental --
serving N + 1 epochs after serving N costs one segment fold, regardless
of N -- which is what keeps an always-on service O(delta) per tick
instead of O(history).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from .cache import IncrementalViewCache
from .engine import QueryEngine, QueryResult
from .watcher import JobInfo, JobWatcher


class TraceService:
    def __init__(self, root: str, *, mode: str = "auto", workers: int = 4,
                 max_staleness_s: float = 1.0,
                 max_resident_bytes: Optional[int] = None,
                 validate: bool = True,
                 watch_interval_s: Optional[float] = None) -> None:
        self.root = root
        self.max_staleness_s = max_staleness_s
        self.watcher = JobWatcher(root, validate=validate)
        self.cache = IncrementalViewCache(
            mode=mode, max_resident_bytes=max_resident_bytes)
        self.engine = QueryEngine(self.cache)
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="traceserve")
        self._stats_lock = threading.Lock()
        self._staleness_sum = 0.0
        self._staleness_max = 0.0
        self._n_results = 0
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        if watch_interval_s is not None:
            self.start_watching(watch_interval_s)

    # -- discovery ------------------------------------------------------------

    def jobs(self) -> Dict[str, JobInfo]:
        return self.watcher.scan()

    def resolve(self, job: str) -> str:
        """Job name (directory under the root) or explicit path -> path."""
        cand = os.path.join(self.root, job)
        if os.path.isdir(cand):
            return cand
        if os.path.isdir(job):
            return job
        raise KeyError(f"no job {job!r} under {self.root!r}")

    # -- queries --------------------------------------------------------------

    def query(self, job: str, family: str,
              params: Optional[Dict[str, Any]] = None,
              max_staleness_s: Optional[float] = None) -> QueryResult:
        bound = (self.max_staleness_s if max_staleness_s is None
                 else max_staleness_s)
        res = self.engine.query(self.resolve(job), family, params,
                                max_staleness_s=bound)
        with self._stats_lock:
            self._staleness_sum += res.staleness_s
            self._staleness_max = max(self._staleness_max, res.staleness_s)
            self._n_results += 1
        return res

    def submit(self, job: str, family: str,
               params: Optional[Dict[str, Any]] = None,
               max_staleness_s: Optional[float] = None) -> "Future[QueryResult]":
        """Async :meth:`query` through the worker pool."""
        return self._pool.submit(self.query, job, family, params,
                                 max_staleness_s)

    def league_table(self, jobs: Optional[Sequence[str]] = None,
                     metric: str = "aggregate_MBps") -> List[Dict[str, Any]]:
        """Bandwidth league table across jobs (default: every stream job
        under the root with at least one committed segment)."""
        if jobs is None:
            infos = self.jobs()
            paths = [i.path for i in infos.values()
                     if i.error is None and (i.n_segments or not i.is_stream)]
        else:
            paths = [self.resolve(j) for j in jobs]
        return self.engine.league_table(
            paths, metric=metric, max_staleness_s=self.max_staleness_s)

    def stragglers(self, job: str, threshold: float = 0.5,
                   divergence: float = 0.25) -> Dict[str, Any]:
        """Reasons-attached straggler report: per-rank ``lagging`` /
        ``partial_coverage`` / ``dfg_divergent`` flags plus the flat
        union (see :meth:`QueryEngine.stragglers`)."""
        return self.engine.stragglers(
            self.resolve(job), threshold=threshold, divergence=divergence,
            max_staleness_s=self.max_staleness_s)

    def phases(self, job: str, rank: int = 0) -> QueryResult:
        """Phase segmentation of one rank's stream (``phases`` family):
        labeled ``[start_record, end_record)`` ranges straight from the
        job's grammar, folded incrementally as epochs commit."""
        return self.query(job, "phases", {"rank": rank})

    def anomalies(self, job: str, threshold: float = 0.25) -> QueryResult:
        """Cross-rank DFG divergence (``anomalies`` family): per-rank
        distance from the SPMD-majority graph and the flagged ranks."""
        return self.query(job, "anomalies", {"threshold": threshold})

    # -- background watch ------------------------------------------------------

    def start_watching(self, interval_s: float) -> None:
        """Refresh every cache-resident job each ``interval_s`` so queries
        land on fresh snapshots.  Only jobs somebody queried (hence
        cached) are watched -- discovery of brand-new jobs stays on the
        query path, keeping the watch tick O(hot jobs)."""
        if self._watch_thread is not None:
            return
        self._watch_stop.clear()

        def loop() -> None:
            while not self._watch_stop.wait(interval_s):
                for path in self.cache.resident_paths():
                    if self._watch_stop.is_set():
                        return
                    try:
                        self.cache.get(path, max_staleness_s=None)
                    except Exception:  # noqa: BLE001 -- job may be deleted
                        self.cache.invalidate(path)

        self._watch_thread = threading.Thread(
            target=loop, name="traceserve-watch", daemon=True)
        self._watch_thread.start()

    def stop_watching(self) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5.0)
            self._watch_thread = None

    # -- lifecycle / stats -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            n = self._n_results
            mean = self._staleness_sum / n if n else 0.0
            smax = self._staleness_max
        return {
            "queries": dict(self.engine.stats),
            "cache": dict(self.cache.stats),
            "resident_jobs": len(self.cache.resident_paths()),
            "resident_bytes": self.cache.total_resident_bytes(),
            "staleness_mean_s": mean,
            "staleness_max_s": smax,
        }

    def close(self) -> None:
        self.stop_watching()
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "TraceService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
