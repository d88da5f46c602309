"""Always-on trace query service (ROADMAP direction 1).

Watches many trace directories -- hundreds of concurrently-running jobs,
each committing ``epoch_NNNNN/`` segments through ``Recorder.flush`` --
and serves live compressed-domain queries over them:

:class:`~repro_torch.traceserve.watcher.JobWatcher`
    manifest-scan discovery of jobs and their new / degraded /
    quarantined segments (reusing ``trace_format.validate_segment`` and
    the reader's ``coverage()`` semantics; committed segments are
    immutable, so each is validated once).

:class:`~repro_torch.traceserve.cache.IncrementalViewCache`
    keeps hot :class:`~repro_torch.core.traceview.TraceView`\\ s cached and
    folds newly committed segments in via ``TraceReader.refresh()`` --
    per-segment invalidation, one fold per new epoch, never a rescan of
    already-loaded segments -- with generation-stamped snapshot reads (a
    query can never observe a half-folded view) and LRU eviction bounded
    by resident compressed size.

:class:`~repro_torch.traceserve.engine.QueryEngine`
    the five ``analysis.py`` query families plus ``digram_counts``,
    windowed ``bandwidth_bounds``/``overlap_ratio``, ``n_records``,
    ``coverage``, and the compressed-domain observability families
    ``dfg`` / ``phases`` / ``anomalies`` (Directly-Follows Graph, phase
    segmentation, cross-rank divergence -- all O(|grammar|), from
    ``core/dfg.py``), each answered from the cached view and memoized
    per (job, query, generation); cross-job comparisons (bandwidth
    league table, reasons-attached straggler detection) compose
    single-job answers.

:class:`~repro_torch.traceserve.service.TraceService`
    the thread-pool front end tying the three together: per-job staleness
    bounds (a query may be answered from a view at most ``staleness_s``
    behind the directory), a background watch thread, and service-level
    stats.  ``repro_torch.launch.traceserve`` is the CLI.
"""

from .cache import IncrementalViewCache, ViewSnapshot
from .engine import QUERY_FAMILIES, QueryEngine, QueryResult, run_query
from .service import TraceService
from .watcher import JobInfo, JobWatcher

__all__ = [
    "IncrementalViewCache", "ViewSnapshot", "QUERY_FAMILIES", "QueryEngine",
    "QueryResult", "run_query", "TraceService", "JobInfo", "JobWatcher",
]
