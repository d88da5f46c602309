"""Compressed-domain query dispatch + cross-job comparisons.

One function, :func:`run_query`, maps a ``(family, params)`` request onto
the :class:`TraceView` snapshot the cache handed out -- the five
``analysis.py`` query families (``io_summary``, ``size_histogram``,
``call_chains``, ``overlap_ratio``, ``consistency_pairs``) plus
``digram_counts``, windowed ``bandwidth_bounds``, ``n_records``, the
structural ``coverage`` report, and the compressed-domain DFG
observability families (``dfg``, ``phases``, ``anomalies`` -- all
O(|grammar|), see ``core/dfg.py``).  All results are JSON-serializable.

:class:`QueryEngine` adds a per-``(job, family, params)`` memo keyed by
the snapshot's *generation*: while no new epoch has been folded, a
repeated query is a dictionary hit; the moment the cache publishes
generation N+1 the memo entry misses and the query recomputes against
the refreshed view.  Cross-job comparisons -- the bandwidth league table
and per-rank straggler detection -- compose single-job answers, so they
ride the same memo.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .cache import IncrementalViewCache, ViewSnapshot

QUERY_FAMILIES = (
    "io_summary", "size_histogram", "call_chains", "overlap_ratio",
    "consistency_pairs", "digram_counts", "bandwidth_bounds", "n_records",
    "coverage", "dfg", "phases", "anomalies",
)


def run_query(snap: ViewSnapshot, family: str,
              params: Optional[Dict[str, Any]] = None) -> Any:
    """Answer one query family against one snapshot (no caching here).

    ``params`` per family: ``size_histogram`` takes ``edges``;
    ``call_chains``/``overlap_ratio``/``digram_counts`` take ``rank``;
    ``overlap_ratio`` and ``bandwidth_bounds`` take ``t0``/``t1``;
    ``digram_counts`` takes ``top`` (default 20); ``n_records`` takes an
    optional ``rank`` (omitted: per-rank list plus total).
    """
    p = params or {}
    view = snap.view
    if family == "io_summary":
        return view.io_summary()
    if family == "size_histogram":
        if "edges" in p:
            return view.size_histogram(edges=tuple(p["edges"]))
        return view.size_histogram()
    if family == "call_chains":
        return view.call_chains(rank=int(p.get("rank", 0)))
    if family == "overlap_ratio":
        return view.overlap_ratio(
            rank=int(p.get("rank", 0)),
            t0=None if p.get("t0") is None else int(p["t0"]),
            t1=None if p.get("t1") is None else int(p["t1"]))
    if family == "consistency_pairs":
        return view.consistency_pairs()
    if family == "digram_counts":
        counts = view.digram_counts(rank=int(p.get("rank", 0)))
        top = int(p.get("top", 20))
        ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return {"n_digrams": len(counts),
                "top": [[int(a), int(b), int(c)]
                        for (a, b), c in ranked[:top]]}
    if family == "bandwidth_bounds":
        if "t0" not in p or "t1" not in p:
            raise ValueError("bandwidth_bounds needs params t0 and t1")
        return view.bandwidth_bounds(int(p["t0"]), int(p["t1"]))
    if family == "n_records":
        if "rank" in p and p["rank"] is not None:
            return {"rank": int(p["rank"]),
                    "n_records": view.n_records(int(p["rank"]))}
        per_rank = [view.n_records(r) for r in range(view.nranks)]
        return {"per_rank": per_rank, "total": sum(per_rank)}
    if family == "coverage":
        return dict(snap.coverage)
    if family == "dfg":
        rank = p.get("rank")
        g = view.dfg(rank=None if rank is None else int(rank))
        top = int(p.get("top", 30))
        return {"n_nodes": len(g["nodes"]), "n_edges": len(g["edges"]),
                "n_records": g["n_records"], "nodes": g["nodes"],
                "edges": g["edges"][:top]}
    if family == "phases":
        rank = int(p.get("rank", 0))
        return {"rank": rank, "phases": view.phases(rank=rank)}
    if family == "anomalies":
        return view.rank_divergence(
            threshold=float(p.get("threshold", 0.25)))
    raise ValueError(
        f"unknown query family {family!r}; known: {QUERY_FAMILIES}")


@dataclass
class QueryResult:
    """One answered query, stamped with the snapshot it was served from."""

    path: str
    family: str
    params: Dict[str, Any]
    value: Any
    generation: int
    coverage: Dict[str, Any]
    staleness_s: float      # snapshot age when the query was answered
    latency_s: float
    cached: bool            # True: answered from the per-generation memo

    def to_dict(self) -> Dict[str, Any]:
        return {
            "path": self.path, "family": self.family, "params": self.params,
            "value": self.value, "generation": self.generation,
            "coverage": self.coverage, "staleness_s": self.staleness_s,
            "latency_s": self.latency_s, "cached": self.cached,
        }


def _freeze(params: Optional[Dict[str, Any]]) -> tuple:
    if not params:
        return ()
    return tuple(sorted(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in params.items()))


class QueryEngine:
    """Memoizing query front end over an :class:`IncrementalViewCache`."""

    def __init__(self, cache: IncrementalViewCache,
                 memo_size: int = 1024) -> None:
        self.cache = cache
        self.memo_size = memo_size
        self._memo: Dict[tuple, Tuple[int, Any]] = {}
        self._memo_lock = threading.Lock()
        self.stats: Dict[str, int] = {"queries": 0, "memo_hits": 0}

    def query(self, path: str, family: str,
              params: Optional[Dict[str, Any]] = None,
              max_staleness_s: Optional[float] = None) -> QueryResult:
        t_start = time.perf_counter()
        snap = self.cache.get(path, max_staleness_s=max_staleness_s)
        key = (path, family, _freeze(params))
        cached = False
        with self._memo_lock:
            hit = self._memo.get(key)
        if hit is not None and hit[0] == snap.generation:
            value, cached = hit[1], True
        else:
            value = run_query(snap, family, params)
            with self._memo_lock:
                if len(self._memo) >= self.memo_size:
                    self._memo.clear()  # bounded; regenerates on demand
                self._memo[key] = (snap.generation, value)
        with self._memo_lock:
            self.stats["queries"] += 1
            self.stats["memo_hits"] += int(cached)
        return QueryResult(
            path=path, family=family, params=dict(params or {}), value=value,
            generation=snap.generation, coverage=dict(snap.coverage),
            staleness_s=snap.age(self.cache.clock()),
            latency_s=time.perf_counter() - t_start, cached=cached)

    # -- cross-job comparisons ------------------------------------------------

    def league_table(self, paths: Sequence[str],
                     metric: str = "aggregate_MBps",
                     max_staleness_s: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
        """Jobs ranked by an ``io_summary`` metric (default: aggregate
        bandwidth), highest first.  Unreadable jobs sort last with their
        error recorded instead of a value."""
        rows: List[Dict[str, Any]] = []
        for path in paths:
            try:
                res = self.query(path, "io_summary",
                                 max_staleness_s=max_staleness_s)
            except Exception as e:  # noqa: BLE001 -- per-job isolation
                rows.append({"path": path, "error": f"{type(e).__name__}: {e}",
                             metric: None})
                continue
            rows.append({
                "path": path,
                metric: res.value.get(metric),
                "total_bytes": res.value.get("total_bytes"),
                "n_data_calls": res.value.get("n_data_calls"),
                "generation": res.generation,
                "complete": res.coverage.get("complete", True),
            })
        rows.sort(key=lambda r: (r[metric] is None, -(r[metric] or 0)))
        for i, row in enumerate(rows):
            row["rank"] = i
        return rows

    def stragglers(self, path: str, threshold: float = 0.5,
                   divergence: float = 0.25,
                   max_staleness_s: Optional[float] = None
                   ) -> Dict[str, Any]:
        """Per-rank straggler report with REASONS attached.

        A rank is flagged ``lagging`` when its record count falls below
        ``threshold`` x the median, ``partial_coverage`` when a degraded
        epoch is missing its stream (``coverage.ranks_partial``), and
        ``dfg_divergent`` when its grammar's label-projected DFG sits
        more than ``divergence`` away from the SPMD majority (the
        ``anomalies`` family).  ``reasons`` maps each flagged rank to
        its reason list; ``stragglers`` stays the flat union for
        compatibility.  Both sub-queries ride the per-generation memo.
        """
        res = self.query(path, "n_records", max_staleness_s=max_staleness_s)
        anom = self.query(path, "anomalies", {"threshold": divergence},
                          max_staleness_s=max_staleness_s)
        per_rank: List[int] = res.value["per_rank"]
        srt = sorted(per_rank)
        median = (srt[len(srt) // 2] if len(srt) % 2
                  else (srt[len(srt) // 2 - 1] + srt[len(srt) // 2]) / 2
                  ) if srt else 0
        lagging = [r for r, n in enumerate(per_rank)
                   if n < threshold * median]
        partial = list(res.coverage.get("ranks_partial", []))
        divergent = list(anom.value["divergent"])
        reasons: Dict[int, List[str]] = {}
        for rs, tag in ((lagging, "lagging"),
                        (partial, "partial_coverage"),
                        (divergent, "dfg_divergent")):
            for r in rs:
                reasons.setdefault(int(r), []).append(tag)
        return {
            "path": path,
            "median_records": median,
            "threshold": threshold,
            "divergence_threshold": divergence,
            "per_rank": per_rank,
            "lagging": lagging,
            "ranks_partial": partial,
            "dfg_divergent": divergent,
            "divergence_per_rank": anom.value["per_rank"],
            "reasons": {r: reasons[r] for r in sorted(reasons)},
            "stragglers": sorted(reasons),
            "generation": res.generation,
        }
