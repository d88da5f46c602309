"""Compressed-domain trace queries (paper Section 4 without expansion).

``TraceView`` is the read-side counterpart of the tree finalize: it
answers the Section-4 analyses from the compressed representation directly
instead of expanding every record through a per-record Python iterator.
Three pillars:

grammar-weighted aggregation
    Per-terminal occurrence counts come from Sequitur rule expansion
    weights (``sequitur.rule_weights`` / ``terminal_counts``) in
    O(|grammar|), so record counts, call mixes, size histograms and byte
    totals are sums over <= |CST| distinct signatures x weights -- never
    over expanded records.

columnar materialization
    The merged CST is batch-decoded ONCE into NumPy header columns plus
    role-indexed size / handle / offset-encoding columns
    (``encoding.decode_signatures_batch``).  Per-rank timestamp arrays are
    decompressed lazily and memoized, only when a query touches them.

rank-symbolic resolution
    ``RankPattern`` / ``IterPattern`` offsets stay symbolic in the columns.
    Queries that need concrete per-record extents (consistency analysis)
    walk the terminal stream ONCE per unique CFG -- every rank sharing a
    CFG has the same stream -- keeping each offset as a linear function of
    the rank, then resolve all ranks in a closed-form vectorized pass
    (the read-side use of the linear-summary idea from ``interprocess``).

Exactness: every query is value-identical to the record-iterator path
(``TraceReader.iter_records``), property-tested in
``tests/test_traceview.py``.  Where a compressed-domain shortcut could
diverge on pathological streams (per-file attribution under ambiguous
handle reuse, rank-dependent pattern-run continuation), the view detects
the case from the compressed form and falls back to an exact per-CFG or
per-rank walk.
"""

from __future__ import annotations

import heapq
import warnings
from collections import defaultdict
from itertools import repeat
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import dfg as _dfg
from .encoding import (Handle, IterPattern, RankPattern,
                       concat_signature_columns, decode_signatures_batch)
from .patterns import IntraPatternDecoder
from .reader import Record, _resolve_rank
from .sequitur import (_topo_order, expand_grammar, expand_grammar_reversed,
                       parse_grammar, terminal_counts, terminal_positions)
from .specs import DATA_FUNCS
from .timestamps import effective_exit

# record path and read side share one definition of "data-moving call"
# (specs.DATA_FUNCS); the old name stays importable for existing callers
_DATA_FUNCS = DATA_FUNCS
_OPEN_FUNCS = ("open", "shard_open")
_IO_LAYERS = ("posix", "shardio")
_WRITE_FUNCS = ("pwrite", "shard_write_at")
_I64_SAFE = 1 << 62
_NO_HANDLE = object()


class _SpanBail(Exception):
    """Span walk cannot resolve rank-symbolically (same conditions under
    which the linear replay returns None)."""


class _SpanOverflow(Exception):
    """Span walk left the int64-exact range; redo with Python ints."""


def _contains_rankpattern(v: Any) -> bool:
    if isinstance(v, RankPattern):
        return True
    if isinstance(v, IterPattern):
        return _contains_rankpattern(v.a) or _contains_rankpattern(v.b)
    if isinstance(v, tuple):
        return any(_contains_rankpattern(x) for x in v)
    return False


def _lin0(v: Any) -> Tuple[int, int]:
    """(rank coefficient, constant) of a rank-symbolic scalar."""
    if isinstance(v, RankPattern):
        return v.a, v.b
    return 0, int(v)


def _derive_key(func_id: int, tidx: int, args: tuple, ret: Any,
                roles: Sequence[str], ret_is_offset: bool) -> tuple:
    """The pattern-run decode key of one call: non-offset args split into
    handle ids and key parts (single definition site -- the decoder state
    only matches the runtime tracker if every path builds keys this way)."""
    handle_ids: List[int] = []
    keyparts: List[Any] = []
    for j, a in enumerate(args):
        role = roles[j] if j < len(roles) else "val"
        if role == "offset":
            continue
        if isinstance(a, Handle):
            handle_ids.append(a.id)
        else:
            keyparts.append(a)
    key_ret = None if ret_is_offset else (
        ("h", ret.id) if isinstance(ret, Handle) else ret)
    return (func_id, tidx, tuple(handle_ids), tuple(keyparts), key_ret)


def sweep_conflicts(writes: Dict[Any, List[Tuple[int, int, int]]]
                    ) -> List[Dict[str, Any]]:
    """Cross-rank conflicting extents via an active-interval sweep.

    ``writes`` maps a handle id to ``(rank, start, end)`` half-open spans.
    Every pair of overlapping spans from DIFFERENT ranks is reported (the
    seed scanned only start-adjacent pairs, dropping e.g. a long extent
    overlapping a later non-adjacent span); identical conflicts are
    deduplicated.  ``ranks`` orders the earlier-starting span first and the
    reported extent is ``(later start, min(ends))``.
    """
    conflicts: List[Dict[str, Any]] = []
    seen = set()
    for hid, spans in writes.items():
        # identical (rank, start, end) spans can only rediscover already-
        # deduplicated conflicts; dropping them up front keeps the sweep
        # near-linear when ranks repeatedly rewrite one extent
        spans = list(dict.fromkeys(spans))
        active: List[Tuple[int, int]] = []  # heap of (end, rank)
        for r2, a2, b2 in sorted(spans, key=lambda s: s[1]):
            while active and active[0][0] <= a2:
                heapq.heappop(active)
            for b1, r1 in active:
                if r1 != r2:
                    ext = (a2, min(b1, b2))
                    k = (hid, r1, r2, ext)
                    if k not in seen:
                        seen.add(k)
                        conflicts.append({"handle": hid, "ranks": (r1, r2),
                                          "extent": ext})
            heapq.heappush(active, (b2, r2))
    return conflicts


class _SigInfo:
    """Per-CST-entry derived metadata (role-indexed columns)."""

    __slots__ = ("name", "layer", "is_data", "is_io_layer", "size",
                 "size_symbolic", "handle", "enc")

    def __init__(self) -> None:
        self.enc: Optional[tuple] = None


def make_sig_info(cols, functions: Dict[int, Dict[str, Any]],
                  t: int) -> _SigInfo:
    """Derived metadata of CST entry ``t`` from decoded columns -- the one
    definition site shared by full view construction and the incremental
    refresh path (which derives it only for NEW entries)."""
    finfo = functions[int(cols.func_id[t])]
    args, ret = cols.args[t], cols.ret[t]
    roles = finfo["arg_roles"]
    s = _SigInfo()
    s.name = finfo["name"]
    s.layer = finfo["layer"]
    s.is_data = s.name in _DATA_FUNCS
    s.is_io_layer = s.layer in _IO_LAYERS
    # _size_of: first BUF/SIZE int arg, else int return, else 0
    size = None
    for v, role in zip(args, roles):
        if role in ("buf", "size") and isinstance(v, int):
            size = v
            break
    ret_is_offset = (finfo["ret_role"] == "offset"
                     and isinstance(ret, (int, IterPattern, RankPattern)))
    s.size = size if size is not None else (
        ret if isinstance(ret, int) else 0)
    # a size that would come from a pattern-coded return cannot be read
    # off the signature alone (it depends on the run index / rank)
    s.size_symbolic = size is None and ret_is_offset \
        and not isinstance(ret, int)
    s.handle = next((v.id for v, role in zip(args, roles)
                     if role == "handle" and hasattr(v, "id")), _NO_HANDLE)
    off_slots = [j for j, r in enumerate(roles)
                 if r == "offset" and j < len(args)]
    if off_slots or ret_is_offset:
        key = _derive_key(int(cols.func_id[t]), int(cols.thread[t]),
                          args, ret, roles, ret_is_offset)
        enc = [args[j] for j in off_slots]
        if ret_is_offset:
            enc.append(ret)
        patsig = tuple((v.a, v.b) if isinstance(v, IterPattern) else v
                       for v in enc)
        has_iter = any(isinstance(v, IterPattern) for v in enc)
        # run-key components are never offset-fitted, so a RankPattern
        # in them would make run identity rank-dependent (guarded)
        key_rankdep = (_contains_rankpattern(key[3])
                       or _contains_rankpattern(key[4]))
        s.enc = (key, tuple(enc), patsig, has_iter, off_slots,
                 ret_is_offset, key_rankdep)
    return s


def per_file_fold(rules: List[List[Tuple[int, int]]], sigs, cols,
                  live0: Dict[int, str], toff: int = 0
                  ) -> Tuple[Dict[Any, Tuple[int, int]], Dict[int, str]]:
    """Per-file attribution of ONE grammar's stream as a resumable fold.

    Evaluates ``rules`` (terminal ids local to the grammar, offset by
    ``toff`` into ``sigs``/``cols``) under ENTRY handle->path bindings
    ``live0`` and returns ``(contrib, exit_live)`` where ``contrib`` maps
    file key -> ``(bytes, calls)`` and ``exit_live`` is the binding state
    after the whole stream.  This makes per-file attribution composable
    across epoch segments: fold segment k+1 with segment k's exit state
    and add the contributions -- the incremental-refresh path never
    replays already-folded segments.

    Same rule/read-set memo walk as the sublinear per-file path (a rule's
    contribution depends only on the live bindings of the handles its
    subtree reads; idempotent state updates collapse exponents in closed
    form).  Raises RecursionError on pathologically deep grammars --
    callers fall back to :func:`per_file_fold_linear`.
    """
    n = len(rules)
    # static per-rule summaries, children before parents: the handles a
    # rule's subtree attributes data calls to (its read set) and its net
    # handle->path state update (constant strings -> idempotent)
    reads: List[set] = [set() for _ in range(n)]
    upd: List[Dict[int, str]] = [{} for _ in range(n)]
    for i in reversed(_topo_order(rules)):
        rd: set = set()
        up: Dict[int, str] = {}
        for code, _exp in rules[i]:
            x = code >> 1
            if code & 1:
                rd |= reads[x]
                up.update(upd[x])
            else:
                s = sigs[x + toff]
                if s.is_data and s.handle is not _NO_HANDLE:
                    rd.add(s.handle)
                if s.name in _OPEN_FUNCS and hasattr(cols.ret[x + toff],
                                                     "id"):
                    up[cols.ret[x + toff].id] = str(cols.args[x + toff][0])
        reads[i] = rd
        upd[i] = up

    live: Dict[int, str] = dict(live0)
    memo: Dict[tuple, Dict[Any, Tuple[int, int]]] = {}

    def add(dst: Dict[Any, Tuple[int, int]],
            src: Dict[Any, Tuple[int, int]], mult: int) -> None:
        for k, (b, c) in src.items():
            ob, oc = dst.get(k, (0, 0))
            dst[k] = (ob + mult * b, oc + mult * c)

    def walk(rid: int) -> Dict[Any, Tuple[int, int]]:
        rkey = (rid,) + tuple((h, live.get(h))
                              for h in sorted(reads[rid]))
        hit = memo.get(rkey)
        if hit is not None:
            live.update(upd[rid])
            return hit
        contrib: Dict[Any, Tuple[int, int]] = {}
        for code, exp in rules[rid]:
            x = code >> 1
            if code & 1:
                add(contrib, walk(x), 1)
                if exp > 1:
                    # state after app 1 is a fixed point: apps 2..exp
                    # all see the same entry state and contribute alike
                    add(contrib, walk(x), exp - 1)
            else:
                s = sigs[x + toff]
                if s.name in _OPEN_FUNCS and hasattr(cols.ret[x + toff],
                                                     "id"):
                    live[cols.ret[x + toff].id] = str(cols.args[x + toff][0])
                if s.is_data:
                    k = "?" if s.handle is _NO_HANDLE \
                        else live.get(s.handle)
                    ob, oc = contrib.get(k, (0, 0))
                    contrib[k] = (ob + exp * s.size, oc + exp)
        memo[rkey] = contrib
        return contrib

    res = walk(0) if rules else {}
    return res, live


def per_file_fold_linear(rules: List[List[Tuple[int, int]]], sigs, cols,
                         live0: Dict[int, str], toff: int = 0
                         ) -> Tuple[Dict[Any, Tuple[int, int]],
                                    Dict[int, str]]:
    """Linear-stream reference (and deep-grammar fallback) for
    :func:`per_file_fold`: one walk of the expanded stream."""
    handles: Dict[int, str] = dict(live0)
    per: Dict[Any, Tuple[int, int]] = {}
    for t in expand_grammar(rules):
        s = sigs[t + toff]
        if s.name in _OPEN_FUNCS and hasattr(cols.ret[t + toff], "id"):
            handles[cols.ret[t + toff].id] = str(cols.args[t + toff][0])
        if s.is_data:
            key = "?" if s.handle is _NO_HANDLE else handles.get(s.handle)
            b, c = per.get(key, (0, 0))
            per[key] = (b + s.size, c + 1)
    return per, handles


def _contrib_dicts(contrib: Dict[Any, Tuple[int, int]]
                   ) -> Dict[Any, Dict[str, int]]:
    return {k: {"bytes": b, "calls": c} for k, (b, c) in contrib.items()}


class TraceView:
    """Columnar, compressed-domain query API over one trace directory.

    Build it with :meth:`TraceReader.view`.  Aggregate queries
    (:meth:`io_summary`, :meth:`size_histogram`, :meth:`n_records`) run in
    O(|grammar| + |CST|); sequential queries (:meth:`call_chains`,
    :meth:`consistency_pairs`) cost one stream walk per *unique CFG*, not
    per rank; :meth:`iter_records` is the lossless row-wise reference path
    that the ``TraceReader`` shims delegate to.
    """

    def __init__(self, reader,
                 _reuse: Optional[Dict[str, Any]] = None) -> None:
        if getattr(reader, "degraded", False):
            cov = reader.coverage()
            warnings.warn(
                f"trace has PARTIAL coverage: "
                f"{len(cov['degraded_epochs'])} degraded epoch(s) "
                f"(ranks with gapped streams: {cov['ranks_partial']}), "
                f"{len(cov['skipped'])} skipped segment(s) -- analyses "
                f"are exact over the records present but do not cover "
                f"the full job history", RuntimeWarning, stacklevel=3)
        self.reader = reader
        self.nranks: int = reader.nranks
        self.functions: Dict[int, Dict[str, Any]] = reader.functions
        self.grammars = reader.unique_cfgs
        self.cfg_index: List[int] = reader.cfg_index
        # the timestamp store is CAPTURED at build time: a later
        # `reader.refresh()` swaps the reader's store, but this view keeps
        # serving the snapshot it was built from (generation safety)
        self._ts_store = reader.ts_store
        if _reuse is None:
            self.columns = decode_signatures_batch(reader.merged_cst)
            self._sigs = [self._sig_info(t)
                          for t in range(len(self.columns))]
            self._counts: Dict[int, Dict[int, int]] = {}
            self._positions: Dict[int, Tuple[Dict[int, int],
                                             Dict[int, int]]] = {}
            self._pfstate: Dict[int, Tuple[Dict[Any, Tuple[int, int]],
                                           Dict[int, str]]] = {}
            self._ts: Dict[int, Optional[np.ndarray]] = {}
            self._digrams: Dict[int, Tuple[Dict[Tuple[int, int], int],
                                           Optional[int],
                                           Optional[int]]] = {}
            self._phases: Dict[int, List[Dict[str, Any]]] = {}
        else:
            # seeded construction (refreshed_view): the already-decoded
            # column prefix plus per-unique-CFG memos folded forward --
            # nothing about the previously-loaded segments is re-derived
            self.columns = _reuse["columns"]
            self._sigs = _reuse["sigs"]
            self._counts = dict(_reuse["counts"])
            self._positions = dict(_reuse["positions"])
            self._pfstate = dict(_reuse["pfstate"])
            self._ts = dict(_reuse["ts"])
            self._digrams = dict(_reuse["digrams"])
            self._phases = dict(_reuse["phases"])
        self._cfg_mult: Dict[int, int] = {}
        for u in self.cfg_index:
            self._cfg_mult[u] = self._cfg_mult.get(u, 0) + 1
        # per-unique-CFG memos
        self._perfile: Dict[int, Dict[Any, Dict[str, int]]] = {
            u: _contrib_dicts(contrib)
            for u, (contrib, _exit) in self._pfstate.items()}
        self._spancols: Dict[Tuple[int, tuple], Any] = {}
        self._totals: Optional[Dict[int, int]] = None

    # -- column construction --------------------------------------------------

    def _sig_info(self, t: int) -> _SigInfo:
        return make_sig_info(self.columns, self.functions, t)

    # -- grammar-weighted counts ----------------------------------------------

    def cfg_terminal_counts(self, u: int) -> Dict[int, int]:
        """Occurrence count of every terminal of unique CFG ``u`` --
        O(|grammar|) via rule expansion weights, memoized."""
        counts = self._counts.get(u)
        if counts is None:
            counts = terminal_counts(self.grammars[u])
            self._counts[u] = counts
        return counts

    def rank_terminal_counts(self, rank: int) -> Dict[int, int]:
        return self.cfg_terminal_counts(self.cfg_index[rank])

    def total_terminal_counts(self) -> Dict[int, int]:
        """Terminal counts summed over ALL ranks: one weighted pass per
        unique CFG, resolved across ranks by CFG multiplicity (never a
        per-rank loop over records)."""
        if self._totals is None:
            totals: Dict[int, int] = {}
            for u, mult in self._cfg_mult.items():
                for t, c in self.cfg_terminal_counts(u).items():
                    totals[t] = totals.get(t, 0) + mult * c
            self._totals = totals
        return self._totals

    def n_records(self, rank: int) -> int:
        """Record count of one rank in O(|grammar|) (no expansion)."""
        return sum(self.cfg_terminal_counts(self.cfg_index[rank]).values())

    def total_records(self) -> int:
        return sum(self.total_terminal_counts().values())

    def digram_counts(self, rank: Optional[int] = 0,
                      backend: Optional[str] = None
                      ) -> Dict[Tuple[int, int], int]:
        """Adjacent-pair (digram) counts of the expanded call-signature
        stream -- the repeated-structure profile Sequitur compresses.

        Default path (``backend=None``): derived straight from the
        grammar in O(|grammar|) via :func:`dfg.grammar_digrams` -- no
        record expansion -- memoized per unique CFG.  ``rank=None``
        aggregates over ALL ranks with one walk per unique CFG, scaled
        by CFG multiplicity (the same trick as
        :meth:`total_terminal_counts`).

        An explicit ``backend`` keeps the expansion reference: the
        stream is materialized as an int64 vector and the histogram
        dispatched through :mod:`encode_backend` (NumPy bincount or the
        ``grammar_stats`` digram kernel) -- O(records), kept as the
        kernel-comparison and property-test path.
        """
        if backend is not None:
            if rank is None:
                total: Dict[Tuple[int, int], int] = {}
                for u, mult in self._cfg_mult.items():
                    for k, c in self._digrams_expand(u, backend).items():
                        total[k] = total.get(k, 0) + mult * c
                return total
            return self._digrams_expand(self.cfg_index[rank], backend)
        if rank is None:
            total = {}
            for u, mult in self._cfg_mult.items():
                for k, c in self._cfg_digrams(u)[0].items():
                    total[k] = total.get(k, 0) + mult * c
            return total
        return dict(self._cfg_digrams(self.cfg_index[rank])[0])

    def _digrams_expand(self, u: int, backend: Optional[str]
                        ) -> Dict[Tuple[int, int], int]:
        stream = np.fromiter(expand_grammar(self.grammars[u]),
                             dtype=np.int64)
        from . import encode_backend as _eb
        return _eb.digram_histogram(stream, len(self._sigs), backend)

    # -- DFG / phase / divergence observability (O(|grammar|)) ----------------

    def _cfg_digrams(self, u: int) -> Tuple[Dict[Tuple[int, int], int],
                                            Optional[int], Optional[int]]:
        """``(edges, first, last)`` of unique CFG ``u``'s expansion --
        O(|grammar|), memoized, and seeded forward by the incremental
        refresh (one delta-sized walk per new epoch segment)."""
        d = self._digrams.get(u)
        if d is None:
            d = _dfg.grammar_digrams(self.grammars[u])
            self._digrams[u] = d
        return d

    def _cfg_phases(self, u: int) -> List[Dict[str, Any]]:
        """Raw phase rows of unique CFG ``u`` (shared by every rank using
        it): episode profile + dominant-set merge, O(|grammar|),
        memoized and refresh-folded like :meth:`_cfg_digrams`."""
        p = self._phases.get(u)
        if p is None:
            sigs = self._sigs
            eps = _dfg.grammar_episodes(self.grammars[u],
                                        lambda t: sigs[t].name)
            p = _dfg.phase_segments(eps)
            self._phases[u] = p
        return p

    def _label_of(self, t: int) -> Tuple[str, str]:
        return _dfg.node_label(self._sigs[t])

    def dfg(self, rank: Optional[int] = None) -> Dict[str, Any]:
        """Directly-Follows Graph of one rank (or, default, all ranks
        aggregated) at ``(func, pattern-class)`` node granularity.

        Nodes carry occurrence counts (grammar-weighted), edges the
        exact directly-follows counts of the expanded stream(s) --
        derived entirely in the compressed domain: one
        :func:`dfg.grammar_digrams` walk per unique CFG, scaled by CFG
        multiplicity for the aggregate.  Label granularity makes the
        graph identical across merged/stitched reads (whose terminal id
        spaces differ) and across SPMD ranks whose offsets differ only
        by rank.
        """
        if rank is None:
            term_counts = self.total_terminal_counts()
            edges = self.digram_counts(rank=None)
        else:
            term_counts = self.cfg_terminal_counts(self.cfg_index[rank])
            edges = self._cfg_digrams(self.cfg_index[rank])[0]
        node_ids: Dict[Tuple[str, str], int] = {}
        nodes: List[Dict[str, Any]] = []

        def nid(t: int) -> int:
            lab = self._label_of(t)
            i = node_ids.get(lab)
            if i is None:
                i = node_ids[lab] = len(nodes)
                nodes.append({"func": lab[0], "pattern": lab[1],
                              "count": 0})
            return i

        for t in sorted(term_counts):
            nodes[nid(t)]["count"] += term_counts[t]
        agg: Dict[Tuple[int, int], int] = {}
        for (a, b), w in edges.items():
            k = (nid(a), nid(b))
            agg[k] = agg.get(k, 0) + w
        rows = [{"src": a, "dst": b, "weight": w}
                for (a, b), w in agg.items()]
        rows.sort(key=lambda e: (-e["weight"], e["src"], e["dst"]))
        return {"nodes": nodes, "edges": rows,
                "n_records": sum(term_counts.values())}

    def phases(self, rank: int = 0) -> List[Dict[str, Any]]:
        """Phase segmentation of one rank's stream: contiguous record
        ranges ``[start_record, end_record)`` where the dominant
        function set is stable, labeled (``write-loop``, ``read``,
        ``metadata``, ...).  Derived from the grammar's episode
        structure -- O(|grammar|), no expansion; record positions come
        from the closed-form per-rule expansion lengths, so they are
        exact stream indices without materializing the stream."""
        return _dfg.phase_report(self._cfg_phases(self.cfg_index[rank]))

    def rank_divergence(self, threshold: float = 0.25) -> Dict[str, Any]:
        """Per-rank structural divergence from the SPMD majority.

        Every unique CFG's label-projected DFG is fingerprinted; the
        fingerprint group covering the most ranks is the majority
        behavior, and each rank is scored by :func:`dfg.dfg_distance`
        against it (total variation on edge-weight distributions, in
        [0, 1]).  Ranks above ``threshold`` are flagged divergent --
        the structural signal behind the ``anomalies`` query family and
        the ``dfg_divergent`` straggler reason.  Cost: one grammar walk
        per unique CFG, never per rank.
        """
        if not self._cfg_mult:
            return {"per_rank": [], "divergent": [], "majority_size": 0,
                    "nranks": self.nranks, "threshold": threshold}
        label_edges = {
            u: _dfg.project_edges(self._cfg_digrams(u)[0], self._label_of)
            for u in self._cfg_mult}
        groups: Dict[tuple, List[int]] = {}
        for u, le in label_edges.items():
            fp = tuple(sorted(le.items()))
            groups.setdefault(fp, []).append(u)

        def group_ranks(us: List[int]) -> int:
            return sum(self._cfg_mult[u] for u in us)

        maj_fp = max(groups, key=lambda fp: (group_ranks(groups[fp]), fp))
        maj_edges = dict(maj_fp)
        per_rank = [round(_dfg.dfg_distance(
            label_edges[self.cfg_index[r]], maj_edges), 9)
            for r in range(self.nranks)]
        return {
            "per_rank": per_rank,
            "divergent": [r for r, d in enumerate(per_rank)
                          if d > threshold],
            "majority_size": group_ranks(groups[maj_fp]),
            "nranks": self.nranks,
            "threshold": threshold,
        }

    # -- lazy, memoized per-rank timestamps -----------------------------------

    @property
    def ts_store(self):
        """The per-rank timestamp store THIS VIEW was built over
        (single-blob, block-indexed or stitched multi-segment; shared
        ``blocks_touched`` counter).  Captured at construction: the view
        stays consistent with its snapshot even after the reader folds in
        newly committed segments."""
        return self._ts_store

    def _decompress_ts(self, rank: int) -> Optional[np.ndarray]:
        return self._ts_store.load(rank)

    def timestamps(self, rank: int) -> Optional[np.ndarray]:
        """(n, 2) entry/exit tick array of one rank, or None when the trace
        has no timestamps for it.  Decompressed on first touch, memoized."""
        if rank not in self._ts:
            self._ts[rank] = self._decompress_ts(rank)
        return self._ts[rank]

    def timestamps_unwrapped(self, rank: int) -> Optional[np.ndarray]:
        """(n, 2) int64 entry/exit ticks with the uint32 wrap (~71.6 min)
        unwrapped into a monotonic clock: the store seeds the wrap base
        from each segment's per-epoch ``tick_wraps`` metadata and detects
        further in-epoch wraps from the tick sequence itself.  Not
        memoized (days-long traces; callers keep what they need)."""
        return self.ts_store.load_unwrapped(rank)

    # -- aggregate queries (grammar-weighted) ---------------------------------

    def io_summary(self) -> Dict[str, Any]:
        """Aggregate transfer sizes, call mix, per-file totals, bandwidth.

        Counts and byte totals are weighted sums over distinct signatures;
        per-file attribution is weighted too when the grammar proves every
        data call follows a unique open of its handle (first/last terminal
        positions), else it falls back to one exact walk per unique CFG.
        Timestamp bounds are the only part that touches expanded data, and
        only lazily (per-rank decompressed arrays, vectorized min/max).
        """
        totals = self.total_terminal_counts()
        sigs = self._sigs
        n_data = n_meta = total_bytes = 0
        for t, c in totals.items():
            s = sigs[t]
            if s.is_data:
                n_data += c
                total_bytes += c * s.size
            elif s.is_io_layer:
                n_meta += c
        per_file: Dict[Any, Dict[str, int]] = defaultdict(
            lambda: {"bytes": 0, "calls": 0})
        for u, mult in self._cfg_mult.items():
            for key, d in self._per_file_cfg(u).items():
                agg = per_file[key]
                agg["bytes"] += mult * d["bytes"]
                agg["calls"] += mult * d["calls"]
        t_lo: Any = float("inf")
        t_hi: Any = 0
        for r in range(self.nranks):
            # transient decompress: reducing all ranks to a min/max must not
            # pin every rank's array in the memo (reuse it when present)
            ts = self._ts[r] if r in self._ts else self._decompress_ts(r)
            if ts is None or not len(ts):
                continue
            ent = ts[:, 0].astype(np.int64)
            ext = ts[:, 1].astype(np.int64)
            t_lo = min(t_lo, int(ent.min()))
            # a zero exit tick falls back to the entry tick (seed `or`)
            t_hi = max(t_hi, int(np.where(ext != 0, ext, ent).max()))
        wall_us = max(t_hi - t_lo, 1)
        return {
            "files": dict(per_file),
            "n_data_calls": n_data,
            "n_metadata_calls": n_meta,
            "metadata_ratio": n_meta / max(n_data + n_meta, 1),
            "total_bytes": total_bytes,
            "aggregate_MBps": total_bytes / wall_us,  # bytes/us == MB/s
        }

    def size_histogram(self, edges: Sequence[int] = (512, 4096, 65536, 1 << 20)
                       ) -> Dict[str, int]:
        """Request-size distribution of data calls: pure weighted sum over
        distinct signatures (O(|grammar| + |CST|))."""
        buckets = {f"<{e}": 0 for e in edges}
        top = f">={edges[-1]}"
        buckets[top] = 0
        sigs = self._sigs
        for t, c in self.total_terminal_counts().items():
            s = sigs[t]
            if not s.is_data:
                continue
            for e in edges:
                if s.size < e:
                    buckets[f"<{e}"] += c
                    break
            else:
                buckets[top] += c
        return buckets

    def _cfg_positions(self, u: int):
        pos = self._positions.get(u)
        if pos is None:
            pos = terminal_positions(self.grammars[u])
            self._positions[u] = pos
        return pos

    def _per_file_cfg(self, u: int) -> Dict[Any, Dict[str, int]]:
        """Per-file {bytes, calls} of ONE rank using CFG ``u`` (identical
        for every rank sharing the CFG; callers scale by multiplicity).

        Fast path: grammar-weighted, using first/last terminal positions to
        prove each data call sees exactly one open path for its handle.
        Ambiguous handle/path reuse falls back to one exact stream walk.
        """
        cached = self._perfile.get(u)
        if cached is not None:
            return cached
        counts = self.cfg_terminal_counts(u)
        sigs = self._sigs
        cols = self.columns
        opens: Dict[int, set] = {}
        open_first: Dict[int, int] = {}
        data_terms = []
        need_pos = False
        for t in counts:
            s = sigs[t]
            if s.name in _OPEN_FUNCS and hasattr(cols.ret[t], "id"):
                opens.setdefault(cols.ret[t].id, set()).add(
                    str(cols.args[t][0]))
                need_pos = True
            if s.is_data:
                data_terms.append(t)
        per: Dict[Any, Dict[str, int]] = {}
        first = last = None
        if need_pos:
            first, last = self._cfg_positions(u)
            for t in counts:
                s = sigs[t]
                if s.name in _OPEN_FUNCS and hasattr(cols.ret[t], "id"):
                    h = cols.ret[t].id
                    p = first[t]
                    if h not in open_first or p < open_first[h]:
                        open_first[h] = p
        ok = True
        for t in data_terms:
            s = sigs[t]
            if s.handle is _NO_HANDLE:
                key: Any = "?"
            elif s.handle not in opens:
                key = None  # never opened in this stream
            elif len(opens[s.handle]) == 1:
                if open_first[s.handle] < first[t]:
                    key = next(iter(opens[s.handle]))
                elif open_first[s.handle] > last[t]:
                    key = None  # every occurrence precedes the open
                else:
                    ok = False  # occurrences straddle the open
                    break
            else:
                ok = False  # handle re-opened under different paths
                break
            agg = per.setdefault(key, {"bytes": 0, "calls": 0})
            agg["bytes"] += counts[t] * s.size
            agg["calls"] += counts[t]
        if not ok:
            per = self._per_file_walk(u)
        self._perfile[u] = per
        return per

    def _per_file_walk(self, u: int) -> Dict[Any, Dict[str, int]]:
        """Exact per-file attribution without expanding the stream.

        Recursive rule evaluation with a per-rule memo (the carried-over
        ROADMAP item): a rule's contribution depends only on the live
        handle->path bindings of the handles its subtree READS, so the memo
        key is ``(rule, entry values of its read set)``.  Exponents
        collapse in closed form -- a rule's state effect is a constant
        overwrite map, hence idempotent, so application 2 is a fixed point
        and apps ``2..e`` contribute ``(e-1) x`` its result.  SPMD loop
        grammars evaluate in O(|grammar|) instead of O(stream).
        Property-tested equal to :meth:`_per_file_walk_linear`, which also
        serves as the fallback for pathologically deep grammars."""
        contrib, _exit = self._pf_state(u)
        return _contrib_dicts(contrib)

    def _pf_state(self, u: int) -> Tuple[Dict[Any, Tuple[int, int]],
                                         Dict[int, str]]:
        """``(contrib, exit_live)`` of CFG ``u``'s whole stream under empty
        entry bindings, memoized -- the resumable form the incremental
        refresh folds new segments onto (:func:`per_file_fold`)."""
        st = self._pfstate.get(u)
        if st is None:
            try:
                st = per_file_fold(self.grammars[u], self._sigs,
                                   self.columns, {})
            except RecursionError:
                st = per_file_fold_linear(self.grammars[u], self._sigs,
                                          self.columns, {})
            self._pfstate[u] = st
        return st

    def _per_file_walk_memo(self, u: int) -> Dict[Any, Dict[str, int]]:
        contrib, _exit = per_file_fold(self.grammars[u], self._sigs,
                                       self.columns, {})
        return _contrib_dicts(contrib)

    def _per_file_walk_linear(self, u: int) -> Dict[Any, Dict[str, int]]:
        """Exact per-file attribution: one linear walk of CFG ``u``'s
        stream (the reference for :meth:`_per_file_walk`)."""
        contrib, _exit = per_file_fold_linear(self.grammars[u], self._sigs,
                                              self.columns, {})
        return _contrib_dicts(contrib)

    # -- sequential queries (one walk per unique CFG) -------------------------

    def call_chains(self, targets=_DATA_FUNCS, rank: int = 0) -> Dict[str, int]:
        """Cross-layer ancestry chains ending in a target call.

        The post-order stream is walked in REVERSE, streamed lazily from
        the grammar (``expand_grammar_reversed``) -- parents appear before
        children, so the depth-indexed stack rebuilds each chain without
        materializing the forward record list.
        """
        sigs = self._sigs
        depth = self.columns.depth.tolist()
        chains: Dict[str, int] = defaultdict(int)
        stack: List[str] = []
        for t in expand_grammar_reversed(self.grammars[self.cfg_index[rank]]):
            name = sigs[t].name
            del stack[depth[t]:]
            stack.append(name)
            if name in targets:
                chains["->".join(stack)] += 1
        return dict(chains)

    @staticmethod
    def _overlap_sweep(ent: np.ndarray, ext: np.ndarray) -> float:
        t = np.concatenate([ent, ext]).astype(np.int64)
        n = len(ent)
        d = np.concatenate([np.ones(n, np.int64), -np.ones(n, np.int64)])
        # tuple-sort order of the seed: by time, exits (-1) before entries
        order = np.lexsort((d, t))
        t, d = t[order], d[order]
        c = np.cumsum(d)[:-1]  # depth between consecutive events
        dt = np.diff(t)
        busy = int(dt[c >= 1].sum())
        overlap = int(dt[c >= 2].sum())
        return overlap / busy if busy else 0.0

    def overlap_ratio(self, rank: int = 0, t0: Optional[int] = None,
                      t1: Optional[int] = None) -> float:
        """Fraction of busy I/O time with >= 2 threads inside calls:
        vectorized event sweep over the rank's timestamps.

        With a ``[t0, t1)`` window, only the timestamp blocks whose
        ``[t_min, t_max]`` span intersects the window are decompressed
        (block-indexed streaming traces; observable through
        ``ts_store.blocks_touched``) and call intervals are clipped to the
        window, effective exits (zero exit -> entry) applied.

        Windows are in raw uint32 microsecond ticks, which wrap at ~71.6
        minutes (the trace format's documented tick policy): windowed
        queries are exact within one wrap period; for multi-hour absolute
        windows rebase against :meth:`timestamps_unwrapped`, which serves
        monotonic int64 ticks from the per-epoch wrap metadata."""
        if t0 is None and t1 is None:
            ts = self.timestamps(rank)
            if ts is None or not len(ts):
                return 0.0
            return self._overlap_sweep(ts[:, 0], ts[:, 1])
        lo = 0 if t0 is None else int(t0)
        hi = (1 << 62) if t1 is None else int(t1)
        ts = self.ts_store.window(rank, lo, hi)
        if ts is None or not len(ts):
            return 0.0
        ent = np.clip(ts[:, 0].astype(np.int64), lo, hi)
        return self._overlap_sweep(ent, np.clip(effective_exit(ts), lo, hi))

    def bandwidth_bounds(self, t0: int, t1: int) -> Dict[str, Any]:
        """Compressed-domain aggregate bandwidth over ``[t0, t1)``.

        Call counts AND data bytes come from the timestamp stores' windowed
        stats (only blocks straddling the window edges are decompressed;
        fully covered blocks are answered from the index).  Traces written
        with per-block byte counters (the sized timestamp layout) get an
        EXACT byte total -- ``lo_MBps == hi_MBps`` and ``exact: True`` --
        matching a per-record walk.  Older traces without the counters fall
        back to the CST-derived bounds: every windowed call transfers at
        most the trace's largest data-call size, and at least 0 when the
        trace mixes in metadata calls (else the smallest data size).
        """
        if not t1 > t0:
            raise ValueError("window must satisfy t1 > t0")
        n_calls = 0
        n_bytes = 0
        exact = True
        for r in range(self.nranks):
            stats = self.ts_store.window_stats(r, t0, t1)
            if stats is None:
                continue
            n_calls += stats[0]
            if stats[1] is None:
                if stats[0]:
                    exact = False
            else:
                n_bytes += stats[1]
        window_us = t1 - t0
        if exact:
            lo_bytes = hi_bytes = n_bytes
        else:
            data_sizes = [s.size for s in self._sigs if s.is_data]
            any_non_data = any(not s.is_data for s in self._sigs)
            hi_bytes = n_calls * (max(data_sizes) if data_sizes else 0)
            lo_bytes = 0 if (any_non_data or not data_sizes) \
                else n_calls * min(data_sizes)
        return {
            "n_calls": n_calls,
            "window_us": window_us,
            "exact": exact,
            "bytes": n_bytes if exact else None,
            "lo_MBps": lo_bytes / window_us,   # bytes/us == MB/s
            "hi_MBps": hi_bytes / window_us,
        }

    def _span_cols(self, u: int, targets: tuple):
        """Rank-symbolic write extents of CFG ``u``, grouped by handle id in
        stream order (offsets stay linear functions of the rank).

        Returns ``[(hid, coefs, consts, sizes, np_cols)]`` or None when
        the run evolution could be rank-dependent (distinct pattern
        signatures carrying RankPattern compared under one key) -- callers
        then fall back to the exact per-rank record path.

        The default implementation (:meth:`_span_cols_walk`) replays the
        grammar recursively with closed-form loop extrapolation: a symbol
        repeated ``e`` times is applied twice, and if the pattern-run state
        is stationary between the applications the remaining ``e - 2`` are
        emitted as vectorized columns (each emission advances linearly in
        its run index) -- sublinear walk work for SPMD loops (ROADMAP
        carried-over item).  :meth:`_span_cols_linear` is the
        property-tested reference and the fallback for int64-overflowing
        offsets or pathologically deep grammars.
        """
        ck = (u, targets)
        if ck in self._spancols:
            return self._spancols[ck]
        try:
            result = self._span_cols_walk(u, targets)
        except _SpanBail:
            result = None
        except (_SpanOverflow, RecursionError):
            result = self._span_cols_linear(u, targets)
        self._spancols[ck] = result
        return result

    def _span_cols_walk(self, u: int, targets: tuple):
        rules = self.grammars[u]
        sigs = self._sigs
        nranks = self.nranks
        runs: Dict[Any, Tuple[int, Optional[tuple]]] = {}
        key_ids: Dict[Any, int] = {}      # run key -> dense id (kid)
        # columnar emission log: 7 parallel columns
        #   hid, coef, const, size, ca, va, kid
        # (ca, va) is the per-run-index advance of (coef, const) -- the
        # rank-linear components of the IterPattern stride -- and kid the
        # emission's run key (-1: value does not advance with any run).
        buf: List[List[int]] = [[] for _ in range(7)]
        chunks: List[List[np.ndarray]] = []

        def seal() -> None:
            if buf[0]:
                try:
                    chunks.append([np.asarray(c, np.int64) for c in buf])
                except OverflowError:
                    raise _SpanOverflow from None
                for c in buf:
                    c.clear()

        def do_terminal(x: int) -> None:
            s = sigs[x]
            vals0 = None  # (coef, const, ca, va, kid) of offset slot 0
            if s.enc is not None:
                (key, enc, patsig, has_iter, off_slots, _ret_is_offset,
                 key_rankdep) = s.enc
                if key_rankdep:
                    raise _SpanBail
                if not has_iter:
                    runs[key] = (1, None)
                    c0, k0 = _lin0(enc[0])
                    vals0 = (c0, k0, 0, 0, -1)
                else:
                    idx, prev = runs.get(key, (1, None))
                    if prev is not None and prev == patsig:
                        idx += 1
                    elif prev is not None and (
                            _contains_rankpattern(prev)
                            or _contains_rankpattern(patsig)):
                        raise _SpanBail
                    v = enc[0]
                    if isinstance(v, IterPattern):
                        ca, va = _lin0(v.a)
                        cb, vb = _lin0(v.b)
                        kid = key_ids.setdefault(key, len(key_ids))
                        vals0 = (cb + idx * ca, vb + idx * va, ca, va, kid)
                    else:
                        c0, k0 = _lin0(v)
                        vals0 = (c0, k0, 0, 0, -1)
                    runs[key] = (idx, patsig)
            if (s.name in targets and vals0 is not None
                    and s.enc is not None and s.enc[4]):
                if s.size_symbolic:
                    raise _SpanBail
                hid = -1 if s.handle is _NO_HANDLE else s.handle
                row = (hid, vals0[0], vals0[1], s.size, vals0[2], vals0[3],
                       vals0[4])
                for c, v in zip(buf, row):
                    c.append(v)

        def rep(fn, exp: int) -> None:
            if exp <= 2:
                for _ in range(exp):
                    fn()
                return
            fn()                          # application 1
            s1 = dict(runs)
            seal()
            mark = len(chunks)
            fn()                          # application 2
            s2 = dict(runs)
            # stationarity: same run keys with the same pattern signatures
            # -> apps 3..exp replay app 2 with run indices shifted by the
            # constant per-application advance (the guard bails are static
            # or patsig-driven, so app 2 passing implies the rest pass)
            if set(s1) != set(s2) or any(s1[k][1] != s2[k][1] for k in s1):
                for _ in range(exp - 2):
                    fn()
                return
            reps = exp - 2
            seal()
            app2 = chunks[mark:]
            if app2:
                cols2 = [np.concatenate([c[j] for c in app2])
                         for j in range(7)]
                hid2, coef2, const2, size2, ca2, va2, kid2 = cols2
                di_by_kid = np.zeros(len(key_ids) + 1, np.int64)
                for k, (i2, _sig) in s2.items():
                    kid = key_ids.get(k)
                    if kid is not None:
                        di_by_kid[kid] = i2 - s1[k][0]
                d = di_by_kid[np.where(kid2 >= 0, kid2, len(key_ids))]
                dc = d * ca2
                dk = d * va2
                # keep the extrapolated columns int64-exact (float bound is
                # conservative at these magnitudes: slack << headroom)
                base = max(float(np.abs(coef2).max(initial=0)),
                           float(np.abs(const2).max(initial=0)))
                step = max(float(np.abs(dc).max(initial=0)),
                           float(np.abs(dk).max(initial=0)))
                if base + reps * step >= float(_I64_SAFE):
                    raise _SpanOverflow
                j = np.arange(1, reps + 1, dtype=np.int64)
                chunks.append([
                    np.tile(hid2, reps),
                    (coef2[None, :] + j[:, None] * dc[None, :]).ravel(),
                    (const2[None, :] + j[:, None] * dk[None, :]).ravel(),
                    np.tile(size2, reps),
                    np.tile(ca2, reps),
                    np.tile(va2, reps),
                    np.tile(kid2, reps),
                ])
            for k, (i2, sig) in s2.items():
                di = i2 - s1[k][0]
                if di:
                    runs[k] = (i2 + reps * di, sig)

        def walk_rule(rid: int) -> None:
            for code, exp in rules[rid]:
                x = code >> 1
                if code & 1:
                    rep(lambda x=x: walk_rule(x), exp)
                else:
                    rep(lambda x=x: do_terminal(x), exp)

        if rules:
            walk_rule(0)
        seal()
        if not chunks:
            return []
        hids = np.concatenate([c[0] for c in chunks])
        coefs = np.concatenate([c[1] for c in chunks])
        consts = np.concatenate([c[2] for c in chunks])
        sizes = np.concatenate([c[3] for c in chunks])
        result = []
        _, first_idx = np.unique(hids, return_index=True)
        for i in np.sort(first_idx):      # first-appearance order
            h = int(hids[i])
            sel = hids == h
            cf, ct, sz = coefs[sel], consts[sel], sizes[sel]
            bound = (int(np.abs(ct).max(initial=0))
                     + nranks * int(np.abs(cf).max(initial=0))
                     + int(np.abs(sz).max(initial=0)))
            np_cols = (cf, ct, sz) if bound < _I64_SAFE else None
            result.append((h, cf.tolist(), ct.tolist(), sz.tolist(),
                           np_cols))
        return result

    def _span_cols_linear(self, u: int, targets: tuple):
        """Linear symbolic replay of CFG ``u``'s full stream -- the
        reference (and big-int / deep-grammar fallback) for
        :meth:`_span_cols_walk`."""
        sigs = self._sigs
        runs: Dict[Any, Tuple[int, Optional[tuple]]] = {}
        order: List[int] = []
        groups: Dict[Any, Tuple[List[int], List[int], List[int]]] = {}
        result: Any = []
        for t in expand_grammar(self.grammars[u]):
            s = sigs[t]
            vals: Optional[List[Tuple[int, int]]] = None
            if s.enc is not None:
                (key, enc, patsig, has_iter, off_slots, ret_is_offset,
                 key_rankdep) = s.enc
                if key_rankdep:
                    result = None
                    break
                if not has_iter:
                    runs[key] = (1, None)
                    vals = [_lin0(v) for v in enc]
                else:
                    idx, prev = runs.get(key, (1, None))
                    if prev is not None and prev == patsig:
                        idx += 1
                    elif prev is not None and (
                            _contains_rankpattern(prev)
                            or _contains_rankpattern(patsig)):
                        # symbolically distinct signatures could still
                        # coincide for individual ranks: not resolvable
                        # rank-symbolically
                        result = None
                        break
                    vals = []
                    for v in enc:
                        if isinstance(v, IterPattern):
                            ca, va = _lin0(v.a)
                            cb, vb = _lin0(v.b)
                            vals.append((cb + idx * ca, vb + idx * va))
                        else:
                            vals.append(_lin0(v))
                    runs[key] = (idx, patsig)
            if (s.name in targets and vals is not None and s.enc is not None
                    and s.enc[4]):  # has at least one offset ARG slot
                if s.size_symbolic:
                    result = None
                    break
                hid = -1 if s.handle is _NO_HANDLE else s.handle
                if hid not in groups:
                    groups[hid] = ([], [], [])
                    order.append(hid)
                coef, const = vals[0]
                g = groups[hid]
                g[0].append(coef)
                g[1].append(const)
                g[2].append(s.size)
        if result is not None:
            for hid in order:
                coefs, consts, sizes = groups[hid]
                bound = (max(map(abs, consts), default=0)
                         + self.nranks * max(map(abs, coefs), default=0)
                         + max(map(abs, sizes), default=0))
                np_cols = None
                if bound < _I64_SAFE:
                    np_cols = (np.asarray(coefs, dtype=np.int64),
                               np.asarray(consts, dtype=np.int64),
                               np.asarray(sizes, dtype=np.int64))
                result.append((hid, coefs, consts, sizes, np_cols))
        return result

    def consistency_pairs(self, targets=_WRITE_FUNCS) -> List[Dict[str, Any]]:
        """Cross-rank overlapping write extents per handle id.

        Extents are produced rank-symbolically once per unique CFG and
        resolved for every rank in one vectorized pass; conflicts come from
        :func:`sweep_conflicts` (ALL overlapping cross-rank pairs, not just
        start-adjacent ones).
        """
        targets = tuple(targets)
        writes: Dict[int, List[Tuple[int, int, int]]] = {}
        for r in range(self.nranks):
            cols = self._span_cols(self.cfg_index[r], targets)
            if cols is None:
                self._collect_spans_records(r, targets, writes)
                continue
            for hid, coefs, consts, sizes, np_cols in cols:
                lst = writes.setdefault(hid, [])
                if np_cols is not None:
                    c1, c0, sz = np_cols
                    starts = c0 + r * c1
                    lst.extend(zip(repeat(r), starts.tolist(),
                                   (starts + sz).tolist()))
                else:
                    lst.extend((r, c0 + r * c1, c0 + r * c1 + sz)
                               for c1, c0, sz in zip(coefs, consts, sizes))
        return sweep_conflicts(writes)

    def _collect_spans_records(self, rank: int, targets: tuple,
                               writes: Dict[int, List[Tuple[int, int, int]]]
                               ) -> None:
        """Exact per-rank fallback: expand this rank's records."""
        for rec in self.iter_records(rank, timestamps=False):
            if rec.func not in targets:
                continue
            off = next((v for v, role in zip(rec.args, rec.roles)
                        if role == "offset" and isinstance(v, int)), None)
            if off is None:
                continue
            sz = next((v for v, role in zip(rec.args, rec.roles)
                       if role in ("buf", "size") and isinstance(v, int)),
                      rec.ret if isinstance(rec.ret, int) else 0)
            hid = next((v.id for v, role in zip(rec.args, rec.roles)
                        if role == "handle" and hasattr(v, "id")), -1)
            writes.setdefault(hid, []).append((rank, off, off + sz))

    # -- the lossless row-wise reference path ---------------------------------

    def iter_records(self, rank: int, timestamps: bool = True
                     ) -> Iterator[Record]:
        """Expand one rank's full record stream (lossless reconstruction).

        This is the seed read path, now fed from the batch-decoded columns;
        ``TraceReader.iter_records`` delegates here.  Prefer the aggregate
        queries above -- they answer without expansion.
        """
        grammar = self.grammars[self.cfg_index[rank]]
        decoder = IntraPatternDecoder()
        cols = self.columns
        sigs = self._sigs
        # transient unless already memoized: a full-trace iteration (e.g.
        # the converters) must not pin every rank's array, like the seed
        ts = None
        if timestamps:
            ts = self._ts[rank] if rank in self._ts else \
                self._decompress_ts(rank)
        for i, terminal in enumerate(expand_grammar(grammar)):
            s = sigs[terminal]
            func_id = int(cols.func_id[terminal])
            tidx = int(cols.thread[terminal])
            finfo = self.functions[func_id]
            roles = finfo["arg_roles"]
            # resolve rank patterns everywhere
            args = tuple(_resolve_rank(a, rank)
                         for a in cols.args[terminal])
            ret = _resolve_rank(cols.ret[terminal], rank)
            # resolve iteration patterns on OFFSET-role slots (and returns),
            # reusing the per-terminal derivation from the columns; only a
            # rank-dependent key (RankPattern in its parts) is re-derived
            if s.enc is not None:
                key, _, _, _, off_slots, ret_is_offset, key_rankdep = s.enc
                if key_rankdep:
                    key = _derive_key(func_id, tidx, args, ret, roles,
                                      ret_is_offset)
                enc = [args[j] for j in off_slots]
                if ret_is_offset:
                    enc.append(ret)
                dec = decoder.decode(key, enc)
                args = list(args)
                for j, v in zip(off_slots, dec):
                    args[j] = v
                args = tuple(args)
                if ret_is_offset:
                    ret = dec[-1]
            t0 = int(ts[i, 0]) if ts is not None else None
            t1 = int(ts[i, 1]) if ts is not None else None
            yield Record(func=s.name, layer=s.layer, args=args,
                         arg_names=tuple(finfo["arg_names"]), ret=ret,
                         thread=tidx, depth=int(cols.depth[terminal]),
                         t_entry=t0, t_exit=t1, roles=tuple(roles))

    def all_records(self, timestamps: bool = True
                    ) -> Iterator[Tuple[int, Record]]:
        for r in range(self.nranks):
            for rec in self.iter_records(r, timestamps=timestamps):
                yield r, rec


# ---------------------------------------------------------------------------
# incremental view refresh (TraceReader.refresh support)
# ---------------------------------------------------------------------------


def refreshed_view(old_view: TraceView, reader,
                   folds: Sequence[Tuple[Dict[str, Any], int,
                                         Sequence[Tuple[int, int]], Any]]
                   ) -> TraceView:
    """The view of a just-refreshed reader, built by folding ONLY the newly
    committed segments onto ``old_view``'s memoized state.

    ``folds`` holds one ``(data, toff, pairs, seg_store)`` per folded
    segment in epoch order: ``data`` is the segment's decoded payload,
    ``toff`` the CST offset its terminals were spliced at, ``pairs`` the
    fold's unique-CFG provenance (``pairs[new_u] = (old_u, seg_u)``), and
    ``seg_store`` the segment's timestamp store.  Only the new segments'
    CST entries are decoded and only their (delta-sized) grammars are
    walked; every per-unique-CFG memo of ``old_view`` -- terminal counts,
    first/last positions, per-file fold state, DFG digram edges, phase
    segmentation, decompressed timestamps -- is carried forward through
    the provenance map, never re-derived from already-loaded segments.
    """
    cols = old_view.columns
    sigs = list(old_view._sigs)
    counts: Dict[int, Dict[int, int]] = {}
    positions = dict(old_view._positions)
    pfstate: Dict[int, Tuple[Dict[Any, Tuple[int, int]],
                             Dict[int, str]]] = {}
    digrams: Dict[int, Tuple[Dict[Tuple[int, int], int],
                             Optional[int], Optional[int]]] = \
        dict(old_view._digrams)
    phases: Dict[int, List[Dict[str, Any]]] = dict(old_view._phases)
    ts = dict(old_view._ts)
    functions = reader.functions
    first_fold = True
    for data, toff, pairs, seg_store in folds:
        seg_cols = decode_signatures_batch(data["merged_cst"])
        cols = concat_signature_columns(cols, seg_cols)
        sigs.extend(make_sig_info(cols, functions, toff + j)
                    for j in range(len(seg_cols)))
        seg_rules: Dict[int, Any] = {}

        def rules_of(su: int, data=data, seg_rules=seg_rules):
            r = seg_rules.get(su)
            if r is None:
                r = parse_grammar(data["unique_cfgs"][su])
                seg_rules[su] = r
            return r

        new_counts: Dict[int, Dict[int, int]] = {}
        new_positions: Dict[int, Tuple[Dict[int, int],
                                       Dict[int, int]]] = {}
        new_pfstate: Dict[int, Tuple[Dict[Any, Tuple[int, int]],
                                     Dict[int, str]]] = {}
        new_digrams: Dict[int, Tuple[Dict[Tuple[int, int], int],
                                     Optional[int], Optional[int]]] = {}
        new_phases: Dict[int, List[Dict[str, Any]]] = {}
        seg_dfg: Dict[int, Any] = {}
        seg_ph: Dict[int, Any] = {}
        for new_u, (old_u, seg_u) in enumerate(pairs):
            sr = rules_of(seg_u)
            # counts: always seeded (every query family needs them); the
            # old half comes from the old view's memo (computed at most
            # once per old unique CFG, O(|old grammar|), no segment reads)
            oc = old_view.cfg_terminal_counts(old_u) if first_fold \
                else counts[old_u]
            merged = dict(oc)
            for t, c in terminal_counts(sr).items():
                merged[toff + t] = merged.get(toff + t, 0) + c
            new_counts[new_u] = merged
            # positions: seeded only where the old view had them (lazy
            # memo) -- the old terminals' first/last stream positions are
            # unchanged by appending, the segment's shift by the old length
            op = positions.get(old_u)
            if op is not None:
                old_len = sum(oc.values())
                first = dict(op[0])
                last = dict(op[1])
                seg_first, seg_last = terminal_positions(sr)
                for t, p in seg_first.items():
                    first[toff + t] = old_len + p
                for t, p in seg_last.items():
                    last[toff + t] = old_len + p
                new_positions[new_u] = (first, last)
            # per-file attribution: resumable fold -- the segment's stream
            # is evaluated under the old stream's EXIT handle bindings and
            # its contributions added on
            if first_fold:
                pf = old_view._pf_state(old_u) \
                    if (old_u in old_view._pfstate
                        or old_u in old_view._perfile) else None
            else:
                pf = pfstate.get(old_u)
            if pf is not None:
                old_contrib, old_exit = pf
                try:
                    seg_contrib, exit_live = per_file_fold(
                        sr, sigs, cols, old_exit, toff)
                except RecursionError:
                    seg_contrib, exit_live = per_file_fold_linear(
                        sr, sigs, cols, old_exit, toff)
                merged_pf = dict(old_contrib)
                for k, (b, c) in seg_contrib.items():
                    ob, occ = merged_pf.get(k, (0, 0))
                    merged_pf[k] = (ob + b, occ + c)
                new_pfstate[new_u] = (merged_pf, exit_live)
            # DFG / phases: seeded only where the old view had them
            # (lazy memos) -- one DELTA-sized grammar walk per segment,
            # shifted to the splice offset and stitched at the junction
            od = digrams.get(old_u)
            if od is not None:
                sd = seg_dfg.get(seg_u)
                if sd is None:
                    sd = seg_dfg[seg_u] = _dfg.grammar_digrams(rules_of(seg_u))
                new_digrams[new_u] = _dfg.fold_digrams(od, sd, toff)
            op = phases.get(old_u)
            if op is not None:
                sp = seg_ph.get(seg_u)
                if sp is None:
                    sp = seg_ph[seg_u] = _dfg.phase_segments(
                        _dfg.grammar_episodes(
                            rules_of(seg_u),
                            lambda t: sigs[t + toff].name))
                new_phases[new_u] = _dfg.fold_phases(
                    op, sp, sum(oc.values()))
        counts, positions, pfstate = new_counts, new_positions, new_pfstate
        digrams, phases = new_digrams, new_phases
        # timestamps: append the segment's rows to already-decompressed
        # rank memos (untouched ranks stay lazy)
        for r, old_ts in list(ts.items()):
            seg_ts = seg_store.load(r)
            parts = [p for p in (old_ts, seg_ts) if p is not None]
            ts[r] = (parts[0] if len(parts) == 1
                     else np.concatenate(parts, axis=0)) if parts else None
        first_fold = False
    return TraceView(reader, _reuse={
        "columns": cols, "sigs": sigs, "counts": counts,
        "positions": positions, "pfstate": pfstate, "ts": ts,
        "digrams": digrams, "phases": phases})
