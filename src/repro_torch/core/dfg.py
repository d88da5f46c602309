"""Compressed-domain Directly-Follows Graphs, phases, and divergence.

The per-rank trace is a Sequitur grammar (run-length exponents, rule 0 is
the start rule).  Sankaran et al. (arxiv 2408.07378) build a
Directly-Follows Graph -- nodes are operations, a weighted edge (a, b)
counts how often b immediately follows a -- over the *expanded* call
stream to expose phases, loops, and per-process divergence.  Because our
streams are already grammars, the DFG is a pure function of the grammar,
computable in O(|grammar|) with zero record expansion:

:func:`grammar_digrams`
    exact adjacent-pair counts of the expansion.  A rule body's internal
    adjacencies are weighted by the rule's expansion multiplicity
    (``sequitur.rule_weights``); the junction between consecutive items
    uses each item's first/last terminal (a bottom-up DP, like
    ``terminal_positions``); a symbol repeated ``e`` times contributes
    its (last, first) self-junction ``e - 1`` times.  Property-tested
    edge-for-edge identical to :func:`stream_digrams`, the per-record
    reference scan.

:func:`grammar_episodes` / :func:`phase_segments`
    phase segmentation without expansion.  The start rule's item list IS
    the trace's top-level temporal structure: inlining single-use
    (``exp == 1``) rule references yields a stream of *episodes* --
    single calls and repeated loop bodies -- each summarized by its
    record count and per-function profile (a bottom-up per-rule DP).
    Adjacent episodes with the same *dominant function set* merge into
    one phase.  Merging is associative, so an incrementally folded phase
    list (:func:`fold_phases`, used by ``TraceReader.refresh``) is
    value-identical to recomputing over the concatenated grammar.

:func:`project_edges` / :func:`dfg_distance`
    cross-rank comparison.  Terminal ids differ across merged/stitched
    reads and across ranks with irregular offsets, so divergence is
    scored on the (func, pattern-class) *label* projection, where SPMD
    ranks collapse to identical graphs.  ``dfg_distance`` is the total
    variation distance between edge-weight distributions (0 = identical
    shape, 1 = disjoint) -- a graph-edit-style score on weighted edge
    sets that is insensitive to record-count scale.

``TraceView.dfg() / phases() / rank_divergence()`` build on these; the
``traceserve`` query families ``dfg`` / ``phases`` / ``anomalies`` serve
them incrementally (one new epoch = one delta-sized grammar walk).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .sequitur import _topo_order, rule_weights
from .specs import DATA_FUNCS

Edges = Dict[Tuple[int, int], int]

#: default dominance cutoff: a function "dominates" an episode when it
#: accounts for at least this fraction of the episode's records
DOM_FRAC = 0.25

_WRITE_FUNCS = frozenset({"pwrite", "write", "shard_write_at"})
_READ_FUNCS = DATA_FUNCS - _WRITE_FUNCS


# ---------------------------------------------------------------------------
# DFG construction (O(|grammar|), zero expansion)
# ---------------------------------------------------------------------------


def grammar_digrams(rules: List[List[Tuple[int, int]]]
                    ) -> Tuple[Edges, Optional[int], Optional[int]]:
    """``(edges, first, last)`` of a parsed grammar's full expansion.

    ``edges[(a, b)]`` is the exact number of positions where terminal
    ``b`` immediately follows terminal ``a`` in the expanded stream;
    ``first``/``last`` are the stream's boundary terminals (None for an
    empty expansion) -- what :func:`fold_digrams` needs to stitch the
    junction digram when a new epoch segment is appended.

    One bottom-up pass derives each rule's first/last terminal, one
    weighted pass over rule bodies emits the edges: item junctions count
    ``w[rule]`` times, a symbol with exponent ``e`` adds its
    (last, first) self-junction ``w[rule] * (e - 1)`` times, and
    empty-expansion symbols are transparent.  Rule-internal adjacencies
    are NOT re-walked per reference -- they are counted once via the
    referenced rule's own weight.
    """
    if not rules:
        return {}, None, None
    w = rule_weights(rules)
    n = len(rules)
    firsts: List[Optional[int]] = [None] * n
    lasts: List[Optional[int]] = [None] * n
    for i in reversed(_topo_order(rules)):
        f = last = None
        for code, _exp in rules[i]:
            x = code >> 1
            sf, sl = (firsts[x], lasts[x]) if code & 1 else (x, x)
            if sf is None:
                continue
            if f is None:
                f = sf
            last = sl
        firsts[i], lasts[i] = f, last
    edges: Edges = {}
    for i, items in enumerate(rules):
        wi = w[i]
        if not wi:
            continue
        prev_last: Optional[int] = None
        for code, exp in items:
            x = code >> 1
            sf, sl = (firsts[x], lasts[x]) if code & 1 else (x, x)
            if sf is None:
                continue
            if prev_last is not None:
                k = (prev_last, sf)
                edges[k] = edges.get(k, 0) + wi
            if exp > 1:
                k = (sl, sf)
                edges[k] = edges.get(k, 0) + wi * (exp - 1)
            prev_last = sl
    return edges, firsts[0], lasts[0]


def stream_digrams(stream: Iterable[int]) -> Edges:
    """Per-record directly-follows scan of an expanded terminal stream --
    the brute-force reference :func:`grammar_digrams` is property-tested
    against (``tests/test_dfg.py``)."""
    edges: Edges = {}
    prev = None
    for t in stream:
        if prev is not None:
            k = (prev, t)
            edges[k] = edges.get(k, 0) + 1
        prev = t
    return edges


def fold_digrams(old: Tuple[Edges, Optional[int], Optional[int]],
                 seg: Tuple[Edges, Optional[int], Optional[int]],
                 toff: int) -> Tuple[Edges, Optional[int], Optional[int]]:
    """DFG of ``old stream ++ seg stream`` from the parts' DFGs.

    ``seg``'s terminal ids are local to its segment and shifted by
    ``toff`` (the CST splice offset); the single junction digram
    (old last, seg first) is added once.  This is what makes the DFG a
    per-epoch *fold* for ``TraceReader.refresh``: one delta-sized
    grammar walk per new segment, never a rescan of old ones.
    """
    old_e, old_f, old_l = old
    seg_e, seg_f, seg_l = seg
    edges = dict(old_e)
    for (a, b), c in seg_e.items():
        k = (a + toff, b + toff)
        edges[k] = edges.get(k, 0) + c
    if old_l is not None and seg_f is not None:
        k = (old_l, seg_f + toff)
        edges[k] = edges.get(k, 0) + 1
    first = old_f if old_f is not None else (
        None if seg_f is None else seg_f + toff)
    last = old_l if seg_l is None else seg_l + toff
    return edges, first, last


# ---------------------------------------------------------------------------
# label projection + divergence scoring
# ---------------------------------------------------------------------------


def pattern_class(sig) -> str:
    """Offset-encoding class of one call signature: ``plain`` (no
    offset-role slot), ``run`` (an IterPattern -- the call advances
    through an arithmetic offset run), or ``const`` (a fixed or purely
    rank-linear offset).  Rank-symbolic components do NOT change the
    class: SPMD ranks whose offsets differ only by the rank project to
    the same label."""
    if sig.enc is None:
        return "plain"
    return "run" if sig.enc[3] else "const"


def node_label(sig) -> Tuple[str, str]:
    """DFG node identity of a call signature: ``(func, pattern-class)``.
    Coarser than terminal ids (which differ across ranks with irregular
    offsets and across merged/stitched terminal spaces) but fine enough
    to separate e.g. a strided-write loop from a rewind-and-rewrite."""
    return sig.name, pattern_class(sig)


def project_edges(edges: Edges, label_of: Callable[[int], Tuple[str, str]]
                  ) -> Dict[Tuple[Tuple[str, str], Tuple[str, str]], int]:
    """Collapse terminal-level edges onto node labels (weights summed)."""
    out: Dict[Tuple[Tuple[str, str], Tuple[str, str]], int] = {}
    for (a, b), c in edges.items():
        k = (label_of(a), label_of(b))
        out[k] = out.get(k, 0) + c
    return out


def dfg_distance(a: Dict, b: Dict) -> float:
    """Total variation distance between two weighted edge sets' weight
    *distributions*, in [0, 1]: 0 for identically shaped graphs (any
    record-count scale), 1 for edge-disjoint ones.  Two empty graphs are
    identical; empty vs non-empty is maximal."""
    ta, tb = sum(a.values()), sum(b.values())
    if not ta and not tb:
        return 0.0
    if not ta or not tb:
        return 1.0
    keys = set(a) | set(b)
    return 0.5 * sum(abs(a.get(k, 0) / ta - b.get(k, 0) / tb) for k in keys)


# ---------------------------------------------------------------------------
# phase segmentation (episodes from the start rule, no expansion)
# ---------------------------------------------------------------------------


def grammar_episodes(rules: List[List[Tuple[int, int]]],
                     name_of: Callable[[int], str]
                     ) -> List[Tuple[int, Dict[str, int], bool]]:
    """The trace's top-level temporal structure as a list of episodes
    ``(n_records, per-func record counts, is_loop)``.

    The start rule's items are walked in order, inlining ``exp == 1``
    rule references (they are pure sequencing, not repetition); every
    remaining item -- a single terminal or a repeated symbol -- is one
    episode, profiled from a bottom-up per-rule (length, func-count) DP.
    A repeated symbol is atomic (a loop is ONE episode, not per-
    iteration alternation), flagged ``is_loop``.  O(|grammar|) total.

    Because ``sequitur.concat_grammars`` splices the parts' start-rule
    items into the combined start rule (exponents preserved), the
    episode list of a concatenated grammar is exactly the concatenation
    of the parts' episode lists -- the identity :func:`fold_phases`
    builds on.
    """
    if not rules:
        return []
    n = len(rules)
    lengths = [0] * n
    profiles: List[Dict[str, int]] = [{} for _ in range(n)]
    for i in reversed(_topo_order(rules)):
        ln = 0
        prof: Dict[str, int] = {}
        for code, exp in rules[i]:
            x = code >> 1
            if code & 1:
                ln += exp * lengths[x]
                for f, c in profiles[x].items():
                    prof[f] = prof.get(f, 0) + exp * c
            else:
                ln += exp
                f = name_of(x)
                prof[f] = prof.get(f, 0) + exp
        lengths[i] = ln
        profiles[i] = prof
    episodes: List[Tuple[int, Dict[str, int], bool]] = []
    # iterative inline walk of the start rule (no recursion limit)
    stack: List[Tuple[List[Tuple[int, int]], int]] = [(rules[0], 0)]
    while stack:
        items, idx = stack.pop()
        while idx < len(items):
            code, exp = items[idx]
            idx += 1
            x = code >> 1
            if code & 1:
                if exp == 1:
                    stack.append((items, idx))
                    items, idx = rules[x], 0
                    continue
                if lengths[x]:
                    episodes.append((exp * lengths[x],
                                     {f: exp * c
                                      for f, c in profiles[x].items()},
                                     True))
            else:
                episodes.append((exp, {name_of(x): exp}, exp > 1))
    return episodes


def _dominant(counts: Dict[str, int], n_records: int,
              dom_frac: float) -> frozenset:
    cut = dom_frac * n_records
    dom = frozenset(f for f, c in counts.items() if c >= cut)
    if dom:
        return dom
    top = max(counts.values())
    return frozenset(f for f, c in counts.items() if c == top)


def phase_segments(episodes: List[Tuple[int, Dict[str, int], bool]],
                   dom_frac: float = DOM_FRAC) -> List[Dict]:
    """Cut the episode stream where the dominant function set shifts.

    Adjacent episodes sharing one dominant set D merge into a phase
    whose dominant set IS D (the shared set, not recomputed from the
    summed profile) -- that definition makes the merge associative, so
    folding per-epoch phase lists (:func:`fold_phases`) equals
    segmenting the whole stream at once.  Raw phase rows carry
    ``start``/``end`` (record positions, end exclusive), the dominant
    frozenset, the summed ``func_counts``, ``n_episodes`` and a loop
    flag; :func:`phase_report` turns them into the public shape.
    """
    phases: List[Dict] = []
    pos = 0
    for n_rec, counts, loop in episodes:
        if not n_rec:
            continue
        dom = _dominant(counts, n_rec, dom_frac)
        prev = phases[-1] if phases else None
        if prev is not None and prev["dominant"] == dom:
            prev["end"] = pos + n_rec
            for f, c in counts.items():
                prev["func_counts"][f] = prev["func_counts"].get(f, 0) + c
            prev["n_episodes"] += 1
            prev["loop"] = prev["loop"] or loop
        else:
            phases.append({"start": pos, "end": pos + n_rec,
                           "dominant": dom, "func_counts": dict(counts),
                           "n_episodes": 1, "loop": loop})
        pos += n_rec
    return phases


def fold_phases(old: List[Dict], seg: List[Dict], base: int) -> List[Dict]:
    """Phase list of ``old stream ++ seg stream`` from the parts' lists.

    ``seg``'s record positions are shifted by ``base`` (the old stream's
    record count); the single boundary pair merges when its dominant
    sets are equal -- by associativity of the :func:`phase_segments`
    merge this is value-identical to re-segmenting the concatenated
    episode stream.  Inputs are not mutated.
    """
    out = [dict(p, func_counts=dict(p["func_counts"])) for p in old]
    for p in seg:
        row = dict(p, start=p["start"] + base, end=p["end"] + base,
                   func_counts=dict(p["func_counts"]))
        prev = out[-1] if out else None
        if prev is not None and prev["dominant"] == row["dominant"]:
            prev["end"] = row["end"]
            for f, c in row["func_counts"].items():
                prev["func_counts"][f] = prev["func_counts"].get(f, 0) + c
            prev["n_episodes"] += row["n_episodes"]
            prev["loop"] = prev["loop"] or row["loop"]
        else:
            out.append(row)
    return out


def phase_label(dominant: frozenset, loop: bool) -> str:
    """Human label of a phase from its dominant functions: ``write`` /
    ``read`` / ``data`` (mixed directions) when every dominant call
    moves data, ``metadata`` when none does, ``mixed`` otherwise; a
    ``-loop`` suffix marks repeated structure."""
    if dominant <= _WRITE_FUNCS:
        base = "write"
    elif dominant <= _READ_FUNCS:
        base = "read"
    elif dominant <= DATA_FUNCS:
        base = "data"
    elif not dominant & DATA_FUNCS:
        base = "metadata"
    else:
        base = "mixed"
    return base + "-loop" if loop else base


def phase_report(phases: List[Dict]) -> List[Dict]:
    """JSON-friendly public rows for a raw :func:`phase_segments` list:
    ``[(start_record, end_record, dominant_funcs, label), ...]`` plus
    record/episode counts and the loop flag."""
    return [{
        "start_record": p["start"],
        "end_record": p["end"],
        "n_records": p["end"] - p["start"],
        "n_episodes": p["n_episodes"],
        "dominant_funcs": sorted(p["dominant"]),
        "label": phase_label(p["dominant"], p["loop"]),
        "loop": p["loop"],
    } for p in phases]
