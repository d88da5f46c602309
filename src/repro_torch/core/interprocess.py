"""Inter-process I/O pattern recognition and compression (paper §3.2.2, §3.3).

At finalization each rank holds a local CST and CFG that are *almost*
identical across ranks: only rank-dependent offsets differ.  The inter-process
pass

  1. groups CST entries whose signatures are identical once OFFSET-role
     values are masked,
  2. within each group matches the k-th occurrence of every rank and checks
     whether each offset component is linear in the rank, ``v_r = r*a + b``
     (components of an ``IterPattern`` are checked separately, paper Fig 3c),
  3. rewrites matching entries into one shared signature containing
     ``RankPattern`` values, producing a single **merged CST**,
  4. remaps every rank's CFG terminals and deduplicates identical CFGs
     (paper Fig 3d: unique-CFGs file + CFG-index file + merged-CST file).

Two finalize topologies are provided:

``flat``
    The original gather-at-root pass: every rank's CST/CFG lands on rank 0
    and :func:`finalize_ranks` runs the three passes above over all ranks at
    once.  O(ranks x calls) work on a single process; kept as the bit-compat
    reference and for tiny worlds.

``tree`` (default in :class:`~repro.core.recorder.RecorderConfig`)
    A hierarchical reduction.  Each rank builds a compact
    :class:`RankState` from its local CST/CFG (:func:`make_rank_state`);
    adjacent *contiguous* rank blocks are then merged pairwise
    (:func:`merge_rank_states`) in O(log N) rounds -- through
    ``Comm.reduce_tree`` on real runs, or :func:`tree_reduce_states` on
    simulated rank lists.  A merged state keeps, per masked-signature
    occurrence group, either an exact *linear summary* (base + slope per
    offset slot, O(1) per group regardless of block size) or -- only once
    linearity is broken -- the explicit per-rank offsets.  Identical
    per-rank terminal streams are deduplicated inside the state, so for
    SPMD workloads the state size is constant in the number of ranks.
    :func:`materialize_state` finally emits a merged CST + deduped CFGs
    that are **byte-identical** to the flat pass (property-tested in
    ``tests/test_tree_finalize.py``).  States serialize to stable bytes
    (:func:`serialize_rank_state`) for transport between tree hops.

    One documented divergence: offset leaves that are not plain ``int``s
    (e.g. ``bool``) are never rank-fitted by the tree path, while the flat
    pass coerces them through ``int()``.  The runtime record path coerces
    offsets to ``int`` before encoding, so real traces are unaffected.

Rank-linear fitting is available in two modes: ``python`` (the original
per-occurrence scalar loop) and ``vectorized`` (default; NumPy batched
slope/intercept fitting over every candidate column at once,
:func:`batch_fit_columns`).  Both produce identical results; the benchmark
``benchmarks/ior_pattern.py::finalize_scaling`` sweeps topology x fit mode.

All functions here are pure (lists in, lists out); the SPMD wrapper in
``recorder.py`` moves data through a ``Comm``, and the benchmark drivers call
these directly on simulated rank states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .encoding import (IterPattern, RankPattern, decode_signature,
                       decode_value, encode_signature, encode_value,
                       read_blob, read_uvarint, write_blob, write_uvarint)
from .sequitur import remap_grammar
from .specs import FunctionRegistry, Role

_MASK = "MASK"  # private-use sentinel replacing masked offset leaves


# ---------------------------------------------------------------------------
# signature masking
# ---------------------------------------------------------------------------


def _split_offsets(registry: FunctionRegistry, sig: bytes):
    """Decode ``sig`` and pull out OFFSET-role values (args and, for
    OFFSET-role returns such as lseek's, the return value).

    Returns (func_id, tid, depth, masked_args, ret, offsets, ret_masked);
    masked positions are replaced by the mask sentinel, and a masked return
    contributes the *last* element of ``offsets``.
    """
    func_id, tid, depth, args, ret = decode_signature(sig)
    spec = registry.spec(func_id)
    off_pos = spec.offset_positions
    offsets = [args[i] for i in off_pos if i < len(args)]
    masked = tuple(_MASK if i in off_pos else v for i, v in enumerate(args))
    ret_masked = (spec.ret_role == Role.OFFSET
                  and isinstance(ret, (int, IterPattern)))
    if ret_masked:
        offsets.append(ret)
    return func_id, tid, depth, masked, ret, tuple(offsets), ret_masked


def _masked_bytes(func_id: int, tid: int, depth: int, masked: tuple, ret: Any,
                  ret_masked: bool) -> bytes:
    return encode_signature(func_id, tid, depth, masked,
                            _MASK if ret_masked else ret)


# ---------------------------------------------------------------------------
# rank-linear fitting (scalar + vectorized)
# ---------------------------------------------------------------------------


def _fit_component(values: Sequence[int]) -> Optional[Any]:
    """Fit ``v_r = r*a + b`` over ranks; int if constant, RankPattern if
    linear with a != 0, None if not linear."""
    v0 = values[0]
    if all(v == v0 for v in values):
        return int(v0)
    if len(values) < 2:
        return None
    a = values[1] - values[0]
    if a == 0:
        return None
    for r, v in enumerate(values):
        if v != v0 + r * a:
            return None
    return RankPattern(a, v0)


# offsets larger than this cannot be diffed safely in int64
_I64_SAFE = 1 << 62


def batch_fit_columns(columns: List[Sequence[int]],
                      backend: Optional[str] = None) -> List[Optional[Any]]:
    """Vectorized :func:`_fit_component` over many equal-length columns.

    One pass classifies every column as constant (-> int), exactly
    rank-linear with nonzero slope (-> RankPattern) or neither (-> None).
    ``backend`` picks the classifier (``encode_backend.fit_classify``:
    NumPy, or one ``fit_columns`` kernel call over the matrix); results are
    identical.  Falls back to the scalar loop when values do not fit
    safely in int64.
    """
    if not columns:
        return []
    try:
        V = np.asarray(columns, dtype=np.int64)
    except (OverflowError, ValueError, TypeError):
        return [_fit_component(c) for c in columns]
    if V.ndim != 2 or np.abs(V).max(initial=0) >= _I64_SAFE:
        return [_fit_component(c) for c in columns]
    if V.shape[1] < 2:
        return [int(c[0]) for c in columns]
    from . import encode_backend as _eb
    eff = _eb.resolve(backend, V.size)
    if eff == "python":
        return [_fit_component(c) for c in columns]
    const, linear, d0 = _eb.fit_classify(V, eff)
    d = d0[:, None]  # only d[:, 0] is consumed below
    out: List[Optional[Any]] = []
    for i in range(V.shape[0]):
        if const[i]:
            out.append(int(V[i, 0]))
        elif linear[i]:
            out.append(RankPattern(int(d[i, 0]), int(V[i, 0])))
        else:
            out.append(None)
    return out


def _fit_offsets(per_rank: List[tuple]) -> Optional[tuple]:
    """Fit each offset slot across ranks.  ``per_rank[r]`` is the tuple of
    offset values of rank r for this occurrence.  Values are ints or
    IterPattern with int components."""
    n_slots = len(per_rank[0])
    if any(len(v) != n_slots for v in per_rank):
        return None
    out = []
    for s in range(n_slots):
        col = [pr[s] for pr in per_rank]
        if all(isinstance(v, int) for v in col):
            fit = _fit_component(col)  # type: ignore[arg-type]
            if fit is None:
                return None
            out.append(fit)
        elif all(isinstance(v, IterPattern) for v in col):
            a_fit = _fit_component([int(v.a) for v in col])  # type: ignore[union-attr]
            b_fit = _fit_component([int(v.b) for v in col])  # type: ignore[union-attr]
            if a_fit is None or b_fit is None:
                return None
            out.append(IterPattern(a_fit, b_fit))
        else:
            return None  # mixed kinds across ranks: no merge
    return tuple(out)


def _fit_offsets_batch(all_per_rank: List[List[tuple]],
                       backend: Optional[str] = None
                       ) -> List[Optional[tuple]]:
    """Batched :func:`_fit_offsets`: gather every int / IterPattern-component
    column from every candidate group, fit them in one vectorized pass, then
    reassemble per-group fits.  Result-equivalent to the scalar path."""
    columns: List[List[int]] = []
    plans: List[Optional[List[tuple]]] = []
    for per_rank in all_per_rank:
        n_slots = len(per_rank[0])
        if any(len(v) != n_slots for v in per_rank):
            plans.append(None)
            continue
        desc: List[tuple] = []
        ok = True
        for s in range(n_slots):
            col = [pr[s] for pr in per_rank]
            if all(isinstance(v, int) for v in col):
                desc.append(("i", len(columns)))
                columns.append(col)  # type: ignore[arg-type]
            elif all(isinstance(v, IterPattern) for v in col):
                ia = len(columns)
                columns.append([int(v.a) for v in col])  # type: ignore[union-attr]
                ib = len(columns)
                columns.append([int(v.b) for v in col])  # type: ignore[union-attr]
                desc.append(("p", ia, ib))
            else:
                ok = False
                break
        plans.append(desc if ok else None)
    col_fits = batch_fit_columns(columns, backend=backend)
    out: List[Optional[tuple]] = []
    for plan in plans:
        if plan is None:
            out.append(None)
            continue
        fit: List[Any] = []
        for d in plan:
            if d[0] == "i":
                f = col_fits[d[1]]
                if f is None:
                    fit = []
                    break
                fit.append(f)
            else:
                fa, fb = col_fits[d[1]], col_fits[d[2]]
                if fa is None or fb is None:
                    fit = []
                    break
                fit.append(IterPattern(fa, fb))
        out.append(tuple(fit) if fit else None)
    return out


# ---------------------------------------------------------------------------
# arithmetic-run segmentation (the vectorized-fitting building block shared
# with patterns.IntraPatternTracker.encode_many, which imports it)
# ---------------------------------------------------------------------------


def arith_segments(V: np.ndarray,
                   backend: Optional[str] = None) -> List[Tuple[int, int]]:
    """Greedy arithmetic-run segmentation of a (n, k) value matrix.

    Returns half-open ``(start, end)`` element segments such that within a
    segment every consecutive row difference equals the segment's first
    difference (the run stride), mirroring the streaming protocol of
    ``IntraPatternTracker``: a run's stride is set by its second element and
    the run breaks at the first non-matching row.  ``backend`` dispatches
    the change-point scan (``encode_backend.run_boundaries`` over the diff
    rows); segmentation is identical across backends.
    """
    n = len(V)
    if n == 0:
        return []
    if n == 1:
        return [(0, 1)]
    d = V[1:] - V[:-1]
    if d.ndim == 1:
        d = d[:, None]
    # cp[j] for j >= 1: diff j differs from diff j-1
    from . import encode_backend as _eb
    mask = _eb.run_boundaries(d, backend)
    mask[0] = False  # position 0 is forced True by the boundary op
    cp = np.flatnonzero(mask)
    segs: List[Tuple[int, int]] = []
    s = 0
    while s < n:
        if s >= n - 1:
            segs.append((s, n))
            break
        # largest run of equal diffs starting at diff index s
        k = int(np.searchsorted(cp, s, side="right"))
        c = int(cp[k]) if k < len(cp) else n - 1
        segs.append((s, c + 1))
        s = c + 1
    return segs


# ---------------------------------------------------------------------------
# CST merge (flat topology)
# ---------------------------------------------------------------------------


@dataclass
class MergeResult:
    merged_entries: List[bytes]          # the merged CST, terminal order
    remaps: List[Dict[int, int]]         # per rank: old terminal -> new
    n_rank_patterns: int                 # how many entries used RankPattern


def merge_csts(rank_csts: List[List[bytes]], registry: FunctionRegistry,
               inter_patterns: bool = True, fit_mode: str = "vectorized"
               ) -> MergeResult:
    """Merge per-rank CSTs into one (paper §3.3.1).

    ``fit_mode`` selects the rank-linear fitter: ``"python"`` (per-group
    scalar loop), ``"vectorized"`` (batch, on the module-default encode
    backend) or ``"cuda"`` (the ``kernels/delta_encode`` column-fit kernel).
    Output is identical across modes.
    """
    nranks = len(rank_csts)
    # -- pass 1: decode + group by (masked signature, occurrence index) ------
    decoded: List[List[tuple]] = []        # [rank][t] = (masked_key, parts)
    groups: Dict[Tuple[bytes, int], Dict[int, tuple]] = {}
    group_order: List[Tuple[bytes, int]] = []
    for r, cst in enumerate(rank_csts):
        occ_counter: Dict[bytes, int] = {}
        rank_rows = []
        for t, sig in enumerate(cst):
            (func_id, tid, depth, masked, ret, offsets,
             ret_masked) = _split_offsets(registry, sig)
            mkey = _masked_bytes(func_id, tid, depth, masked, ret, ret_masked)
            j = occ_counter.get(mkey, 0)
            occ_counter[mkey] = j + 1
            gkey = (mkey, j)
            g = groups.get(gkey)
            if g is None:
                g = {}
                groups[gkey] = g
                group_order.append(gkey)
            g[r] = (t, offsets)
            rank_rows.append((gkey, (func_id, tid, depth, masked, ret,
                                     offsets, ret_masked)))
        decoded.append(rank_rows)

    # -- pass 2: fit rank-linear groups --------------------------------------
    merged_offsets: Dict[Tuple[bytes, int], tuple] = {}
    n_rank_patterns = 0
    if inter_patterns and nranks > 1:
        candidates: List[Tuple[Tuple[bytes, int], List[tuple]]] = []
        for gkey in group_order:
            g = groups[gkey]
            if len(g) != nranks:
                continue  # not present on every rank: no fit (paper: collective I/O case)
            per_rank = [g[r][1] for r in range(nranks)]
            if not per_rank[0]:
                continue  # no offset args: identical signatures merge by interning
            candidates.append((gkey, per_rank))
        if fit_mode == "python":
            fits = [_fit_offsets(pr) for _, pr in candidates]
        else:
            fits = _fit_offsets_batch(
                [pr for _, pr in candidates],
                backend="cuda" if fit_mode == "cuda" else None)
        for (gkey, _), fit in zip(candidates, fits):
            if fit is not None:
                merged_offsets[gkey] = fit
                if _fit_has_rank_pattern(fit):
                    n_rank_patterns += 1

    # -- pass 3: build merged table + per-rank remaps ------------------------
    table: Dict[bytes, int] = {}
    merged_entries: List[bytes] = []
    remaps: List[Dict[int, int]] = [dict() for _ in range(nranks)]

    def intern(sig: bytes) -> int:
        t = table.get(sig)
        if t is None:
            t = len(merged_entries)
            table[sig] = t
            merged_entries.append(sig)
        return t

    for r, rank_rows in enumerate(decoded):
        for old_t, (gkey, parts) in enumerate(rank_rows):
            func_id, tid, depth, masked, ret, offsets, ret_masked = parts
            fit = merged_offsets.get(gkey)
            use_offsets = fit if fit is not None else offsets
            it = iter(use_offsets)
            args = tuple(next(it) if v is _MASK else v for v in masked)
            if ret_masked:
                ret = next(it)
            sig = encode_signature(func_id, tid, depth, args, ret)
            remaps[r][old_t] = intern(sig)

    return MergeResult(merged_entries=merged_entries, remaps=remaps,
                       n_rank_patterns=n_rank_patterns)


def _fit_has_rank_pattern(fit: tuple) -> bool:
    return any(isinstance(v, RankPattern) or
               (isinstance(v, IterPattern) and
                (isinstance(v.a, RankPattern) or isinstance(v.b, RankPattern)))
               for v in fit)


# ---------------------------------------------------------------------------
# CFG remap + dedupe
# ---------------------------------------------------------------------------


@dataclass
class CfgResult:
    unique_cfgs: List[bytes]
    cfg_index: List[int]  # per rank, index into unique_cfgs


def dedupe_cfgs(rank_cfgs: List[bytes]) -> CfgResult:
    """Keep one copy of each distinct CFG (paper §3.3.2)."""
    table: Dict[bytes, int] = {}
    unique: List[bytes] = []
    index: List[int] = []
    for buf in rank_cfgs:
        i = table.get(buf)
        if i is None:
            i = len(unique)
            table[buf] = i
            unique.append(buf)
        index.append(i)
    return CfgResult(unique_cfgs=unique, cfg_index=index)


def finalize_ranks(rank_csts: List[List[bytes]], rank_cfgs: List[bytes],
                   registry: FunctionRegistry, inter_patterns: bool = True,
                   fit_mode: str = "vectorized"
                   ) -> Tuple[MergeResult, CfgResult]:
    """The full root-side FLAT finalization: merge CSTs, remap CFGs, dedupe.

    This is the pure core shared by the SPMD path (``Recorder.finalize``
    with ``finalize_topology="flat"``) and the simulated-rank drivers in
    benchmarks/tests.  See :func:`tree_finalize_ranks` for the scalable
    topology that produces byte-identical output.
    """
    merge = merge_csts(rank_csts, registry, inter_patterns=inter_patterns,
                       fit_mode=fit_mode)
    remapped = [remap_grammar(cfg, merge.remaps[r])
                for r, cfg in enumerate(rank_cfgs)]
    cfgs = dedupe_cfgs(remapped)
    return merge, cfgs


# ---------------------------------------------------------------------------
# tree topology: incremental rank states
# ---------------------------------------------------------------------------
#
# A RankState summarizes the CST/CFG of a *contiguous block* of ranks
# [base, base + n).  Per masked-signature occurrence group it keeps either
#
#   lin  an exact linear summary: per offset slot, (value at local rank 0,
#        slope per rank).  Present iff the group occurs on every rank of the
#        block, slot kinds/arities agree, and every slot is exactly linear
#        in the local rank index.  O(1) per group regardless of block size.
#   raw  explicit {global_rank: offsets} for groups whose linearity (or
#        full presence) is broken.  This is the only part that can grow
#        with the block size -- exactly the entries the flat merge would
#        keep per-rank anyway.
#
# Per-rank terminal streams (the CFG bytes plus the per-terminal group-key
# sequence) are deduplicated inside the state, so N identical SPMD ranks
# cost one stream, not N.


# per-slot linear summaries:
#   ("i", v0, slope)                      plain-int slot
#   ("p", (a0, sa), (b0, sb))             IterPattern slot, per component
# a slope of None means "undetermined" (single-rank block).


@dataclass
class _Group:
    parts: tuple                 # (func_id, tid, depth, masked, ret, ret_masked)
    count: int                   # ranks of the block where the group occurs
    lin: Optional[tuple]         # per-slot linear summaries, or None
    raw: Optional[Dict[int, tuple]]  # global rank -> offsets (when lin dead)


@dataclass
class RankState:
    base: int                    # first global rank covered
    n: int                       # number of contiguous ranks covered
    groups: Dict[Tuple[bytes, int], _Group]
    streams: List[Tuple[bytes, tuple]]   # unique (cfg bytes, per-terminal gkeys)
    stream_of: List[int]         # per local rank -> index into streams


def _leaf_lin(offsets: tuple) -> Optional[tuple]:
    """Single-rank linear summary; None when any leaf is not fit-eligible."""
    slots = []
    for v in offsets:
        if type(v) is int:
            slots.append(("i", v, None))
        elif (isinstance(v, IterPattern) and type(v.a) is int
              and type(v.b) is int):
            slots.append(("p", (v.a, None), (v.b, None)))
        else:
            return None
    return tuple(slots)


def make_rank_state(rank: int, cst: List[bytes], cfg: bytes,
                    registry: FunctionRegistry) -> RankState:
    """Build the leaf state for one rank from its local CST and CFG."""
    rows: List[Tuple[bytes, int]] = []
    occ_counter: Dict[bytes, int] = {}
    groups: Dict[Tuple[bytes, int], _Group] = {}
    for sig in cst:
        (func_id, tid, depth, masked, ret, offsets,
         ret_masked) = _split_offsets(registry, sig)
        mkey = _masked_bytes(func_id, tid, depth, masked, ret, ret_masked)
        j = occ_counter.get(mkey, 0)
        occ_counter[mkey] = j + 1
        gkey = (mkey, j)
        rows.append(gkey)
        # a masked return is rewritten from the offsets at materialize time,
        # so normalize it out of the shared parts (determinism across ranks)
        parts = (func_id, tid, depth, masked,
                 None if ret_masked else ret, ret_masked)
        lin = _leaf_lin(offsets)
        groups[gkey] = _Group(parts=parts, count=1, lin=lin,
                              raw=None if lin is not None else {rank: offsets})
    return RankState(base=rank, n=1, groups=groups,
                     streams=[(cfg, tuple(rows))], stream_of=[0])


def _combine_comp(v0: int, sl: Optional[int], nl: int,
                  w0: int, sr: Optional[int], nr: int
                  ) -> Optional[Tuple[int, int]]:
    """Combine two exact-linear component summaries over adjacent blocks of
    sizes nl / nr; returns (v0, slope) for the combined block or None."""
    if nl == 1 and nr == 1:
        return (v0, w0 - v0)
    if nl == 1:                               # sr determined (nr > 1)
        return (v0, sr) if w0 - v0 == sr else None
    if nr == 1:                               # sl determined (nl > 1)
        return (v0, sl) if w0 == v0 + nl * sl else None
    if sl == sr and w0 == v0 + nl * sl:
        return (v0, sl)
    return None


def _combine_lin(ll: tuple, lr: tuple, nl: int, nr: int) -> Optional[tuple]:
    out = []
    for sl_l, sl_r in zip(ll, lr):
        if sl_l[0] != sl_r[0]:
            return None
        if sl_l[0] == "i":
            c = _combine_comp(sl_l[1], sl_l[2], nl, sl_r[1], sl_r[2], nr)
            if c is None:
                return None
            out.append(("i", c[0], c[1]))
        else:
            ca = _combine_comp(sl_l[1][0], sl_l[1][1], nl,
                               sl_r[1][0], sl_r[1][1], nr)
            cb = _combine_comp(sl_l[2][0], sl_l[2][1], nl,
                               sl_r[2][0], sl_r[2][1], nr)
            if ca is None or cb is None:
                return None
            out.append(("p", ca, cb))
    return tuple(out)


def _lin_values(lin: tuple, j: int) -> tuple:
    """Materialize the offsets tuple of local rank ``j`` from a summary."""
    out = []
    for slot in lin:
        if slot[0] == "i":
            out.append(slot[1] + j * (slot[2] or 0))
        else:
            (a0, sa), (b0, sb) = slot[1], slot[2]
            out.append(IterPattern(a0 + j * (sa or 0), b0 + j * (sb or 0)))
    return tuple(out)


def _explode(g: _Group, state: RankState) -> Dict[int, tuple]:
    """Per-rank offsets of a group (reconstructed from the summary when
    linear -- exact by the lin invariant)."""
    if g.raw is not None:
        return dict(g.raw)
    return {state.base + j: _lin_values(g.lin, j) for j in range(state.n)}


def merge_rank_states(left: RankState, right: RankState) -> RankState:
    """Merge two already-merged states over ADJACENT contiguous rank blocks.

    O(groups + broken-group ranks) per call; the reduction driver applies it
    pairwise in O(log N) rounds.  Associativity over contiguous splits makes
    the result independent of pairing order, so the threaded collective and
    the sequential simulator produce identical states.
    """
    if left.base + left.n != right.base:
        raise ValueError(
            f"merge_rank_states requires adjacent blocks, got "
            f"[{left.base},{left.base + left.n}) + "
            f"[{right.base},{right.base + right.n})")
    groups: Dict[Tuple[bytes, int], _Group] = {}
    for gkey, gl in left.groups.items():
        gr = right.groups.get(gkey)
        if gr is None:
            groups[gkey] = _Group(gl.parts, gl.count, None, _explode(gl, left))
            continue
        count = gl.count + gr.count
        lin = None
        if (gl.lin is not None and gr.lin is not None
                and len(gl.lin) == len(gr.lin)):
            lin = _combine_lin(gl.lin, gr.lin, left.n, right.n)
        if lin is not None:
            groups[gkey] = _Group(gl.parts, count, lin, None)
        else:
            raw = _explode(gl, left)
            raw.update(_explode(gr, right))
            groups[gkey] = _Group(gl.parts, count, None, raw)
    for gkey, gr in right.groups.items():
        if gkey not in left.groups:
            groups[gkey] = _Group(gr.parts, gr.count, None,
                                  _explode(gr, right))
    # streams: keep left's unique streams, append right's unseen ones
    streams = list(left.streams)
    stream_table = {s: i for i, s in enumerate(streams)}
    right_remap = []
    for s in right.streams:
        i = stream_table.get(s)
        if i is None:
            i = len(streams)
            stream_table[s] = i
            streams.append(s)
        right_remap.append(i)
    stream_of = list(left.stream_of) + [right_remap[i]
                                        for i in right.stream_of]
    return RankState(base=left.base, n=left.n + right.n, groups=groups,
                     streams=streams, stream_of=stream_of)


def tree_reduce_states(states: List[RankState]) -> RankState:
    """Reduce adjacent states pairwise until one remains (O(log N) rounds)."""
    if not states:
        raise ValueError("no states to reduce")
    while len(states) > 1:
        nxt = []
        for i in range(0, len(states), 2):
            if i + 1 < len(states):
                nxt.append(merge_rank_states(states[i], states[i + 1]))
            else:
                nxt.append(states[i])
        states = nxt
    return states[0]


def _finalize_slot(slot: tuple) -> Any:
    if slot[0] == "i":
        a = slot[2] or 0
        return int(slot[1]) if a == 0 else RankPattern(a, slot[1])
    (a0, sa), (b0, sb) = slot[1], slot[2]
    a_fit = int(a0) if (sa or 0) == 0 else RankPattern(sa, a0)
    b_fit = int(b0) if (sb or 0) == 0 else RankPattern(sb, b0)
    return IterPattern(a_fit, b_fit)


def _final_fits(state: RankState) -> Dict[Tuple[bytes, int], tuple]:
    """Fits for every fully-present, still-linear group of the root state.

    The heavy per-rank column fitting already happened incrementally
    during the merges (each group carries an O(1) linear summary), so the
    root only classifies slopes -- O(groups) regardless of fit mode.
    """
    nranks = state.n
    return {gkey: tuple(_finalize_slot(s) for s in g.lin)
            for gkey, g in state.groups.items()
            if g.lin is not None and g.count == nranks and g.lin}


def _build_sig(parts: tuple, offsets: tuple) -> bytes:
    func_id, tid, depth, masked, ret, ret_masked = parts
    it = iter(offsets)
    args = tuple(next(it) if v is _MASK else v for v in masked)
    if ret_masked:
        ret = next(it)
    return encode_signature(func_id, tid, depth, args, ret)


def _values_for_rank(g: _Group, state: RankState, rank: int) -> tuple:
    if g.raw is not None:
        return g.raw[rank]
    return _lin_values(g.lin, rank - state.base)


def materialize_state(state: RankState, inter_patterns: bool = True,
                      fit_mode: str = "vectorized",
                      cache_streams: bool = True
                      ) -> Tuple[MergeResult, CfgResult]:
    """Emit the merged CST + deduped CFGs from a fully-reduced state.

    Byte-identical to :func:`finalize_ranks` on the same rank data: the
    intern pass walks ranks in order and terminals in stream order, exactly
    like the flat pass 3.  Streams whose groups all materialize to
    rank-independent signatures are interned once and their remap reused,
    which makes this O(unique streams + ranks) for SPMD workloads.
    Near-uniform streams (a few rank-dependent rows in an otherwise
    uniform stream) share the uniform rows' remap too: later ranks copy it
    and re-sign only the irregular rows.  Both reuses preserve the flat
    pass's intern order exactly -- a uniform row's intern at a later rank
    is always a table hit, so skipping it cannot shift terminal ids
    (property-tested cached vs uncached in ``tests/test_interprocess.py``).

    ``cache_streams=False`` disables both reuses (every rank walks every
    row) -- the reference path the property tests compare against.

    ``fit_mode`` is accepted for API symmetry with :func:`finalize_ranks`
    but does not change the work done here: tree fitting happens
    incrementally during the merges, so materialization is
    fit-mode-independent (the benchmark sweep reports both labels).
    """
    del fit_mode
    nranks = state.n
    merged_offsets: Dict[Tuple[bytes, int], tuple] = {}
    n_rank_patterns = 0
    if inter_patterns and nranks > 1:
        merged_offsets = _final_fits(state)
        for fit in merged_offsets.values():
            if _fit_has_rank_pattern(fit):
                n_rank_patterns += 1

    table: Dict[bytes, int] = {}
    merged_entries: List[bytes] = []

    def intern(sig: bytes) -> int:
        t = table.get(sig)
        if t is None:
            t = len(merged_entries)
            table[sig] = t
            merged_entries.append(sig)
        return t

    # a group's signature is rank-independent when it is fitted, or when its
    # linear summary has zero slope everywhere (identical values on every
    # rank); such signatures are computed once
    _NOT_UNIFORM = object()
    uniform_cache: Dict[Tuple[bytes, int], Any] = {}

    def uniform_sig(gkey: Tuple[bytes, int], g: _Group) -> Any:
        got = uniform_cache.get(gkey, _NOT_UNIFORM)
        if got is not _NOT_UNIFORM:
            return got
        fit = merged_offsets.get(gkey)
        if fit is not None:
            sig: Any = _build_sig(g.parts, fit)
        elif g.lin is not None and all(
                (s[2] or 0) == 0 if s[0] == "i"
                else ((s[1][1] or 0) == 0 and (s[2][1] or 0) == 0)
                for s in g.lin):
            sig = _build_sig(g.parts, _lin_values(g.lin, 0))
        else:
            sig = None
        uniform_cache[gkey] = sig
        return sig

    stream_cache: Dict[int, Tuple[Dict[int, int], bytes]] = {}
    # near-uniform streams: the first rank's remap plus which rows are
    # rank-dependent; later ranks copy the remap and re-sign only those
    partial_cache: Dict[int, Tuple[Dict[int, int], List[int]]] = {}
    remaps: List[Dict[int, int]] = []
    remapped_cfgs: List[bytes] = []
    for j in range(nranks):
        si = state.stream_of[j]
        cached = stream_cache.get(si) if cache_streams else None
        if cached is not None:
            remaps.append(cached[0])
            remapped_cfgs.append(cached[1])
            continue
        cfg_bytes, rows = state.streams[si]
        part = partial_cache.get(si) if cache_streams else None
        if part is not None:
            base_remap, irr_rows = part
            remap = dict(base_remap)
            for old_t in irr_rows:
                g = state.groups[rows[old_t]]
                remap[old_t] = intern(_build_sig(
                    g.parts, _values_for_rank(g, state, state.base + j)))
            remaps.append(remap)
            remapped_cfgs.append(remap_grammar(cfg_bytes, remap))
            continue
        remap = {}
        irr_rows = []
        for old_t, gkey in enumerate(rows):
            g = state.groups[gkey]
            sig = uniform_sig(gkey, g)
            if sig is None:
                irr_rows.append(old_t)
                sig = _build_sig(g.parts,
                                 _values_for_rank(g, state, state.base + j))
            remap[old_t] = intern(sig)
        remapped = remap_grammar(cfg_bytes, remap)
        if not irr_rows:
            stream_cache[si] = (remap, remapped)
        else:
            partial_cache[si] = (remap, irr_rows)
        remaps.append(remap)
        remapped_cfgs.append(remapped)

    merge = MergeResult(merged_entries=merged_entries, remaps=remaps,
                        n_rank_patterns=n_rank_patterns)
    return merge, dedupe_cfgs(remapped_cfgs)


def tree_finalize_ranks(rank_csts: List[List[bytes]], rank_cfgs: List[bytes],
                        registry: FunctionRegistry,
                        inter_patterns: bool = True,
                        fit_mode: str = "vectorized"
                        ) -> Tuple[MergeResult, CfgResult]:
    """Tree-topology finalization over simulated rank lists.

    Builds one leaf state per rank, reduces pairwise in O(log N) rounds and
    materializes -- byte-identical to :func:`finalize_ranks`.
    """
    states = [make_rank_state(r, cst, cfg, registry)
              for r, (cst, cfg) in enumerate(zip(rank_csts, rank_cfgs))]
    root = tree_reduce_states(states)
    return materialize_state(root, inter_patterns=inter_patterns,
                             fit_mode=fit_mode)


# ---------------------------------------------------------------------------
# incremental (cross-epoch) state append -- the streaming finalize core
# ---------------------------------------------------------------------------
#
# A streaming flush reduces only the epoch's DELTA across ranks (O(delta)),
# then folds the resulting epoch state into a persisted cumulative state
# with append_epoch_state: occurrence indices of the delta's groups are
# shifted past the occurrences already accumulated (a per-masked-key
# counter maintained incrementally, so the fold never rescans the
# cumulative groups), per-rank terminal streams are concatenated (their
# grammars via sequitur.concat_grammars, terminal ids shifted past the
# cumulative rows), and group payloads are inserted untouched.  Per flush
# this is O(delta groups + unique stream pairs), never O(total);
# materialize_state over the cumulative state emits a merged trace that is
# value-identical (records, analyses) to a one-shot finalize of the full
# call history -- the ROADMAP "incremental finalize" item.


def epoch_occ_counts(state: RankState) -> Dict[bytes, int]:
    """Occurrences per masked signature in one state (dense 0..k-1 group
    indices, so the count is the number of keys per mkey)."""
    counts: Dict[bytes, int] = {}
    for mkey, _occ in state.groups:
        counts[mkey] = counts.get(mkey, 0) + 1
    return counts


def append_epoch_state(cum: Optional[RankState],
                       occ_counts: Optional[Dict[bytes, int]],
                       delta: RankState
                       ) -> Tuple[RankState, Dict[bytes, int]]:
    """Fold one epoch's cross-rank merged state into the cumulative state.

    ``cum`` covers the same contiguous rank block as ``delta`` but earlier
    epochs; ``occ_counts`` is the running per-mkey occurrence counter of
    ``cum`` (pass the pair returned by the previous call, or ``(None,
    None)`` to seed from the first epoch).  Returns the new
    ``(state, occ_counts)``; ``delta`` is absorbed and must not be reused.
    """
    from .sequitur import concat_grammars

    if cum is None:
        return delta, epoch_occ_counts(delta)
    if occ_counts is None:
        occ_counts = epoch_occ_counts(cum)
    if (cum.base, cum.n) != (delta.base, delta.n):
        raise ValueError(
            f"append_epoch_state requires matching rank blocks, got "
            f"[{cum.base},{cum.base + cum.n}) + "
            f"[{delta.base},{delta.base + delta.n})")
    groups = dict(cum.groups)
    key_map: Dict[Tuple[bytes, int], Tuple[bytes, int]] = {}
    for (mkey, occ), g in delta.groups.items():
        nk = (mkey, occ_counts.get(mkey, 0) + occ)
        key_map[(mkey, occ)] = nk
        groups[nk] = g
    for mkey, cnt in epoch_occ_counts(delta).items():
        occ_counts[mkey] = occ_counts.get(mkey, 0) + cnt

    streams: List[Tuple[bytes, tuple]] = []
    stream_table: Dict[Tuple[bytes, tuple], int] = {}
    pair_cache: Dict[Tuple[int, int], int] = {}
    stream_of: List[int] = []
    for j in range(cum.n):
        pair = (cum.stream_of[j], delta.stream_of[j])
        si = pair_cache.get(pair)
        if si is None:
            cfg_a, rows_a = cum.streams[pair[0]]
            cfg_b, rows_b = delta.streams[pair[1]]
            cfg = concat_grammars([(cfg_a, 0), (cfg_b, len(rows_a))])
            rows = rows_a + tuple(key_map[k] for k in rows_b)
            s = (cfg, rows)
            si = stream_table.get(s)
            if si is None:
                si = len(streams)
                stream_table[s] = si
                streams.append(s)
            pair_cache[pair] = si
        stream_of.append(si)
    return (RankState(base=cum.base, n=cum.n, groups=groups,
                      streams=streams, stream_of=stream_of), occ_counts)


# ---------------------------------------------------------------------------
# stable state (de)serialization for tree hops
# ---------------------------------------------------------------------------

_STATE_VERSION = 1


def _enc_comp(out: bytearray, comp: Tuple[int, Optional[int]]) -> None:
    encode_value(out, comp[0])
    if comp[1] is None:
        out.append(0)
    else:
        out.append(1)
        encode_value(out, comp[1])


def _dec_comp(buf: bytes, pos: int) -> Tuple[Tuple[int, Optional[int]], int]:
    v0, pos = decode_value(buf, pos)
    has = buf[pos]
    pos += 1
    if has:
        s, pos = decode_value(buf, pos)
        return (v0, s), pos
    return (v0, None), pos


def serialize_rank_state(state: RankState) -> bytes:
    """Deterministic byte form of a RankState (groups sorted by key), used
    to ship states between tree-reduction hops over a byte-transport Comm."""
    out = bytearray()
    write_uvarint(out, _STATE_VERSION)
    write_uvarint(out, state.base)
    write_uvarint(out, state.n)
    gkeys = sorted(state.groups)
    gindex = {k: i for i, k in enumerate(gkeys)}
    write_uvarint(out, len(gkeys))
    for mkey, occ in gkeys:
        g = state.groups[(mkey, occ)]
        write_blob(out, mkey)
        write_uvarint(out, occ)
        func_id, tid, depth, masked, ret, ret_masked = g.parts
        write_uvarint(out, func_id)
        write_uvarint(out, tid)
        write_uvarint(out, depth)
        mask_pos = tuple(i for i, v in enumerate(masked) if v is _MASK)
        encode_value(out, tuple(None if v is _MASK else v for v in masked))
        encode_value(out, mask_pos)
        encode_value(out, ret)
        out.append(1 if ret_masked else 0)
        write_uvarint(out, g.count)
        if g.lin is not None:
            out.append(0)
            write_uvarint(out, len(g.lin))
            for slot in g.lin:
                if slot[0] == "i":
                    out.append(0)
                    _enc_comp(out, (slot[1], slot[2]))
                else:
                    out.append(1)
                    _enc_comp(out, slot[1])
                    _enc_comp(out, slot[2])
        else:
            out.append(1)
            write_uvarint(out, len(g.raw))
            for rank in sorted(g.raw):
                write_uvarint(out, rank)
                encode_value(out, g.raw[rank])
    write_uvarint(out, len(state.streams))
    for cfg_bytes, rows in state.streams:
        write_blob(out, cfg_bytes)
        write_uvarint(out, len(rows))
        for gkey in rows:
            write_uvarint(out, gindex[gkey])
    write_uvarint(out, len(state.stream_of))
    for si in state.stream_of:
        write_uvarint(out, si)
    return bytes(out)


def deserialize_rank_state(buf: bytes) -> RankState:
    pos = 0
    version, pos = read_uvarint(buf, pos)
    if version != _STATE_VERSION:
        raise ValueError(f"unsupported rank-state version {version}")
    base, pos = read_uvarint(buf, pos)
    n, pos = read_uvarint(buf, pos)
    n_groups, pos = read_uvarint(buf, pos)
    groups: Dict[Tuple[bytes, int], _Group] = {}
    gkeys: List[Tuple[bytes, int]] = []
    for _ in range(n_groups):
        mkey, pos = read_blob(buf, pos)
        occ, pos = read_uvarint(buf, pos)
        func_id, pos = read_uvarint(buf, pos)
        tid, pos = read_uvarint(buf, pos)
        depth, pos = read_uvarint(buf, pos)
        masked_raw, pos = decode_value(buf, pos)
        mask_pos, pos = decode_value(buf, pos)
        ret, pos = decode_value(buf, pos)
        ret_masked = bool(buf[pos])
        pos += 1
        masked = tuple(_MASK if i in mask_pos else v
                       for i, v in enumerate(masked_raw))
        count, pos = read_uvarint(buf, pos)
        tag = buf[pos]
        pos += 1
        lin: Optional[tuple] = None
        raw: Optional[Dict[int, tuple]] = None
        if tag == 0:
            n_slots, pos = read_uvarint(buf, pos)
            slots = []
            for _ in range(n_slots):
                kind = buf[pos]
                pos += 1
                if kind == 0:
                    c, pos = _dec_comp(buf, pos)
                    slots.append(("i", c[0], c[1]))
                else:
                    ca, pos = _dec_comp(buf, pos)
                    cb, pos = _dec_comp(buf, pos)
                    slots.append(("p", ca, cb))
            lin = tuple(slots)
        else:
            n_raw, pos = read_uvarint(buf, pos)
            raw = {}
            for _ in range(n_raw):
                rank, pos = read_uvarint(buf, pos)
                offs, pos = decode_value(buf, pos)
                raw[rank] = offs
        gkey = (mkey, occ)
        gkeys.append(gkey)
        groups[gkey] = _Group((func_id, tid, depth, masked, ret, ret_masked),
                              count, lin, raw)
    n_streams, pos = read_uvarint(buf, pos)
    streams: List[Tuple[bytes, tuple]] = []
    for _ in range(n_streams):
        cfg_bytes, pos = read_blob(buf, pos)
        n_rows, pos = read_uvarint(buf, pos)
        rows = []
        for _ in range(n_rows):
            gi, pos = read_uvarint(buf, pos)
            rows.append(gkeys[gi])
        streams.append((cfg_bytes, tuple(rows)))
    n_ranks, pos = read_uvarint(buf, pos)
    stream_of = []
    for _ in range(n_ranks):
        si, pos = read_uvarint(buf, pos)
        stream_of.append(si)
    return RankState(base=base, n=n, groups=groups, streams=streams,
                     stream_of=stream_of)


def merge_serialized_states(left: bytes, right: bytes) -> bytes:
    """Byte-level pairwise merge: the reduction function handed to
    ``Comm.reduce_tree`` by ``Recorder.finalize`` (states travel as bytes
    between hops, so any byte-transport collective can carry them)."""
    return serialize_rank_state(
        merge_rank_states(deserialize_rank_state(left),
                          deserialize_rank_state(right)))
