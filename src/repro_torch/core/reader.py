"""Trace reader: lossless reconstruction of per-rank call streams.

Inverts the whole compression pipeline (paper §2.3 notes that CFG/CST traces
need decoding for analysis -- this module and the converters are that
post-processing support):

  CFG index -> unique CFG -> expand grammar -> terminals
  terminal  -> merged CST -> signature bytes -> decode
  RankPattern values      -> resolved with the reader's rank
  IterPattern values      -> resolved with a per-pattern-key run counter
                             (exact mirror of the runtime tracker)

:meth:`TraceReader.iter_records` is the lossless row-wise path: it
decodes each CST entry once (memoized) and resolves patterns per record.
The compressed-domain query layer (``TraceView``) is not part of this
package yet.

**Streaming traces** (multi-segment directories written by
``Recorder.flush``) open through the same class: committed epoch segments
are stitched into one logical trace (``streaming.stitch_segments``),
value-identical to a one-shot finalize of the same calls.  ``mode``
selects what is read:

  ``auto``      the merged trace when a clean finalize wrote one (and it
                is intact), else the stitched segments; plain single-file
                traces read as before.
  ``stitched``  always stitch the committed segments.
  ``tail``      only the newest committed segment (live monitoring of a
                running job).
  ``merged``    require the merged trace; error if absent/corrupt.

Segments that fail their manifest size check (post-commit truncation) are
skipped and reported in ``self.skipped`` -- the reader still serves every
intact committed epoch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from . import streaming, trace_format
from .encoding import Handle, IterPattern, RankPattern, decode_signature
from .patterns import IntraPatternDecoder
from .sequitur import (concat_grammars, expand_grammar, parse_grammar,
                       terminal_counts)
from .trace_format import TraceFormatError, read_trace_files


@dataclass
class Record:
    func: str
    layer: str
    args: tuple
    arg_names: tuple
    ret: Any
    thread: int
    depth: int
    t_entry: Optional[int] = None
    t_exit: Optional[int] = None
    roles: tuple = ()

    def arg(self, name: str) -> Any:
        return self.args[self.arg_names.index(name)]


def _resolve_rank(v: Any, rank: int) -> Any:
    if isinstance(v, RankPattern):
        return v.value_for(rank)
    if isinstance(v, IterPattern):
        return IterPattern(_resolve_rank(v.a, rank), _resolve_rank(v.b, rank))
    if isinstance(v, tuple):
        return tuple(_resolve_rank(x, rank) for x in v)
    return v


def _derive_key(func_id: int, tidx: int, args: tuple, ret: Any,
                roles: Sequence[str], ret_is_offset: bool) -> tuple:
    """The pattern-run key of one call, built from its rank-resolved
    values exactly as the runtime tracker builds it: non-offset args split
    into handle ids and key parts."""
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


_MODES = ("auto", "stitched", "tail", "merged")


class TraceReader:
    def __init__(self, trace_dir: str, mode: str = "auto"):
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        self.mode = mode
        self.trace_dir = trace_dir
        self.skipped: List[Dict[str, str]] = []
        # degraded (rank-failure) epochs this reader serves: segment name ->
        # sorted ranks whose contribution made it into that epoch
        self.degraded_epochs: Dict[str, List[int]] = {}
        self.n_segments = 1
        # refresh bookkeeping: what this reader currently serves
        # ("single" | "merged" | "stitched" | "tail"), the highest epoch
        # number consumed (committed OR skipped), the serialized stitched
        # CFGs (the incremental fold splices new epochs onto them), and
        # the newest segment name a tail reader serves
        self._serving = "single"
        self._epoch_high = -1
        self._unique_bytes: List[bytes] = []
        self._tail_name: Optional[str] = None
        if trace_format.is_stream_dir(trace_dir):
            self._init_stream(trace_dir, mode)
        else:
            if mode != "auto":
                raise TraceFormatError(
                    f"mode {mode!r} needs a streaming trace directory, but "
                    f"{trace_dir!r} is a plain single-segment trace")
            self._init_single(read_trace_files(trace_dir))
        self.functions = {int(k): v for k, v in self.meta["functions"].items()}
        self.nranks = self.meta["nranks"]

    def _init_single(self, data: Dict[str, Any]) -> None:
        self.meta = data["meta"]
        # a merged trace carries the degraded map in its metadata; a plain
        # single-segment trace has neither key
        self.degraded_epochs = {
            str(k): list(v)
            for k, v in (self.meta.get("degraded_epochs") or {}).items()}
        self.merged_cst: List[bytes] = data["merged_cst"]
        self._sigs: Dict[int, tuple] = {}
        self.unique_cfgs = [parse_grammar(c) for c in data["unique_cfgs"]]
        self.cfg_index: List[int] = data["cfg_index"]
        self.ts_store = streaming.make_ts_store(data)

    def _read_segment(self, trace_dir: str,
                      entry: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """One manifest entry via :func:`trace_format.load_segment`; on
        failure, record the reason in ``self.skipped`` and return None."""
        data, reason = trace_format.load_segment(trace_dir, entry)
        if data is None:
            self.skipped.append({"segment": entry["name"], "reason": reason})
        return data

    def _init_stream(self, trace_dir: str, mode: str) -> None:
        # decode lazily per mode: `merged` / `tail` open O(1) segments no
        # matter how many epochs the run committed; only a stitched read
        # pays O(total).  The cheap metadata-only version check always runs.
        manifest = trace_format.read_manifest(trace_dir)
        entries = manifest.get("segments", [])
        trace_format.check_segment_versions(trace_dir, entries)
        if entries:
            self._epoch_high = max(e["epoch"] for e in entries)
        merged_entry = manifest.get("merged")
        if mode in ("auto", "merged") and merged_entry is not None:
            reason = trace_format.validate_segment(trace_dir, merged_entry)
            if reason is None:
                try:
                    self._init_single(read_trace_files(
                        os.path.join(trace_dir, merged_entry["name"])))
                    self._serving = "merged"
                    return
                except (TraceFormatError, ValueError, IndexError,
                        OSError) as e:
                    # validate-then-read race: a concurrent writer may pop
                    # and reclaim the stale merged trace while committing
                    # a new epoch -- fall back to the segments
                    reason = (f"{merged_entry['name']} is unreadable: {e}")
            if mode == "merged":
                raise TraceFormatError(
                    f"merged trace of {trace_dir!r} is unusable: {reason}")
            self.skipped.append({"segment": merged_entry["name"],
                                 "reason": reason})
        elif mode == "merged":
            raise TraceFormatError(
                f"{trace_dir!r} has no merged trace (the run was not "
                f"cleanly finalized, or retention pruning disabled it); "
                f"use mode='stitched' for the committed epochs")
        if mode == "tail":
            # newest intact segment: walk backwards, stop at first success
            datas = []
            for entry in reversed(entries):
                data = self._read_segment(trace_dir, entry)
                if data is not None:
                    datas = [data]
                    self._tail_name = entry["name"]
                    if "ranks_present" in entry:
                        self.degraded_epochs[entry["name"]] = \
                            list(entry["ranks_present"])
                    break
        else:
            # full stitch: the one shared definition of "read a stream
            # directory" (trace_format.read_stream_trace) owns the loop
            stream = trace_format.read_stream_trace(trace_dir)
            self.skipped.extend(stream["skipped"])
            datas = [s["data"] for s in stream["segments"]]
            for s in stream["segments"]:
                if "ranks_present" in s["entry"]:
                    self.degraded_epochs[s["entry"]["name"]] = \
                        list(s["entry"]["ranks_present"])
        if not datas:
            raise TraceFormatError(
                f"no intact epoch segments in {trace_dir!r} "
                f"(skipped: {[s['reason'] for s in self.skipped]})")
        st = streaming.stitch_segments(datas)
        self.meta = st["meta"]
        self.merged_cst = st["merged_cst"]
        self._sigs = {}
        self._unique_bytes = st["unique_cfgs"]
        self.unique_cfgs = [parse_grammar(c) for c in st["unique_cfgs"]]
        self.cfg_index = st["cfg_index"]
        self.ts_store = st["ts_store"]
        self.n_segments = st["n_segments"]
        self._serving = "tail" if mode == "tail" else "stitched"

    @property
    def degraded(self) -> bool:
        """True when this reader serves PARTIAL coverage: rank-failure
        (degraded) epochs missing some ranks' windows, or committed
        segments skipped for corruption.  Analyses over a degraded trace
        are exact for what is present but not the full job's history."""
        return bool(self.degraded_epochs or self.skipped)

    @property
    def ranks_partial(self) -> List[int]:
        """Ranks absent from at least one served epoch (their record
        streams have gaps where a degraded flush committed without
        them)."""
        out: set = set()
        for present in self.degraded_epochs.values():
            out |= set(range(self.nranks)) - set(present)
        return sorted(out)

    def coverage(self) -> Dict[str, Any]:
        """What this reader actually serves, for tooling and reports:
        degraded epochs (with their present-rank masks), ranks with
        gapped streams, skipped-corrupt segments, and an overall
        ``complete`` verdict."""
        return {
            "mode": self.mode,
            "n_segments": self.n_segments,
            "complete": not self.degraded,
            "degraded_epochs": {k: list(v)
                                for k, v in self.degraded_epochs.items()},
            "ranks_partial": self.ranks_partial,
            "skipped": list(self.skipped),
        }

    def refresh(self) -> int:
        """Fold newly committed epoch segments into this reader WITHOUT
        reconstructing it; returns the number of segments folded.

        The incremental path (stitched serving) is O(delta): only the new
        segments are read and decoded, their CSTs appended, each rank's
        CFG spliced via :func:`sequitur.concat_grammars`, so one new epoch
        costs one segment fold, never a rescan of already-loaded
        segments (decoded CST entries stay memoized: the CST only grows).
        A tail
        reader re-reads only the (one) newest intact segment when it
        changed; an auto reader that had been serving a merged trace
        superseded by new epochs falls back to a full stitched build once.

        Not safe to call concurrently with attribute access on this
        reader itself.
        """
        if self._serving == "single":
            return 0  # plain single-segment trace: immutable once written
        manifest = trace_format.read_manifest(self.trace_dir)
        entries = manifest.get("segments", [])
        if self._serving == "merged":
            if manifest.get("merged") is not None:
                return 0  # still finalized: the merged trace covers all
            if self.mode == "merged":
                raise TraceFormatError(
                    f"merged trace of {self.trace_dir!r} was superseded by "
                    f"newly committed epochs (the run restarted); reopen "
                    f"with mode='auto' or 'stitched'")
            self._reinit()
            return self.n_segments
        new_entries = [e for e in entries if e["epoch"] > self._epoch_high]
        if not new_entries:
            return 0
        trace_format.check_segment_versions(self.trace_dir, new_entries)
        if self._serving == "tail":
            old_name = self._tail_name
            self._epoch_high = max(e["epoch"] for e in new_entries)
            self._reinit()
            return 0 if self._tail_name == old_name else 1
        n_folded = 0
        for entry in new_entries:
            self._epoch_high = entry["epoch"]
            data = self._read_segment(self.trace_dir, entry)
            if data is None:
                continue  # reported in self.skipped; never retried
            if data["meta"]["nranks"] != self.nranks:
                raise TraceFormatError(
                    f"segment {entry['name']} covers "
                    f"{data['meta']['nranks']} ranks, this reader serves "
                    f"{self.nranks}")
            self._fold_segment(entry, data)
            n_folded += 1
        if n_folded:
            self.functions = {int(k): v
                             for k, v in self.meta["functions"].items()}
        return n_folded

    def _fold_segment(self, entry: Dict[str, Any],
                      data: Dict[str, Any]) -> None:
        """Splice ONE newly committed segment onto the stitched state.

        Every container is REPLACED, never mutated in place, so record
        iterators started before the fold keep consistent references to
        the old state.
        """
        toff = len(self.merged_cst)
        seg_store = streaming.make_ts_store(data)
        pair_table: Dict[tuple, int] = {}
        new_bytes: List[bytes] = []
        new_parsed = []
        new_index: List[int] = []
        for r in range(self.nranks):
            key = (self.cfg_index[r], data["cfg_index"][r])
            i = pair_table.get(key)
            if i is None:
                i = len(new_bytes)
                pair_table[key] = i
                cat = concat_grammars(
                    [(self._unique_bytes[key[0]], 0),
                     (data["unique_cfgs"][key[1]], toff)])
                new_bytes.append(cat)
                new_parsed.append(parse_grammar(cat))
            new_index.append(i)
        self.merged_cst = self.merged_cst + list(data["merged_cst"])
        self._unique_bytes = new_bytes
        self.unique_cfgs = new_parsed
        self.cfg_index = new_index
        self.ts_store = streaming.StitchedTimestampStore(
            list(self.ts_store._stores) + [seg_store])
        meta = dict(data["meta"])  # newest segment: superset function table
        meta["nranks"] = self.nranks
        self.meta = meta
        self.n_segments += 1
        if "ranks_present" in entry:
            self.degraded_epochs = {**self.degraded_epochs,
                                    entry["name"]:
                                        list(entry["ranks_present"])}

    def _reinit(self) -> None:
        """Full re-open in place (tail advance, merged -> stitched
        fallback): cheap for tail (one segment), one-time for the merged
        transition."""
        self.skipped = []
        self.degraded_epochs = {}
        self.n_segments = 1
        self._tail_name = None
        self._init_stream(self.trace_dir, self.mode)
        self.functions = {int(k): v
                         for k, v in self.meta["functions"].items()}
        self.nranks = self.meta["nranks"]

    def _signature(self, terminal: int) -> tuple:
        """Decoded ``(func_id, thread, depth, args, ret)`` of one CST entry,
        memoized."""
        sig = self._sigs.get(terminal)
        if sig is None:
            sig = decode_signature(self.merged_cst[terminal])
            self._sigs[terminal] = sig
        return sig

    def n_records(self, rank: int) -> int:
        """O(|grammar|) record count from rule expansion weights."""
        grammar = self.unique_cfgs[self.cfg_index[rank]]
        return sum(terminal_counts(grammar).values())

    def iter_records(self, rank: int, timestamps: bool = True
                     ) -> Iterator[Record]:
        """Expand one rank's full record stream (lossless reconstruction):
        rank patterns are resolved with ``rank``, iteration patterns with
        a per-run-key decoder that mirrors the runtime tracker."""
        grammar = self.unique_cfgs[self.cfg_index[rank]]
        decoder = IntraPatternDecoder()
        ts = self.ts_store.load(rank) if timestamps else None
        for i, terminal in enumerate(expand_grammar(grammar)):
            func_id, tidx, depth, args, ret = self._signature(terminal)
            finfo = self.functions[func_id]
            roles = finfo["arg_roles"]
            args = tuple(_resolve_rank(a, rank) for a in args)
            ret = _resolve_rank(ret, rank)
            off_slots = [j for j, r in enumerate(roles)
                         if r == "offset" and j < len(args)]
            ret_is_offset = (finfo["ret_role"] == "offset"
                             and isinstance(ret, (int, IterPattern)))
            if off_slots or ret_is_offset:
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
            yield Record(func=finfo["name"], layer=finfo["layer"], args=args,
                         arg_names=tuple(finfo["arg_names"]), ret=ret,
                         thread=tidx, depth=depth,
                         t_entry=int(ts[i, 0]) if ts is not None else None,
                         t_exit=int(ts[i, 1]) if ts is not None else None,
                         roles=tuple(roles))

    def all_records(self, timestamps: bool = True
                    ) -> Iterator[Tuple[int, Record]]:
        for r in range(self.nranks):
            for rec in self.iter_records(r, timestamps=timestamps):
                yield r, rec
