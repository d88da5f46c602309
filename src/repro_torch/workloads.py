"""Simulated-rank I/O workloads for the paper's size evaluation.

The port's own copy of the drivers in ``benchmarks/workloads.py`` that the
evaluation needs (it imports neither JAX nor the JAX package):

``ior_rank``    -- the paper's Listing 3: strided lseek+write to a shared
                   file (IOR, Section 5.1).
``flash_rank``  -- the FLASH checkpoint/plot-file pattern (Section 5.2):
                   every k-th iteration writes a plot + checkpoint file
                   through the shardio facade (HDF5 -> MPI-IO -> POSIX
                   analogue, call depths included), with independent or
                   collective (aggregator) I/O.
``run_ranks``   -- runs one driver for every simulated rank with a fresh
                   Recorder, then the inter-process stage
                   (``finalize_recorders``), and returns the sizes of
                   Figs 4-7 and Table 4.
``synth_rank_states`` -- a direct CST/CFG synthesizer for the
                   finalize-scaling experiments: thousands of simulated
                   rank states without a Recorder per call.

Each driver runs ONE rank's call stream against a fresh Recorder (or a
baseline ``ToolAdapter``) attached behind the traced facades; the caller
loops ranks and feeds ``finalize_ranks`` (or ``tree_finalize_ranks``) --
bit-identical to what rank 0 of a real multi-process run computes after
the gather.

The data directories default to folders under ``tempfile.gettempdir()``
(``TMPDIR``); the reference's defaults are fixed ``/tmp`` paths.  The CST
records the path given to ``open()``, so equal bytes need equal
``data_dir`` arguments.
"""

from __future__ import annotations

import os
import random
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from .core.apis import framework as frame
from .core.apis import posix, shardio
from .core.encoding import Handle, encode_signature
from .core.interprocess import finalize_ranks, tree_finalize_ranks
from .core.patterns import IntraPatternTracker
from .core.recorder import Recorder, RecorderConfig, attach, detach
from .core.sequitur import Sequitur
from .core.specs import REGISTRY


def _default_dir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def ior_rank(tool, rank: int, nprocs: int, n_calls: int,
             chunk: int = 4096, data_dir: Optional[str] = None) -> None:
    """Strided shared-file writes (paper Listing 3) through the facade."""
    data_dir = data_dir or _default_dir("repro_ior")
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, "shared.bin")
    attach(tool)
    try:
        fd = posix.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        base = rank * chunk
        stride = nprocs * chunk
        buf = b"\0" * min(chunk, 256)   # byte count is what is recorded
        for i in range(n_calls):
            posix.lseek(fd, base + stride * i, 0)
            posix.write(fd, buf)
        posix.fsync(fd)
        posix.close(fd)
    finally:
        detach()


def _write_shared_file(path: str, rank: int, nprocs: int, *,
                       n_vars: int, block: int) -> None:
    """One FLASH output file, independent I/O: every rank writes its block
    of every variable at offset var_base + rank*block (rank-linear)."""
    fh = shardio.shard_open(path, 1)
    buf = b"\0" * 64
    for v in range(n_vars):
        var_base = v * nprocs * block
        shardio.shard_write_at(fh, buf, var_base + rank * block)
    shardio.shard_sync(fh)
    shardio.shard_close(fh)


def flash_rank(tool, rank: int, nprocs: int, *, iterations: int = 100,
               ckpt_every: int = 20, n_vars: int = 24, block: int = 16384,
               mode: str = "independent", stripe: int = 8, ppn: int = 64,
               rolling: bool = False,
               data_dir: Optional[str] = None) -> None:
    """The FLASH weak-scaling I/O pattern for one rank."""
    data_dir = data_dir or _default_dir("repro_flash")
    os.makedirs(data_dir, exist_ok=True)
    nodes = max(1, nprocs // ppn)
    aggregators = min(stripe, nodes) if mode == "collective" else 0
    attach(tool)
    try:
        n_out = 0
        for it in range(iterations):
            frame.step(it)
            if it % ckpt_every == 0:
                idx = 0 if rolling else n_out
                for kind in ("plt", "chk"):
                    path = os.path.join(data_dir, f"{kind}_{idx:04d}.h5")
                    if mode == "independent":
                        _write_shared_file(path, rank, nprocs,
                                           n_vars=n_vars, block=block)
                    else:
                        _write_collective_file(path, rank, nprocs,
                                               n_vars=n_vars, block=block,
                                               aggregators=aggregators)
                n_out += 1
    finally:
        detach()


def _write_collective_file(path: str, rank: int, nprocs: int, *,
                           n_vars: int, block: int, aggregators: int
                           ) -> None:
    fh = shardio.shard_open(path, 1)
    buf = b"\0" * 64
    agg = max(1, aggregators)
    per_agg = max(1, nprocs // agg)
    for v in range(n_vars):
        var_base = v * nprocs * block
        # the MPI-level collective: every rank participates, rank-linear
        shardio.shard_write_at(fh, buf, var_base + rank * block)
        # aggregator POSIX writes: aggregator-linear offsets, bigger chunks
        if rank < agg:
            shardio.shard_write_at(fh, buf, var_base + rank * per_agg * block)
    shardio.shard_sync(fh)
    shardio.shard_close(fh)


def run_ranks(workload, nprocs: int, recorder_config: RecorderConfig,
              finalize_topology: Optional[str] = None,
              fit_mode: str = "vectorized", *,
              parts: Optional[Dict[str, Any]] = None, **kw
              ) -> Dict[str, Any]:
    """Run ``workload(tool, rank, nprocs, **kw)`` for every simulated rank
    with a fresh Recorder, then the inter-process stage
    (:func:`finalize_recorders`); returns sizes.

    ``finalize_topology`` (default: honor
    ``recorder_config.finalize_topology``) and ``fit_mode`` select the
    finalize implementation (flat gather vs tree reduction, scalar,
    vectorized or ``cuda`` fitting); all combinations produce identical
    sizes.  When ``parts`` is a dict it receives the ``recorders`` and
    what the sizes count (see :func:`finalize_recorders`)."""
    recorders = []
    for r in range(nprocs):
        rec = Recorder(rank=r, config=recorder_config)
        workload(rec, r, nprocs, **kw)
        recorders.append(rec)
    if parts is not None:
        parts["recorders"] = recorders
    return finalize_recorders(recorders, finalize_topology, fit_mode,
                              parts=parts)


def finalize_recorders(recorders: List[Recorder],
                       finalize_topology: Optional[str] = None,
                       fit_mode: str = "vectorized", *,
                       parts: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """The inter-process stage of :func:`run_ranks` over Recorders that
    have run their calls (all with one config): each one's
    ``local_state()`` (timestamps compressed on the config's encode
    backend; the vectorized fit and the grammar packing follow the module
    default backend), then a flat or tree finalize (default: the config's
    ``finalize_topology``); returns the sizes of Figs 4-7 and Table 4.
    The Recorders are left as they were, so one run of the calls can be
    finalized again on another backend or topology.  When ``parts`` is a
    dict it receives what the sizes count: ``merged_entries``,
    ``unique_cfgs``, ``cfg_index`` and every rank's compressed
    ``timestamps``."""
    config = recorders[0].config
    if finalize_topology is None:
        finalize_topology = config.finalize_topology
    states = [rec.local_state() for rec in recorders]
    csts = [s[0] for s in states]
    cfgs = [s[1] for s in states]
    ts = [s[2] for s in states]
    fin = (tree_finalize_ranks if finalize_topology == "tree"
           else finalize_ranks)
    merge, cfgres = fin(
        csts, cfgs, REGISTRY,
        inter_patterns=config.inter_patterns, fit_mode=fit_mode)
    if parts is not None:
        parts.update(merged_entries=list(merge.merged_entries),
                     unique_cfgs=list(cfgres.unique_cfgs),
                     cfg_index=list(cfgres.cfg_index), timestamps=ts)
    cst_bytes = sum(len(e) + 2 for e in merge.merged_entries)
    cfg_bytes = sum(len(c) + 2 for c in cfgres.unique_cfgs)
    index_bytes = 2 * len(cfgres.cfg_index)
    ts_bytes = sum(len(t) for t in ts)
    return {
        "nprocs": len(recorders),
        "n_records": sum(rec.n_records for rec in recorders),
        "cst_entries": len(merge.merged_entries),
        "n_unique_cfgs": len(cfgres.unique_cfgs),
        "pattern_bytes": cst_bytes + cfg_bytes,   # Fig 4-7 metric
        "cst_bytes": cst_bytes,
        "cfg_bytes": cfg_bytes,
        "total_bytes": cst_bytes + cfg_bytes + index_bytes + ts_bytes,
        "ts_bytes": ts_bytes,
        "n_rank_patterns": merge.n_rank_patterns,
    }


# ---------------------------------------------------------------------------
# synthetic rank states (finalize-scaling experiments)
# ---------------------------------------------------------------------------


def synth_rank_states(nprocs: int, *, n_groups: int = 32, n_calls: int = 64,
                      pattern: str = "linear", chunk: int = 4096,
                      seed: int = 0) -> Tuple[List[List[bytes]], List[bytes]]:
    """Build (rank_csts, rank_cfgs) for ``nprocs`` simulated ranks directly.

    Each rank performs, per group g (a distinct shared file), one pwrite at
    ``base_g(rank)`` followed by ``n_calls - 1`` strided pwrites -- the IOR
    shape.  ``pattern`` controls the inter-process structure of the bases:

      linear     base = rank*chunk + g*BIG   (merges to one RankPattern)
      constant   base = g*BIG                (identical on every rank)
      irregular  base = random per (rank, g) (defeats the rank fit)
      nested     rank-linear base AND rank-linear stride: the group merges
                 to ``IterPattern(RankPattern, RankPattern)`` -- the
                 doubly-nested shape of paper Fig 3(c)
      multi      lseek groups whose OFFSET-role argument and OFFSET-role
                 return are tracked as one joint two-component run
      mixed      per-group random choice of linear/constant/irregular
                 (the original set, kept bit-stable for old seeds)
      mixed_all  per-group random choice across all five kinds

    The per-rank grammar (CFG) is structurally identical across ranks, so
    it is built once with run-length pushes; per rank only the distinct
    offset-bearing signatures are re-encoded.  Offset encoding goes through
    ``IntraPatternTracker.encode_many`` (the vectorized intra-process hot
    loop): the O(calls) per-(rank, group) work is a NumPy pass, with only
    O(groups) Python-level signature encodes per rank.  Both the encoding
    and the grammar's packing run on the module-default encode backend.
    """
    pw = REGISTRY.id_of("pwrite")
    lk = REGISTRY.id_of("lseek")
    rng = random.Random(seed)
    big = 1 << 24
    stride = nprocs * chunk
    plans = []  # per group: (kind, irregular per-rank bases or None)
    for g in range(n_groups):
        kind = pattern
        if pattern == "mixed":
            kind = rng.choice(["linear", "constant", "irregular"])
        elif pattern == "mixed_all":
            kind = rng.choice(["linear", "constant", "irregular",
                               "nested", "multi"])
        bases = ([rng.randrange(1 << 30) for _ in range(nprocs)]
                 if kind == "irregular" else None)
        plans.append((kind, bases))

    # grammar: per group, [pwrite-head, pwrite-pattern^(n_calls-1)]; terminal
    # ids are the same on every rank because the structure is
    grammar = Sequitur()
    t = 0
    for g in range(n_groups):
        grammar.push(t)          # head signature
        t += 1
        if n_calls > 1:
            grammar.push(t, n_calls - 1)  # shared IterPattern signature
            t += 1
    cfg = grammar.serialize()

    rank_csts: List[List[bytes]] = []
    for r in range(nprocs):
        tracker = IntraPatternTracker()
        cst: List[bytes] = []
        for g, (kind, bases) in enumerate(plans):
            if kind == "constant":
                base = g * big
            elif kind == "irregular":
                base = bases[r]
            else:  # linear / nested / multi: rank-linear base
                base = r * chunk + g * big
            # nested: the stride itself is rank-linear (paper Fig 3c)
            step = (nprocs + r) * chunk if kind == "nested" else stride
            if kind == "multi":
                # lseek: OFFSET-role arg and OFFSET-role return form one
                # joint two-component run (tracked and decoded together)
                offs = [(base + i * step, base + i * step)
                        for i in range(n_calls)]
                enc = tracker.encode_many(("lseek", g), offs)
                cst.append(encode_signature(lk, 0, 0,
                                            (Handle(g), enc[0][0], 0),
                                            enc[0][1]))
                if n_calls > 1:
                    cst.append(encode_signature(lk, 0, 0,
                                                (Handle(g), enc[1][0], 0),
                                                enc[1][1]))
                continue
            offs = [(base + i * step,) for i in range(n_calls)]
            enc = tracker.encode_many(("pwrite", g), offs)
            # head + (single) pattern signature, matching the grammar above
            cst.append(encode_signature(pw, 0, 0,
                                        (Handle(g), 64, enc[0][0]), 64))
            if n_calls > 1:
                cst.append(encode_signature(pw, 0, 0,
                                            (Handle(g), 64, enc[1][0]), 64))
        rank_csts.append(cst)
    return rank_csts, [cfg] * nprocs
