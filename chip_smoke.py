#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of the Recorder.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports only ``repro_torch``, ``torch``, ``numpy`` and the standard
library, builds the port's CUDA kernels from ``src/repro_torch/kernels/
csrc`` and then runs, in order:

1. build     -- compile every kernel source (one nvcc each, in parallel);
2. kernels   -- each kernel against its plain PyTorch version on the card:
                the encode and read kernels exact (``delta_zigzag`` also
                with segments, ``uvarint_pack64`` at every length class,
                both at lengths around a warp, a block and a tile, and off
                16-byte alignment; ``row_run_starts`` over rows and their
                difference, and ``digram_counts`` on both sides of its
                dense route's limit and far past it, at edge lengths
                and at 16,777,216 rows / terminals; an out-of-range
                terminal must raise), flash attention and RMSNorm within f32
                2e-5 / bf16 2e-2, the SSD chunk scan (y and final state)
                within 5 times that, at edge and full sizes and at every
                shape the serve runs give them, and at mamba2's shape for
                a prime length (Q 1, 2,053 chunks in groups) with its peak
                memory held to the scratch budget; bf16 flash attention
                and SSD scan run their tensor-core kernels, f32 their
                CUDA-core ones;
3. IOR       -- the write path: 32 ranks x 16,384 lseek+write iterations
                (paper Listing 3, 1 MiB transfers to one shared file) as
                ThreadComm ranks, finalized tree and flat on the ``cuda``
                backend and once on ``numpy``; all ``*.bin`` bytes must
                agree and the port's reader must give back the offsets;
4. facade    -- one rank through ``session`` + the ``posix`` facade (real
                file I/O, deterministic clock), one-shot and streaming at
                4,096 and 512 records a timestamp block, ``cuda`` against
                ``numpy`` bytes; every streaming flush on ``cuda`` (here
                and in phase 6) must launch ``delta_zigzag`` once, however
                many blocks it writes, and every ``cuda`` varint pack of
                phases 3-6 ``uvarint_pack64`` once;
5. patterns  -- the batched pattern encoders (``encode_many``,
                ``push_stream``) on the card, against ``numpy``; they must
                launch ``row_run_starts`` once each (twice in phases 3-6)
                and ``row_boundaries`` never;
6. read      -- the read side over phase 3's traces: ``TraceReader.view()``
                digram counts of every rank on ``cuda`` against the grammar
                walk and ``numpy`` (keys in the same order), one
                ``digram_counts`` launch a rank and one a unique grammar of
                the aggregate (33 in phases 3-6), ``digram_codes`` never;
                the terminal histogram and the fused
                tick-varint encode over all ranks, a ``TraceService`` over
                the three IOR jobs answering every query family, the
                ``traceserve`` CLI in a subprocess, and a live streaming
                job folded one segment per committed epoch;
7. multiproc -- phase 3's IOR jobs on 32 processes over ``TorchDistComm``
                (``run_process_world``: ranks over a FileStore under
                ``build/chip_smoke``, no process group), tree and flat on ``cuda`` and the
                same calls streaming a flush every 4,096 records; tree and
                flat must write phase 3's ``tree-cuda`` bytes, the
                streaming job what the same calls write on ThreadComm here,
                and every job must launch what its ThreadComm run launched,
                ``delta_zigzag`` once a rank (once a flush a rank
                streaming) and ``fit_columns`` once on rank 0 of the flat
                job only; it prints each job's wall time, every rank's
                record time, the finalize timed apart (rank 0's and the
                slowest rank's) and rank 0's device busy time;
8. serve     -- the model workload the tracer watches: qwen3-32b at every
                published width, 16 of its 64 layers, bf16, random weights
                from a seeded generator, served by ``ServeEngine`` (4
                prompts of 1,024 tokens, 32 new tokens each) on the kernel
                path inside a ``session``; the trace must read back 31
                ``serve_step`` records, the model kernels must be launched
                as often as the structure implies, and the same weights
                and prompts run again on the plain ``"torch"`` attention
                path to compare with; the qwen3-32b smoke model on the
                card must give the CPU's logits and tokens;
9. serve_ssm -- the same for the SSM family, mamba2-370m at full depth (48
                layers), and the hybrid one, hymba-1.5b at full depth (32
                layers), with 4 prompts of 2,048 tokens each; their plain
                run flips both ``attn_impl`` and ``ssm_impl`` to
                ``"torch"``; then a mamba2 prefill of 4 prompts of 2,053
                tokens (a prime: Q 1), kernel path against plain path, with
                its peak memory;
10. report   -- the kernels' launch counts from phases 3-6 and from the
                serve runs (each must be above 0, but 0 for the direct
                counterparts that the main path no longer launches:
                ``uvarint_encode64``, ``row_boundaries``, ``digram_codes``)
                and their times at the shapes those phases gave them, and
                ``digram_counts`` and ``row_run_starts`` also at
                16,777,216 terminals / rows, ``fit_columns`` at its five
                ``FIT_SHAPES`` (up to 65,536 columns and 16,384 ranks),
                as one JSON line: device
                time per call, summed over the kernels a call launches
                (the bf16 SSD scan launches three); flash attention and
                the SSD scan also at hymba's serve shape
                (``other_shape``), and their f32 paths (the CUDA-core
                kernels) at the serve shapes on a line before it.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the run exits non-zero and prints no such line.  Without a
CUDA card, or without the rest of the repository beside it, it fails.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

N_RANKS = 32
N_ITER = 16384
XFER = 1 << 20
BACKEND = "cuda"               # the encode backend the main path runs on
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory, NVIDIA data sheet
CORE_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 rate, same source
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores, same

# the serve runs: each model at its published widths, bf16, random weights
# from a CUDA generator seeded 0, SERVE_BATCH prompts (numpy seed 0) and
# SERVE_NEW greedy tokens each; then the same weights and prompts on the
# plain path that ``plain`` selects.  ``rtol`` bounds the relative L2
# error of the prefill logits, kernel path against plain path.
SERVE_BATCH, SERVE_NEW = 4, 32
# ``f32_rtol``, where set, bounds the same comparison with f32 weights and
# activations at the same width and depth.
ServeSpec = collections.namedtuple(
    "ServeSpec", "arch layers of prompt max_seq plain rtol f32_rtol")
SERVE_SPECS = (
    # 16 of 64 layers (one stage of four), to leave room for the plain
    # run.  The paths differ by the bf16 rounding of p in every attention,
    # which the bf16 layers carry to the logits: the 3-layer bf16 smoke
    # model shows 1.2e-2 on the CPU, sqrt(16 / 3) times that is 2.8e-2
    ServeSpec("qwen3-32b", 16, 64, 1024, 2048, {"attn_impl": "torch"}, 5e-2,
              None),
    # full depth, every model kernel but RMSNorm on its plain path.  The
    # SSD paths take the same f32 sums in other orders: in f32 at full
    # depth their logits agree within 3e-5 (relative L2), held here to
    # 1e-3, while a wrong decay or state is off by O(1).  In bf16 every
    # differing sum flips some y by one ulp (0.4%), and the random layers
    # carry the flips on: the gap grows with depth, about 1.2e-3 (mamba2)
    # and 1.7e-3 (hymba) a layer from the SSD alone, so 2e-3 a layer
    # bounds mamba2; hymba's attention adds qwen3's 1.0e-3 a layer, so 3e-3
    ServeSpec("mamba2-370m", 48, 48, 2048, 4096,
              {"attn_impl": "torch", "ssm_impl": "torch"}, 2e-3 * 48, 1e-3),
    ServeSpec("hymba-1.5b", 32, 32, 2048, 4096,
              {"attn_impl": "torch", "ssm_impl": "torch"}, 3e-3 * 32, 1e-3),
)
SERVE_ARCH = SERVE_SPECS[0].arch   # rows 8 and 9 are measured at its shapes
SSD_ARCH = SERVE_SPECS[1].arch     # row 10 at mamba2's
MODEL_KERNELS = ("flash_attention", "rmsnorm", "ssd_scan")
# tolerances of tests/test_kernels.py for kernel against plain version
# (the SSD scan is held to 5 times these there, and here)
FLOAT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL_SCALE = 5


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Prints a phase's wall time on exit; exceptions propagate."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.monotonic()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== phase {self.name} ok in "
                f"{time.monotonic() - self.t:.1f} s")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------------


def tick_stream(n: int, style: str, seed: int) -> np.ndarray:
    """Flat u32 ticks: monotone, wrapping at 2^32, zero deltas, extremes."""
    rng = np.random.RandomState(seed)
    if style == "wrap":
        flat = (1 << 32) - n // 2 + np.sort(rng.randint(0, n, size=n))
    elif style == "zero":
        flat = np.sort(np.repeat(rng.randint(0, 1000, size=n // 8 + 1),
                                 8)[:n])
    elif style == "extreme":
        flat = rng.randint(0, 1 << 32, size=n, dtype=np.uint64)
        flat[rng.randint(0, n)] = (1 << 32) - 1
        flat[rng.randint(0, n)] = 0
    else:
        flat = np.cumsum(rng.randint(0, 100000, size=n))
    return (np.asarray(flat).astype(np.uint64) & 0xFFFFFFFF).astype(np.uint32)


def ragged_u64(n: int, seed: int) -> np.ndarray:
    """u64 values in all 10 varint length classes, led by the edges."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 65, size=n).astype(np.uint64)
    raw = rng.randint(0, 1 << 62, size=n, dtype=np.uint64) << np.uint64(2)
    v = raw >> np.minimum(np.uint64(64) - bits, np.uint64(63))
    top = np.uint64(1) << np.maximum(bits, np.uint64(1)) - np.uint64(1)
    v = np.where(bits > 0, v | top, np.uint64(0))
    edges = np.asarray([0, 127, 128, (1 << 63), (1 << 64) - 1], np.uint64)
    k = min(n, len(edges))
    v[:k] = edges[:k]
    return v


def symbols(n: int, hi: int, seed: int, outside: bool = False
            ) -> torch.Tensor:
    """int64 symbol stream in [0, hi); with ``outside``, a fifth of the
    values are negative or at/above ``hi`` (a histogram ignores them)."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, hi, size=n).astype(np.int64)
    if outside:
        bad = rng.rand(n) < 0.2
        s[bad] = rng.choice(np.asarray([-1, -(1 << 40), hi, hi + 7, 1 << 40],
                                       np.int64), size=int(bad.sum()))
    return torch.from_numpy(s)


def fit_matrix(c: int, r: int, seed: int, base: int) -> np.ndarray:
    """(C, R) int64 rows mixing constant, rank-linear and irregular."""
    rng = np.random.RandomState(seed)
    kind = np.arange(c) % 3
    slope = rng.randint(1, 9, size=(c, 1)) * np.where(rng.rand(c, 1) < .5,
                                                      -1, 1)
    lin = rng.randint(-99, 99, size=(c, 1)) + slope * np.arange(r)[None, :]
    noise = rng.randint(-1000, 1000, size=(c, r))
    const = np.repeat(rng.randint(-50, 50, size=(c, 1)), r, axis=1)
    V = np.where(kind[:, None] == 0, const,
                 np.where(kind[:, None] == 1, lin, noise))
    return (V + base).astype(np.int64)


def terminal_stream(n: int, t: int, seed: int, hot: float = 0.5
                    ) -> np.ndarray:
    """int64 terminals in [0, t): the first ``hot`` share alternates
    between two terminals, as IOR's lseek and write do (two hot pair
    codes), the rest is uniform."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, t, size=n).astype(np.int64)
    h = int(n * hot)
    s[:h:2] = 0
    s[1:h:2] = t - 1
    return s


def run_rows(n: int, k: int, seed: int, long_run: bool = False
             ) -> np.ndarray:
    """(n, k) int64 rows in runs of 1 to 7 equal rows, a third of the runs
    near 2^63 and a third near -2^63 (their differences wrap); with
    ``long_run`` one arithmetic run that ends at 2^63 - 1."""
    rng = np.random.RandomState(seed)
    if long_run:
        V = (np.arange(n, dtype=np.int64)[:, None]
             * rng.randint(1, 9, size=(1, k))
             + rng.randint(-9, 9, size=(1, k)))
        V -= V.max()
        return V + np.int64((1 << 63) - 1)
    vals = rng.randint(0, 3, size=(n, k)).astype(np.int64)
    vals[::3] += np.int64(3 << 61)
    vals[1::3] -= np.int64(3 << 61)
    return np.ascontiguousarray(
        np.repeat(vals, rng.randint(1, 8, size=n), axis=0)[:n])


# the 16,777,216-row / -terminal inputs of the redesigned read and
# pattern kernels: (case, input maker, extra arguments)
BIG = 16777216
BIG_DIGRAMS = (("T 6, IOR-like (99% two hot codes)",
                lambda: terminal_stream(BIG, 6, 21, hot=0.99), 6),
               ("T 200, uniform", lambda: terminal_stream(BIG, 200, 22, 0),
                200),
               ("T 4096, uniform (digram_codes + sort)",
                lambda: terminal_stream(BIG, 4096, 23, 0), 4096))
BIG_RUNS = (("runs of 1-7", lambda: run_rows(BIG, 2, 24), False),
            ("runs of 1-7, diff", lambda: run_rows(BIG, 2, 24), True),
            ("one arithmetic run, diff",
             lambda: run_rows(BIG, 2, 25, long_run=True), True))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build(build) -> float:
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t = time.monotonic()
    paths = build.build_all()
    secs = time.monotonic() - t
    for p in paths:
        require(os.path.exists(p), f"{p} was not built")
    log(f"built {[os.path.basename(p) for p in paths]} in {secs:.2f} s")
    return secs


def phase_kernels(k, ssm_calls: dict) -> dict:
    """Every kernel against its plain version; returns the SSD memory
    checks by prompt length."""
    dev = torch.device("cuda")

    def same(got, want, what):
        torch.cuda.synchronize()
        require(got.dtype == want.dtype and got.shape == want.shape
                and torch.equal(got, want), f"{what}: kernel != plain")

    lengths = [1, 255, 256, 257, 4099, 65542, 16777216]
    for n in lengths:
        for style in ("mono", "wrap", "zero", "extreme"):
            x = torch.from_numpy(tick_stream(n, style, n).view(np.int32))
            x = x.to(dev)
            same(k.de.delta_zigzag(x), k.de_ref.delta_zigzag_ref(x),
                 f"delta_zigzag n={n} {style}")
        v = torch.from_numpy(ragged_u64(n, n).view(np.int64)).to(dev)
        lens, planes = k.de.uvarint_encode64(v)
        lens_p, planes_p = k.de_ref.uvarint_encode64_ref(v)
        same(lens, lens_p, f"uvarint_encode64 lens n={n}")
        same(planes, planes_p, f"uvarint_encode64 planes n={n}")
        if n >= 10:
            classes = set(lens.cpu().tolist())
            require(classes == set(range(1, 11)) or n < 1000,
                    f"uvarint n={n}: length classes {sorted(classes)}")
        log(f"delta_zigzag, uvarint_encode64 exact at n={n}")
    # lengths around a warp of 4-value lanes, a block and a 1,024-value
    # tile, primes; segment boundaries inside a vector and a warp; inputs
    # one element off 16-byte alignment read a value at a time
    for n in (1, 2, 63, 64, 1023, 1025, 2048, 2049, 4099, 32771, 65542,
              16777216):
        x = torch.from_numpy(tick_stream(n, "extreme", n + 2).view(np.int32))
        xs = torch.cat([torch.zeros(1, dtype=torch.int32), x]).to(dev)[1:]
        x = x.to(dev)
        for seg in (0, 1, 3, 4, 5, 33, 12288):
            want = k.de_ref.delta_zigzag_ref(x, seg)
            same(k.de.delta_zigzag(x, seg), want,
                 f"delta_zigzag n={n} segment={seg}")
            same(k.de.delta_zigzag(xs, seg), want,
                 f"delta_zigzag n={n} segment={seg} unaligned")
        for v in (torch.from_numpy(ragged_u64(n, n + 3).view(np.int64)),
                  torch.arange(n, dtype=torch.int64) % 300):
            vs = torch.cat([torch.zeros(1, dtype=torch.int64), v]).to(dev)
            want = k.de_ref.uvarint_pack64_ref(v.to(dev))
            same(k.de.uvarint_pack64(v.to(dev)), want,
                 f"uvarint_pack64 n={n}")
            same(k.de.uvarint_pack64(vs[1:]), want,
                 f"uvarint_pack64 n={n} unaligned")
    log("delta_zigzag with segments 0, 1, 3, 4, 5, 33, 12,288 and "
        "uvarint_pack64 exact at n 1..16,777,216, aligned and not")
    # a thread a row up to 64 ranks (fit_plan's edge on the H100), then a
    # warp a span; rows split over spans; column slices (rows off 16-byte
    # alignment)
    fit_shapes = ((4096, 32), (1, 2), (257, 3), (32, 32), (3, 64), (3, 65),
                  (257, 4099), (3, 16384), (65536, 65), (65536, 64),
                  (65536, 3))
    for c, r in fit_shapes:
        for base in (0, 1 << 31, (1 << 61)):
            W = torch.from_numpy(fit_matrix(c, r + 1, c + r, base)).to(dev)
            for V, how in ((W[:, :r].contiguous(), ""),
                           (W[:, 1:], " column slice")):
                f, d = k.de.fit_columns(V)
                fp, dp = k.de_ref.fit_columns_ref(V)
                same(f, fp, f"fit_columns flags {c}x{r} base={base}{how}")
                same(d, dp, f"fit_columns d0 {c}x{r} base={base}{how}")
    log(f"fit_columns exact at {list(fit_shapes)}, values >= 2^31, "
        f"contiguous and as a column slice")
    for n, kk in ((65535, 3), (1, 1), (257, 1), (4099, 2)):
        for base in (0, 1 << 40):
            R = np.random.RandomState(n).randint(0, 2, size=(n, kk)) + base
            R = torch.from_numpy(R.astype(np.int64)).to(dev)
            same(k.gs.row_boundaries(R), k.gs_ref.row_boundaries_ref(R),
                 f"row_boundaries ({n}, {kk}) base={base}")
    log("row_boundaries exact at (65535, 3), (1, 1), (257, 1), (4099, 2)")
    # tiles of 1,024 rows: one row either side of a tile edge, primes, k
    # in the register path (1-4) and past it, and the big rows below
    for n, kk in ((1, 1), (2, 1), (3, 2), (1023, 1), (1024, 2), (1025, 3),
                  (4099, 4), (4099, 5), (65537, 1), (65535, 3)):
        for long_run in (False, True):
            R = torch.from_numpy(run_rows(n, kk, n + kk, long_run))
            Rs = torch.cat([R[:1], R]).to(dev)[1:]
            R = R.to(dev)
            for diff in (False, True) if n > 1 else (False,):
                want = k.gs_ref.row_run_starts_ref(R, diff)
                what = f"row_run_starts ({n}, {kk}) diff={diff} " \
                       f"long_run={long_run}"
                same(k.gs.row_run_starts(R, diff), want, what)
                same(k.gs.row_run_starts(Rs, diff), want, f"{what} unaligned")
    for case, make, diff in BIG_RUNS:
        R = torch.from_numpy(make()).to(dev)
        same(k.gs.row_run_starts(R, diff),
             k.gs_ref.row_run_starts_ref(R, diff),
             f"row_run_starts ({BIG}, 2) {case}")
    del R, Rs
    log("row_run_starts exact over rows and their difference at (1, 1) .. "
        "(65537, 1), aligned and not, and at (16,777,216, 2)")
    dense_t = k.gs.dense_max_terminals(dev)
    require(6 <= dense_t < 1 << 20, f"dense route up to T {dense_t}")

    def same_pair(got, want, what):
        for g, w, part in zip(got, want, ("codes", "counts")):
            same(g, w, f"{what} {part}")

    for n in (1, 2, 3, 257, 4099, 65537):
        for t in (1, 6, 241, 242, 4096, 1 << 20):
            x = torch.from_numpy(terminal_stream(n, t, n + t))
            xs = torch.cat([x[:1], x]).to(dev)[1:]
            x = x.to(dev)
            want = k.gs_ref.digram_counts_ref(x, t)
            same_pair(k.gs.digram_counts(x, t), want,
                      f"digram_counts n={n} T={t}")
            same_pair(k.gs.digram_counts(xs, t), want,
                      f"digram_counts n={n} T={t} unaligned")
    for case, make, t in BIG_DIGRAMS:
        x = torch.from_numpy(make()).to(dev)
        same_pair(k.gs.digram_counts(x, t), k.gs_ref.digram_counts_ref(x, t),
                  f"digram_counts n={BIG} {case}")
    del x, xs
    for t, bad in ((6, -1), (6, 6), (4096, 4096), (4096, -(1 << 40))):
        x = torch.from_numpy(terminal_stream(5000, t, 7))
        x[4321] = bad
        try:
            k.gs.digram_counts(x.to(dev), t)
        except ValueError:
            continue
        raise AssertionError(f"digram_counts T={t}: {bad} did not raise")
    log(f"digram_counts exact at n 1..65,537 for T 1, 6, 241, 242, 4,096, "
        f"2^20, aligned and not, and at n {BIG} (T 6, 200, 4,096); the "
        f"dense route takes T <= {dense_t} here; out-of-range terminals "
        f"raise")
    lengths = [1, 2, 255, 256, 257, 4099, 65537, 16777216]
    for n in lengths:
        for style in ("mono", "wrap", "zero", "extreme"):
            x = torch.from_numpy(tick_stream(n, style, n + 1).view(np.int32))
            x = x.to(dev)
            for got, want, part in zip(k.de.delta_zigzag_varint(x),
                                       k.de_ref.delta_zigzag_varint_ref(x),
                                       ("zz", "lens", "planes")):
                same(got, want, f"delta_zigzag_varint {part} n={n} {style}")
        # 58,112 uint32 bins fill a block's 227 KB of shared memory; 65,536
        # and 2^20 bins run the kernel that adds into global memory
        for n_bins in (1, 64, 4096, 58112, 65536, 1 << 20):
            s = symbols(n, n_bins, n + n_bins, outside=True).to(dev)
            same(k.gs.histogram(s, n_bins), k.gs_ref.histogram_ref(s, n_bins),
                 f"histogram n={n} n_bins={n_bins}")
        for t in (1, 40, 4096, 1 << 20):
            s = symbols(n, t, n * 3 + t).to(dev)
            codes = k.gs.digram_codes(s, t)
            same(codes, k.gs_ref.digram_codes_ref(s, t),
                 f"digram_codes n={n} T={t}")
            if t == 1 << 20 and n >= 4099:
                require(int(codes.max()) >= 1 << 31,
                        f"digram_codes n={n}: no code passed 2^31")
        log(f"delta_zigzag_varint, histogram, digram_codes exact at n={n}")
    return model_kernels(k, ssm_calls)


def randn(shape, seed: int, dtype: torch.dtype) -> torch.Tensor:
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to("cuda", dtype)


def close_err(got: torch.Tensor, want: torch.Tensor, what: str,
              scale: float = 1) -> float:
    """Max abs error of ``got`` against ``want``; fails unless every
    element is within ``scale`` times FLOAT_TOL (atol + rtol * |want|)."""
    torch.cuda.synchronize()
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{what}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
            f"{tuple(want.shape)}")
    tol = FLOAT_TOL[want.dtype] * scale
    g, w = got.float(), want.float()
    require(bool(((g - w).abs() <= tol + tol * w.abs()).all()),
            f"{what}: kernel differs from plain beyond {tol}")
    return float((g - w).abs().max()) if g.numel() else 0.0


def ssm_serve_kernel_calls(s) -> dict:
    """The flash-attention and RMSNorm calls of the SSM serve runs, from
    their configurations: the prefill's attention (q shape, KV heads,
    window; causal) and the SSD gate norm's input in the prefill (B, S,
    nh, hd) and in decode (B, nh, hd)."""
    calls = {"flash_attention": [], "rmsnorm": []}
    for spec in SERVE_SPECS[1:]:
        cfg = s.get_config(spec.arch)
        if cfg.family != "ssm":
            calls["flash_attention"].append(
                ((SERVE_BATCH, spec.prompt, cfg.n_heads, cfg.hd),
                 cfg.n_kv_heads, cfg.sliding_window))
        calls["rmsnorm"] += [
            ((SERVE_BATCH, spec.prompt, cfg.ssm_heads, cfg.ssm_head_dim),),
            ((SERVE_BATCH, cfg.ssm_heads, cfg.ssm_head_dim),)]
    return calls


def model_kernels(k, ssm_calls: dict) -> dict:
    """Flash attention and RMSNorm against their plain versions: bf16 and
    f32, GQA groups 1 and 8, causal, non-causal and windowed masks, prime
    and ragged lengths, every supported head dim, the serve shapes (the
    SSM serve runs' from ``ssm_calls``)."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for S, H, KVH, D in ((1, 8, 1, 128), (37, 8, 8, 16), (131, 8, 1, 32),
                             (1000, 4, 4, 64), (1024, 16, 2, 128),
                             (100, 2, 2, 8)):
            for causal, window in ((True, 0), (False, 0), (True, 100)):
                q = randn((2, S, H, D), S, dtype)
                kk = randn((2, S, KVH, D), S + 1, dtype)
                v = randn((2, S, KVH, D), S + 2, dtype)
                what = (f"flash_attention S={S} H={H} KVH={KVH} D={D} "
                        f"causal={causal} window={window} {dtype}")
                err = close_err(k.fa.flash_attention(q, kk, v, causal=causal,
                                                     window=window),
                                k.fa_ref.flash_attention_ref(
                                    q, kk, v, causal=causal, window=window),
                                what)
                worst[dtype] = max(worst.get(dtype, 0.0), err)
        for shape in ((1, 128), (37, 128), (256, 128), (32, 128),
                      (32768, 128), (262144, 128), (3, 100), (5, 8192)):
            x = randn(shape, shape[0], dtype)
            w = torch.rand(shape[-1], generator=torch.Generator(
                device="cuda").manual_seed(1), device="cuda")
            close_err(k.rn.rmsnorm(x, w, eps=1e-6),
                      k.rn_ref.rmsnorm_ref(x, w, eps=1e-6),
                      f"rmsnorm {shape} {dtype}")
    log(f"flash_attention within tolerance at S 1..1024, D 8..128, groups "
        f"1 and 8, three masks (max abs error f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}); "
        f"rmsnorm within tolerance at 1..262,144 rows, d 100..8192")
    q = randn((4, 1024, 64, 128), 1, torch.bfloat16)
    kk = randn((4, 1024, 8, 128), 2, torch.bfloat16)
    v = randn((4, 1024, 8, 128), 3, torch.bfloat16)
    err = close_err(k.fa.flash_attention(q, kk, v),
                    k.fa_ref.flash_attention_ref(q, kk, v),
                    "flash_attention at the serve prefill shape")
    log(f"flash_attention at the serve prefill shape (4, 1024, 64, 128) "
        f"bf16 causal: max abs error {err:.3g}")
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S, H, D), kvh, window in ssm_calls["flash_attention"]:
            q = randn((B, S, H, D), 41, dtype)
            kk = randn((B, S, kvh, D), 42, dtype)
            v = randn((B, S, kvh, D), 43, dtype)
            what = (f"flash_attention at the SSM serve shape q "
                    f"{(B, S, H, D)}, {kvh} KV heads, causal, window "
                    f"{window}, {dtype}")
            err = close_err(k.fa.flash_attention(q, kk, v, window=window),
                            k.fa_ref.flash_attention_ref(q, kk, v,
                                                         window=window),
                            what)
            del q, kk, v
            log(f"{what}: max abs error {err:.3g}")
        for (shape,) in ssm_calls["rmsnorm"]:
            x = randn(shape, 44, dtype)
            w = torch.rand(shape[-1], generator=torch.Generator(
                device="cuda").manual_seed(1), device="cuda")
            err = close_err(k.rn.rmsnorm(x, w, eps=1e-5),
                            k.rn_ref.rmsnorm_ref(x, w, eps=1e-5),
                            f"rmsnorm {shape} {dtype}")
            log(f"rmsnorm at the SSM serve gate-norm shape {shape} {dtype}: "
                f"max abs error {err:.3g}")
    torch.cuda.empty_cache()
    return ssd_kernel_checks(k)


def ssd_inputs(B, nc, Q, nh, hd, ns, dtype, seed):
    """x, b, c (``dtype``), dt in [0, 0.1) and da in (-0.5, 0] (f32), from
    numpy seeds, on the card."""
    rng = np.random.RandomState(seed)
    dt = torch.from_numpy((rng.rand(B, nc, Q, nh) * 0.1).astype(np.float32))
    da = torch.from_numpy((-rng.rand(B, nc, Q, nh) * 0.5).astype(np.float32))
    return (randn((B, nc, Q, nh, hd), seed + 1, dtype),
            randn((B, nc, Q, ns), seed + 2, dtype),
            randn((B, nc, Q, ns), seed + 3, dtype), dt.cuda(), da.cuda())


def ssd_check(k, args, what) -> float:
    """The SSD kernel (with its final state) against its plain version."""
    y, h = k.ssd.ssd_scan(*args, return_state=True)
    y_ref, h_ref = k.ssd_ref.ssd_scan_chunked_ref(*args)
    return max(close_err(y, y_ref, f"{what} y", SSD_TOL_SCALE),
               close_err(h, h_ref, f"{what} state", SSD_TOL_SCALE))


def ssd_kernel_checks(k) -> None:
    """ssd_scan against its plain version: Q 1, 7, 100, 256 (tails of the
    kernel's 64-row tiles), nc 1, 3, 8, (ns, hd) (16, 16) and (128, 64),
    f32 and bf16, then both serve prefill shapes, the bf16 groups, and
    mamba2's shape at S 2,048 and 2,053 with its memory (returned by S)."""
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for Q, nc in ((1, 3), (7, 8), (100, 3), (256, 1), (256, 8)):
            for ns, hd in ((16, 16), (128, 64)):
                err = ssd_check(k, ssd_inputs(2, nc, Q, 3, hd, ns, dtype,
                                              Q + nc + hd),
                                f"ssd_scan Q={Q} nc={nc} ns={ns} hd={hd} "
                                f"{dtype}")
                worst[dtype] = max(worst.get(dtype, 0.0), err)
    log(f"ssd_scan within {SSD_TOL_SCALE} x tolerance at Q 1..256, nc 1..8, "
        f"(ns, hd) (16, 16) and (128, 64), y and final state (max abs "
        f"error f32 {worst[torch.float32]:.3g}, bf16 "
        f"{worst[torch.bfloat16]:.3g})")
    for arch, shape in (("mamba2-370m", (4, 8, 256, 32, 64, 128)),
                        ("hymba-1.5b", (4, 8, 256, 50, 64, 16))):
        err = ssd_check(k, ssd_inputs(*shape, torch.bfloat16, 31),
                        f"ssd_scan at the {arch} serve shape")
        log(f"ssd_scan at the {arch} serve prefill shape (B, nc, Q, nh, hd, "
            f"ns) = {shape} bf16: max abs error {err:.3g}")
    # groups: a group boundary only cuts the state pass's walk, so any
    # grouping gives one group's bits (a smaller scratch budget forces
    # groups of 3 and 5); B nc past the grid's 65,535
    shape = (2, 16, 64, 3, 64, 128)
    args = ssd_inputs(*shape, torch.bfloat16, 32)
    y, h = k.ssd.ssd_scan(*args, return_state=True)
    per_chunk = k.ssd.scratch_plan(*shape)[1] // shape[1]
    budget = k.ssd.SCRATCH_BUDGET
    try:
        for group in (3, 5):
            k.ssd.SCRATCH_BUDGET = group * per_chunk
            require(k.ssd.scratch_plan(*shape)[0] == group,
                    f"a budget of {group} chunks gave another group")
            yg, hg = k.ssd.ssd_scan(*args, return_state=True)
            require(torch.equal(yg, y) and torch.equal(hg, h),
                    f"ssd_scan in groups of {group} != one group")
    finally:
        k.ssd.SCRATCH_BUDGET = budget
    err = ssd_check(k, ssd_inputs(33, 2000, 1, 1, 16, 16, torch.bfloat16, 33),
                    "ssd_scan at B 33, nc 2,000 (B nc > 65,535)")
    log(f"ssd_scan in groups of 3 and 5 bit-identical to one group; at B "
        f"33 x nc 2,000 (B nc 66,000, Q 1) within tolerance (max abs error "
        f"{err:.3g})")
    return {S: ssd_memory_check(k, S) for S in (2048, 2053)}


def ssd_prompt_shape(S: int) -> tuple:
    """(B, nc, Q, nh, hd, ns) of mamba2-370m's SSD scans for SERVE_BATCH
    prompts of S tokens: Q as ``models.ssm.ssd_apply`` chooses it (the
    largest divisor of S up to the 256 of the config)."""
    Q = min(256, S)
    while S % Q:
        Q -= 1
    return (SERVE_BATCH, S // Q, Q, 32, 64, 128)


def ssd_memory_check(k, S: int) -> dict:
    """One bf16 ssd_scan at mamba2's shape for S tokens against its plain
    version, with the memory it allocates above its inputs: at most the
    scratch budget above y and the state (the allocator rounds each
    allocation up to 2 MiB)."""
    shape = ssd_prompt_shape(S)
    args = ssd_inputs(*shape, torch.bfloat16, 34)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y, h = k.ssd.ssd_scan(*args, return_state=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    G, scratch = k.ssd.scratch_plan(*shape)
    limit = k.ssd.SCRATCH_BUDGET + y.numel() * 2 + h.numel() * 4 + (6 << 20)
    require(peak <= limit, f"ssd_scan at S {S}: {peak} B above its inputs, "
            f"over {limit}")
    del y, h
    err = ssd_check(k, args, f"ssd_scan at mamba2's shape, S {S}")
    # the plan is scratch_plan's arithmetic; the peak is measured
    res = {"S": S, "shape": list(shape), "planned_group": G,
           "planned_scratch_bytes": scratch, "peak_extra_bytes": peak,
           "max_abs_err": err}
    log(f"ssd_scan at mamba2's shape for S {S} (B, nc, Q, nh, hd, ns) = "
        f"{shape} bf16: groups of {G} chunks, scratch {scratch} B (one "
        f"group of all {shape[1]}: "
        f"{scratch // G * shape[1]} B); peak memory above the inputs "
        f"{peak} B (limit {limit}); max abs error {err:.3g}")
    return res


def bin_files(tdir: str) -> dict:
    """Relative path -> bytes of every ``*.bin`` file under ``tdir``."""
    out = {}
    for root, _dirs, files in os.walk(tdir):
        for name in files:
            if name.endswith(".bin"):
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, tdir)] = f.read()
    require(bool(out), f"no trace files under {tdir}")
    return out


def digest(files: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(files):
        h.update(name.encode() + b"\0" + files[name])
    return h.hexdigest()


def ior_ticks(rank: int) -> np.ndarray:
    n = 2 * N_ITER + 3
    rng = np.random.RandomState(1000 + rank)
    return np.cumsum(rng.randint(1, 40, size=2 * n)).reshape(n, 2)


def ior_record(rec, comm, registry, rank: int, flush_every: int = 0
               ) -> None:
    """Rank ``rank``'s IOR calls into ``rec`` with explicit ticks; with
    ``flush_every``, a (collective) ``rec.flush(comm)`` every that many
    records."""
    fid = {n: registry.id_of(n)
           for n in ("open", "lseek", "write", "fsync", "close")}
    t = iter(ior_ticks(rank).tolist())
    done = 0

    def record(f, args, ret):
        nonlocal done
        rec.record(f, args, ret, 0, *next(t))
        done += 1
        if flush_every and done % flush_every == 0:
            rec.flush(comm)

    fd = 3
    record(fid["open"], ("/scratch/ior/testFile", os.O_RDWR | os.O_CREAT,
                         0o644), fd)
    for i in range(N_ITER):
        off = rank * XFER + i * N_RANKS * XFER
        record(fid["lseek"], (fd, off, 0), off)
        record(fid["write"], (fd, XFER), XFER)
    record(fid["fsync"], (fd,), 0)
    record(fid["close"], (fd,), 0)
    rec.forget_handle(fd)


def run_ior(p, trace_dir: str, topology: str, backend: str,
            flush_every: int = 0) -> None:
    """One IOR job: ranks are threads feeding ``Recorder.record`` with
    explicit ticks (the facade's wrapper slot is process-global); with
    ``flush_every``, a streaming job flushed every that many records."""
    def worker(comm, rank):
        rec = p.Recorder(rank=rank, config=p.RecorderConfig(
            finalize_topology=topology, encode_backend=backend,
            trace_dir=trace_dir if flush_every else None))
        ior_record(rec, comm, p.REGISTRY, rank, flush_every)
        return rec.finalize(comm, trace_dir=trace_dir)

    shutil.rmtree(trace_dir, ignore_errors=True)
    stats = p.run_thread_world(N_RANKS, worker)
    require(stats[0] is not None and all(s is None for s in stats[1:]),
            "finalize must return stats on rank 0 only")
    require(stats[0].n_records == 2 * N_ITER + 3,
            f"rank 0 recorded {stats[0].n_records} calls")


def device_busy_ms(prof) -> float:
    """Device time (kernels and copies) a CUDA-only profile recorded."""
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def counts_since(build, before: dict) -> dict:
    """Launches counted since the snapshot ``before``."""
    now = build.launch_counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def phase_ior(p) -> tuple:
    """The three IOR jobs; returns their ``*.bin`` files and the launches
    each job made, by job."""
    from torch.profiler import ProfilerActivity, profile
    runs, counts = {}, {}
    for name, topology, backend in (("tree-cuda", "tree", BACKEND),
                                    ("flat-cuda", "flat", BACKEND),
                                    ("tree-numpy", "tree", "numpy")):
        d = os.path.join(WORK, "ior", name)
        p.eb.set_default_backend(backend)
        before = p.build.launch_counts()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.monotonic()
                run_ior(p, d, topology, backend)
                torch.cuda.synchronize()
                secs = time.monotonic() - t
        finally:
            p.eb.set_default_backend(BACKEND)
        counts[name] = counts_since(p.build, before)
        runs[name] = bin_files(d)
        busy = device_busy_ms(prof)
        log(f"IOR {name}: {N_RANKS} ranks x {2 * N_ITER + 3} records in "
            f"{secs:.2f} s; device busy {busy:.3f} ms (idle share "
            f"{1 - busy / (secs * 1e3):.6f}); .bin "
            f"{sum(map(len, runs[name].values()))} B, sha256 "
            f"{digest(runs[name])[:16]}")
    require(runs["tree-cuda"] == runs["flat-cuda"],
            "tree and flat cuda traces differ")
    require(runs["tree-cuda"] == runs["tree-numpy"],
            "cuda and numpy traces differ")
    reader = p.TraceReader(os.path.join(WORK, "ior", "tree-cuda"))
    require(reader.nranks == N_RANKS, f"reader sees {reader.nranks} ranks")
    for rank in (0, N_RANKS // 2 + 1, N_RANKS - 1):   # 0, 17, 31
        recs = list(reader.iter_records(rank))
        require(len(recs) == 2 * N_ITER + 3,
                f"rank {rank}: {len(recs)} records")
        offs = [r.arg("offset") for r in recs if r.func == "lseek"]
        want = [rank * XFER + i * N_RANKS * XFER for i in range(N_ITER)]
        require(offs == want, f"rank {rank}: lseek offsets differ")
        require(all(r.ret == XFER for r in recs if r.func == "write"),
                f"rank {rank}: write sizes differ")
        ticks = [(r.t_entry, r.t_exit) for r in recs]
        require(ticks == [tuple(t) for t in ior_ticks(rank).tolist()],
                f"rank {rank}: timestamps differ")
    log(f"reader: ranks 0, {N_RANKS // 2 + 1}, {N_RANKS - 1} give back every "
        f"offset, size and tick; launches by job: {counts}")
    return runs, counts


# phase multiproc: the IOR jobs on N_RANKS processes over TorchDistComm
MP_RUNS = (("tree", "tree", 0), ("flat", "flat", 0),
           ("stream", "tree", 4096))      # (job, topology, records a flush)
MP_DEADLINE_S = 300.0


def mp_rank(comm, rank: int, root: str) -> dict:
    """One process of phase multiproc: the IOR calls of rank ``rank`` in
    each of ``MP_RUNS`` on ``cuda``, finalized over ``comm``; the ranks
    start each job together and start its finalize together.  Rank 0 gets
    every rank's record and finalize seconds and launch counts (the
    counts are per process, set to 0 before each job) and its own device
    busy time over the job."""
    import contextlib

    import repro_torch.core.apis  # noqa: F401  (populate the registry)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.recorder import Recorder, RecorderConfig
    from repro_torch.core.specs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_encode import ops as de

    # the CUDA context, the finalize's kernels and rank 0's profiler start,
    # before any clock
    de.delta_zigzag(torch.zeros(4, dtype=torch.int32, device="cuda"))
    de.uvarint_pack64(torch.zeros(4, dtype=torch.int64, device="cuda"))
    de.fit_columns(torch.zeros((2, 2), dtype=torch.int64, device="cuda"))
    if rank == 0:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    out = {}
    for name, topology, flush in MP_RUNS:
        d = os.path.join(root, name)
        _build.reset_launches()
        comm.barrier()
        with (profile(activities=[ProfilerActivity.CUDA]) if rank == 0
              else contextlib.nullcontext()) as prof:
            t0 = time.monotonic()
            rec = Recorder(rank=rank, config=RecorderConfig(
                finalize_topology=topology, encode_backend=BACKEND,
                trace_dir=d if flush else None))
            ior_record(rec, comm, REGISTRY, rank, flush)
            t1 = time.monotonic()
            comm.barrier()
            t2 = time.monotonic()
            stats = rec.finalize(comm, trace_dir=d)
            torch.cuda.synchronize()
            t3 = time.monotonic()
        out[name] = comm.gather({
            "t0": t0, "t3": t3, "record_s": t1 - t0, "finalize_s": t3 - t2,
            "launches": _build.launch_counts(),
            "n_records": None if stats is None else stats.n_records,
            "busy_ms": device_busy_ms(prof) if rank == 0 else None})
    return out


def phase_multiproc(p, ior_runs: dict, ior_counts: dict) -> dict:
    """``MP_RUNS`` on ``N_RANKS`` processes (``run_process_world``: ranks
    over a FileStore under ``WORK``, no process group).  Tree and flat must write phase
    3's ``tree-cuda`` bytes and launch what its jobs launched, summed over
    the processes: ``delta_zigzag`` once a rank, ``fit_columns`` once on
    rank 0 in the flat job and never in the tree job.  The streaming job
    must write what the same calls write on ThreadComm in this process and
    launch as much, ``delta_zigzag`` once a flush a rank."""
    root = os.path.join(WORK, "multiproc")
    shutil.rmtree(root, ignore_errors=True)
    flush = dict((n, f) for n, _, f in MP_RUNS)["stream"]
    before = p.build.launch_counts()
    t = time.monotonic()
    run_ior(p, os.path.join(root, "threads-stream"), "tree", BACKEND, flush)
    torch.cuda.synchronize()
    thread_s = time.monotonic() - t
    want = {"tree": ior_runs["tree-cuda"], "flat": ior_runs["tree-cuda"],
            "stream": bin_files(os.path.join(root, "threads-stream"))}
    want_counts = {"tree": ior_counts["tree-cuda"],
                   "flat": ior_counts["flat-cuda"],
                   "stream": counts_since(p.build, before)}
    log(f"ThreadComm streaming IOR (a flush every {flush} records): "
        f"{thread_s:.2f} s, launches {want_counts['stream']}")
    before = p.build.launch_counts()
    t = time.monotonic()
    res = p.run_process_world(N_RANKS, mp_rank, (root,),
                              deadline_s=MP_DEADLINE_S,
                              workdir=os.path.join(root, "world"))
    world_s = time.monotonic() - t
    require(counts_since(p.build, before) == {},
            "this process launched kernels while the processes ran")
    n_rec = 2 * N_ITER + 3
    epochs = -(-n_rec // flush)
    summary = {"processes": N_RANKS, "cpu_count": os.cpu_count(),
               "world_s": world_s, "threadcomm_stream_s": thread_s}
    for name, _topology, _flush in MP_RUNS:
        rows = res[0][name]
        require(all(r[name] is None for r in res[1:]),
                "gather returned off rank 0")
        require(rows[0]["n_records"] == n_rec
                and all(r["n_records"] is None for r in rows[1:]),
                f"{name}: finalize stats {[r['n_records'] for r in rows]}")
        got = bin_files(os.path.join(root, name))
        require(got == want[name],
                f"{name} over {N_RANKS} processes: .bin files differ "
                f"({digest(got)[:16]} vs {digest(want[name])[:16]})")
        per_rank = [r["launches"] for r in rows]
        total = collections.Counter()
        for c in per_rank:
            total.update(c)
        require(dict(total) == want_counts[name],
                f"{name}: launches {dict(total)} summed over the processes, "
                f"want {want_counts[name]}")
        dz = [c.get("delta_zigzag", 0) for c in per_rank]
        require(dz == [epochs if name == "stream" else 1] * N_RANKS,
                f"{name}: delta_zigzag launches by rank {dz}")
        fits = [c.get("fit_columns", 0) for c in per_rank]
        require(fits == [1 if name == "flat" else 0] + [0] * (N_RANKS - 1),
                f"{name}: fit_columns launches by rank {fits}")
        rec_s = [r["record_s"] for r in rows]
        fin_s = [r["finalize_s"] for r in rows]
        summary[name] = {
            "wall_s": max(r["t3"] for r in rows) - min(r["t0"] for r in rows),
            "record_s": rec_s, "finalize_rank0_s": fin_s[0],
            "finalize_slowest_s": max(fin_s),
            "rank0_device_busy_ms": rows[0]["busy_ms"],
            "launches": dict(total), "sha256": digest(got)[:16]}
        log(f"multiproc {name}: {N_RANKS} processes x {n_rec} records, wall "
            f"{summary[name]['wall_s']:.2f} s; record {min(rec_s):.2f}-"
            f"{max(rec_s):.2f} s a rank; finalize rank 0 {fin_s[0]:.3f} s, "
            f"slowest {max(fin_s):.3f} s; rank 0 device busy "
            f"{rows[0]['busy_ms']} ms; .bin sha256 "
            f"{summary[name]['sha256']}, as "
            f"{'ThreadComm' if name == 'stream' else 'phase 3 tree-cuda'}; "
            f"launches {dict(total)}")
    log(f"multiproc: {N_RANKS} processes on {os.cpu_count()} CPUs, world "
        f"{world_s:.2f} s (start-up, three jobs, shut-down)")
    return summary


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t


def facade_trace(p, name: str, backend: str, **cfg) -> dict:
    """One rank through ``session`` + the posix facade: real open/pwrite/
    fsync/close in one data directory, with a deterministic clock."""
    datadir = os.path.join(WORK, "facade", "data")
    tdir = os.path.join(WORK, "facade", name)
    shutil.rmtree(tdir, ignore_errors=True)
    os.makedirs(datadir, exist_ok=True)
    real = p.recorder.time
    p.recorder.time = SimpleNamespace(perf_counter=FakeClock())
    p.eb.set_default_backend(backend)
    try:
        with p.session(p.RecorderConfig(trace_dir=tdir, encode_backend=backend,
                                        **cfg)):
            fd = p.posix.open(os.path.join(datadir, "f.bin"),
                              os.O_RDWR | os.O_CREAT, 0o644)
            buf = b"x" * 512
            for i in range(16384):
                p.posix.pwrite(fd, buf, 512 * i)
            p.posix.fsync(fd)
            p.posix.close(fd)
    finally:
        p.recorder.time = real
        p.eb.set_default_backend(BACKEND)
    return bin_files(tdir)


def phase_facade(p) -> None:
    for mode, cfg in (("oneshot", {}),
                      ("stream", {"flush_every_n_records": 4096}),
                      ("stream512", {"flush_every_n_records": 4096,
                                     "ts_block_records": 512})):
        got = facade_trace(p, f"{mode}-cuda", BACKEND, **cfg)
        want = facade_trace(p, f"{mode}-numpy", "numpy", **cfg)
        require(got == want, f"facade {mode}: cuda and numpy bytes differ")
        log(f"facade {mode}: {len(got)} .bin files identical, sha256 "
            f"{digest(got)[:16]}")
    reader = p.TraceReader(os.path.join(WORK, "facade", "stream-cuda"))
    offs = [r.arg("offset") for r in reader.iter_records(0)
            if r.func == "pwrite"]
    require(offs == [512 * i for i in range(16384)],
            "facade stream: pwrite offsets differ")


def phase_patterns(p) -> None:
    rng = np.random.RandomState(5)
    rows = ([(4096 * i, 7) for i in range(40000)]
            + [(int(v), 1) for v in rng.randint(0, 1 << 40, size=5535)]
            + [(3 + 12 * i, 2 * i) for i in range(20000)])
    enc = {}
    for b in (BACKEND, "numpy"):
        enc[b] = repr(p.IntraPatternTracker().encode_many("ior", rows,
                                                          backend=b))
    require(enc[BACKEND] == enc["numpy"], "encode_many: cuda != numpy")
    stream = np.repeat(rng.randint(0, 40, size=16384),
                       rng.randint(1, 8, size=16384)).tolist()
    ser = {}
    for b in (BACKEND, "numpy"):
        s = p.Sequitur()
        s.push_stream(stream, backend=b)
        ser[b] = s.serialize()
    require(ser[BACKEND] == ser["numpy"], "push_stream: cuda != numpy")
    log(f"encode_many over {len(rows)} rows and push_stream over "
        f"{len(stream)} terminals identical to numpy")


def untimed(res) -> dict:
    """A service answer without its timing fields and its job path."""
    return {k: v for k, v in res.to_dict().items()
            if k not in ("staleness_s", "latency_s", "path")}


def phase_read(p) -> dict:
    """:func:`read_side` under the profiler: its wall time, device busy
    time and idle share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        inputs = read_side(p)
        torch.cuda.synchronize()
        secs = time.monotonic() - t
    busy = device_busy_ms(prof)
    log(f"read phase: {secs:.2f} s; device busy {busy:.3f} ms (idle share "
        f"{1 - busy / (secs * 1e3):.6f})")
    return inputs


def read_side(p) -> dict:
    """The read side over phase 3's IOR traces; returns the arrays the
    read-side kernels saw, for the report."""
    root = os.path.join(WORK, "ior")
    n_rec = 2 * N_ITER + 3
    reader = p.TraceReader(os.path.join(root, "tree-cuda"))
    view = reader.view()
    n_terms = len(reader.merged_cst)
    t = time.monotonic()
    for r in list(range(N_RANKS)) + [None]:
        got = view.digram_counts(r, backend=BACKEND)
        require(got == view.digram_counts(r),
                f"rank {r}: cuda digram counts != grammar walk")
        want = view.digram_counts(r, backend="numpy")
        require(list(got.items()) == list(want.items()),
                f"rank {r}: cuda digram counts != numpy, or in another "
                f"key order")
        want = n_rec - 1 if r is not None else N_RANKS * (n_rec - 1)
        require(sum(got.values()) == want,
                f"rank {r}: {sum(got.values())} digrams, want {want}")
    log(f"digram_counts on cuda == grammar walk == numpy (in key order) "
        f"for all "
        f"{N_RANKS} ranks and their aggregate in "
        f"{time.monotonic() - t:.2f} s")

    t = time.monotonic()
    streams = [np.fromiter(p.expand_grammar(view.grammars[view.cfg_index[r]]),
                           dtype=np.int64) for r in range(N_RANKS)]
    stream = np.concatenate(streams)
    require(len(stream) == N_RANKS * n_rec, f"{len(stream)} terminals")
    hist = p.eb.terminal_histogram(stream, n_terms, BACKEND)
    require(np.array_equal(hist, p.eb.terminal_histogram(stream, n_terms,
                                                         "numpy")),
            "terminal_histogram: cuda != numpy")
    totals = np.zeros(n_terms, np.int64)
    for term, c in view.total_terminal_counts().items():
        totals[term] = c
    require(np.array_equal(hist, totals),
            "terminal_histogram != view.total_terminal_counts()")
    log(f"terminal_histogram over {len(stream)} terminals ({n_terms} bins) "
        f"== numpy == total_terminal_counts in {time.monotonic() - t:.2f} s")

    t = time.monotonic()
    ticks = np.concatenate([view.timestamps(r).reshape(-1)
                            for r in range(N_RANKS)])
    require(len(ticks) == N_RANKS * 2 * n_rec, f"{len(ticks)} ticks")
    enc = p.eb.encode_ticks_varint(ticks, BACKEND)
    require(enc == p.eb.encode_ticks_varint(ticks, "numpy"),
            "encode_ticks_varint: cuda != numpy bytes")
    log(f"encode_ticks_varint over {len(ticks)} ticks: {len(enc)} B, "
        f"identical to numpy, in {time.monotonic() - t:.2f} s")

    t = time.monotonic()
    lo, hi = int(ticks.min()), int(ticks.max()) + 1
    params = {"bandwidth_bounds": {"t0": lo, "t1": hi},
              "overlap_ratio": {"rank": 1, "t0": lo, "t1": (lo + hi) // 2},
              "call_chains": {"rank": N_RANKS // 2},
              "digram_counts": {"rank": N_RANKS - 1},
              "dfg": {"rank": N_RANKS // 3}, "phases": {"rank": N_RANKS // 4}}
    jobs = ("tree-cuda", "flat-cuda", "tree-numpy")
    answers = {}
    with p.TraceService(root, max_staleness_s=0.0) as svc:
        require(sorted(svc.jobs()) == sorted(jobs),
                f"service sees jobs {sorted(svc.jobs())}")
        for job in jobs:
            answers[job] = {f: untimed(svc.query(job, f, params.get(f)))
                            for f in p.QUERY_FAMILIES}
            log(f"service: {job} answered {len(p.QUERY_FAMILIES)} families")
    for job in jobs[1:]:
        for f in p.QUERY_FAMILIES:
            require(answers[job][f] == answers[jobs[0]][f],
                    f"service {f}: {job} != {jobs[0]}")
    a = answers[jobs[0]]
    require(a["n_records"]["value"]["total"] == N_RANKS * n_rec,
            f"n_records total {a['n_records']['value']['total']}")
    summary = a["io_summary"]["value"]
    require(summary["n_data_calls"] == N_RANKS * N_ITER
            and summary["total_bytes"] == N_RANKS * N_ITER * XFER,
            f"io_summary: {summary['n_data_calls']} data calls, "
            f"{summary['total_bytes']} B")
    require(a["bandwidth_bounds"]["value"]["n_calls"] == N_RANKS * n_rec,
            "bandwidth_bounds over the whole run misses calls")
    log(f"service: every family identical across {jobs} in "
        f"{time.monotonic() - t:.2f} s; {summary['n_data_calls']} writes, "
        f"{summary['total_bytes']} B")

    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.traceserve", "--root",
         root, "--job", "tree-cuda", "--query", "io_summary"],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, f"traceserve CLI failed: {proc.stderr}")
    require(json.loads(proc.stdout)["value"] == summary,
            "traceserve CLI io_summary != service")
    log(f"traceserve CLI printed the same io_summary in "
        f"{time.monotonic() - t:.2f} s")

    t = time.monotonic()
    folds = live_job(p)
    log(f"live job: {folds} epochs, one segment fold each, in "
        f"{time.monotonic() - t:.2f} s")
    return {"digram_counts": (streams[0], n_terms),
            "histogram": (stream, n_terms),
            "delta_zigzag_varint": ticks,
            "n_grammars": len(set(view.cfg_index))}


LIVE_EPOCHS = 8
LIVE_FLUSH = 4096


def live_job(p) -> int:
    """A streaming Recorder (``flush_every_n_records=4096``) feeding IOR
    records; a TraceService is queried after every committed epoch, and
    its cache must fold exactly one segment per epoch."""
    root = os.path.join(WORK, "live")
    tdir = os.path.join(root, "job")
    shutil.rmtree(root, ignore_errors=True)
    fid = {n: p.REGISTRY.id_of(n) for n in ("open", "lseek", "write")}
    rec = p.Recorder(rank=0, config=p.RecorderConfig(
        trace_dir=tdir, encode_backend=BACKEND,
        flush_every_n_records=LIVE_FLUSH))
    fd, tick, off = 3, 0, 0
    rec.record(fid["open"], ("/scratch/ior/live", os.O_RDWR | os.O_CREAT,
                             0o644), fd, 0, tick, tick + 1)
    n_done = 1
    folds = None
    with p.TraceService(root, max_staleness_s=0.0) as svc:
        for epoch in range(1, LIVE_EPOCHS + 1):
            while n_done < epoch * LIVE_FLUSH:
                tick += 2
                if n_done % 2:
                    rec.record(fid["lseek"], (fd, off, 0), off, 0, tick,
                               tick + 1)
                else:
                    rec.record(fid["write"], (fd, XFER), XFER, 0, tick,
                               tick + 1)
                    off += XFER
                n_done += 1
            segs = p.trace_format.read_manifest(tdir)["segments"]
            require(len(segs) == epoch,
                    f"live job: {len(segs)} segments after epoch {epoch}")
            got = svc.query("job", "n_records").value["total"]
            require(got == n_done,
                    f"live job epoch {epoch}: {got} records, want {n_done}")
            stats = svc.stats()["cache"]
            if folds is not None:
                require(stats["segment_folds"] == folds + 1,
                        f"live job epoch {epoch}: "
                        f"{stats['segment_folds'] - folds} folds")
            require(stats["view_builds"] == 1, "live job view was rebuilt")
            folds = stats["segment_folds"]
    rec.finalize()
    return LIVE_EPOCHS


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def serve_launches(cfg, n_new: int) -> dict:
    """Model-kernel launches a generate of ``n_new`` tokens must make: one
    flash_attention per attention layer of the prefill, one ssd_scan per
    SSD layer of the prefill, and per layer and token two rmsnorm for
    QK-norm and one for the SSD gate norm."""
    ssd = cfg.family == "ssm" or cfg.hybrid
    return {"flash_attention": cfg.n_layers if cfg.family != "ssm" else 0,
            "ssd_scan": cfg.n_layers if ssd else 0,
            "rmsnorm": cfg.n_layers * n_new * (2 * cfg.qk_norm + ssd)}


def phase_serve(s, spec: ServeSpec) -> dict:
    """Serve ``spec.arch`` (``spec.layers`` layers, full widths) on the
    kernel path: a warm-up, a timed run, then the main path -- launch
    counts set to 0 just before, read just after -- inside a ``session``
    under the profiler.  Then the plain path ``spec.plain`` selects on the
    same weights and prompts, and the smoke model on the card against the
    CPU."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    cfg = s.get_config(spec.arch).replace(n_layers=spec.layers)
    require(cfg.attn_impl == "cuda" and cfg.ssm_impl == "cuda",
            "the kernel paths must be the defaults")
    t = time.monotonic()
    params = s.get_model(cfg, dev).init_params(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    flat = s.flat_params(params)
    n_params = sum(x.numel() for x in flat.values())
    n_bytes = sum(x.numel() * x.element_size() for x in flat.values())
    log(f"serve: {cfg.name}, {cfg.n_layers} of {spec.of} layers at d "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads x "
        f"{cfg.hd}, window {cfg.sliding_window}, d_ff {cfg.d_ff}, SSD "
        f"{cfg.ssm_heads if cfg.ssm_state else 0} heads x {cfg.ssm_head_dim}"
        f", state {cfg.ssm_state}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.param_dtype}: {n_params} parameters, "
        f"{n_bytes} B, initialised in {time.monotonic() - t:.2f} s")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "param_bytes": n_bytes}
    batch = {"tokens": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(SERVE_BATCH, spec.prompt)).astype(np.int32)}
    eng = s.ServeEngine(cfg, params, max_seq=spec.max_seq, device=dev)
    eng.generate(batch, 2)                 # warm-up: cuBLAS, first loads
    toks = eng.generate(batch, SERVE_NEW)  # timed, neither traced nor profiled
    st = dict(eng.stats)
    n_tok = SERVE_BATCH * SERVE_NEW
    res.update({"prefill_ms": st["prefill_s"] * 1e3,
                "decode_ms_per_step": st["decode_s"] * 1e3
                / st["decode_steps"],
                "tokens_per_s": n_tok / (st["prefill_s"] + st["decode_s"]),
                "decode_tokens_per_s": SERVE_BATCH * st["decode_steps"]
                / st["decode_s"]})
    log(f"serve {cfg.name} (kernel path): prefill of {SERVE_BATCH} x "
        f"{spec.prompt} tokens {res['prefill_ms']:.2f} ms, decode "
        f"{res['decode_ms_per_step']:.3f} ms per step of {SERVE_BATCH} "
        f"tokens, {res['tokens_per_s']:.1f} "
        f"tokens/s over {n_tok} generated ({res['decode_tokens_per_s']:.1f} "
        f"tokens/s in decode)")

    tdir = os.path.join(WORK, "serve", cfg.name, "trace")
    shutil.rmtree(tdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    s.build.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        with s.session(s.RecorderConfig(trace_dir=tdir,
                                        encode_backend=BACKEND)):
            traced = eng.generate(batch, SERVE_NEW)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    launches = s.build.launch_counts()
    res["launches"] = launches
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    busy = device_busy_ms(prof)
    res["traced_s"], res["busy_ms"] = secs, busy
    res["idle_share"] = 1 - busy / (secs * 1e3)
    top = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    res["top_kernels"] = [[e.key[:70], e.self_device_time_total / 1e3,
                           e.count] for e in top]
    # the bf16 serve path must run the tensor-core kernels: the profile
    # (which may miss some launches) must show each kernel of a model
    # kernel that ran, and none of one that did not
    want = serve_launches(cfg, SERVE_NEW)
    seen = {name: sum(e.count for e in prof.key_averages() if name in e.key)
            for name in FA_KERNELS + SSD_KERNELS}
    res["profiled_kernels"] = seen
    for kernels, model_kernel in ((FA_KERNELS, "flash_attention"),
                                  (SSD_KERNELS, "ssd_scan")):
        for name in kernels:
            require((seen[name] > 0) == (want[model_kernel] > 0),
                    f"serve {cfg.name}: profile shows {seen[name]} launches "
                    f"of {name}; {want[model_kernel]} {model_kernel} calls")
    log(f"serve {cfg.name} main path, tensor-core kernels in the profile: "
        f"{seen} (for {want})")
    log(f"serve {cfg.name} main path, device time by kernel: " + "; ".join(
        f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
        for e in top))
    log(f"serve {cfg.name} main path (traced, profiled): {secs:.3f} s, "
        f"prefill {eng.stats['prefill_s'] * 1e3:.2f} ms, decode "
        f"{eng.stats['decode_s'] * 1e3:.2f} ms; device busy {busy:.3f} ms "
        f"(idle share {res['idle_share']:.6f}); max memory allocated "
        f"{res['peak_bytes']} B; launches {launches}")
    require(traced.shape == (SERVE_BATCH, SERVE_NEW)
            and int(traced.min()) >= 0
            and int(traced.max()) < cfg.vocab_size,
            f"serve: tokens of shape {traced.shape} or out of the vocab")
    log(f"serve {cfg.name}: traced run gave the timed run's tokens: "
        f"{bool(np.array_equal(traced, toks))}")
    reader = s.TraceReader(tdir)
    steps = [r.arg("step_idx") for r in reader.iter_records(0)
             if r.func == "serve_step"]
    require(steps == list(range(SERVE_NEW - 1)),
            f"serve trace: {len(steps)} serve_step records, want "
            f"{SERVE_NEW - 1}")
    for name, want in serve_launches(cfg, SERVE_NEW).items():
        require(launches.get(name, 0) == want,
                f"serve {cfg.name}: {name} launched {launches.get(name, 0)} "
                f"times, want {want}")
    log(f"serve {cfg.name} trace reads back {len(steps)} serve_step records;"
        f" model kernel launches as the structure implies: "
        f"{serve_launches(cfg, SERVE_NEW)}")

    with torch.inference_mode():
        lg_kernel, _ = s.get_model(cfg, dev).prefill(params, batch)
        tcfg = cfg.replace(**spec.plain)
        lg_plain, _ = s.get_model(tcfg, dev).prefill(params, batch)
    require(bool(torch.isfinite(lg_kernel).all()), "serve: logits not finite")
    rel = float((lg_kernel - lg_plain).norm() / lg_plain.norm())
    res["logits_rel_err"] = rel
    res["logits_max_abs_err"] = float((lg_kernel - lg_plain).abs().max())
    require(rel <= spec.rtol,
            f"serve {cfg.name}: prefill logits of the kernel and plain "
            f"paths differ by {rel:.3g} (relative L2), over {spec.rtol}")
    eng_t = s.ServeEngine(tcfg, params, max_seq=spec.max_seq, device=dev)
    toks_t = eng_t.generate(batch, SERVE_NEW)
    res["plain_prefill_ms"] = eng_t.stats["prefill_s"] * 1e3
    res["plain_decode_ms_per_step"] = (eng_t.stats["decode_s"] * 1e3
                                       / eng_t.stats["decode_steps"])
    same = toks == toks_t
    prefix = [int(np.argmin(row)) if not row.all() else SERVE_NEW
              for row in same]
    res["tokens_agree"] = int(same.sum())
    log(f"serve {cfg.name}: prefill logits kernel vs plain path "
        f"({spec.plain}): relative L2 {rel:.3g} (limit {spec.rtol}), max abs "
        f"{res['logits_max_abs_err']:.3g}, max |logit| "
        f"{float(lg_plain.abs().max()):.3g}; generated tokens that agree: "
        f"{res['tokens_agree']} of {n_tok}, common prefix per sequence "
        f"{prefix}; plain path prefill {res['plain_prefill_ms']:.2f} ms, "
        f"decode {res['plain_decode_ms_per_step']:.3f} ms per step")
    del params, eng, eng_t, flat, lg_kernel, lg_plain
    torch.cuda.empty_cache()
    if spec.f32_rtol is not None:
        c32 = cfg.replace(dtype="float32", param_dtype="float32")
        p32 = s.get_model(c32, dev).init_params(
            torch.Generator(device=dev).manual_seed(0))
        with torch.inference_mode():
            lg_kernel, _ = s.get_model(c32, dev).prefill(p32, batch)
            lg_plain, _ = s.get_model(c32.replace(**spec.plain),
                                      dev).prefill(p32, batch)
        rel = float((lg_kernel - lg_plain).norm() / lg_plain.norm())
        res["f32_logits_rel_err"] = rel
        require(rel <= spec.f32_rtol,
                f"serve {cfg.name} in f32: prefill logits of the kernel and "
                f"plain paths differ by {rel:.3g}, over {spec.f32_rtol}")
        log(f"serve {cfg.name} in f32 at the same width and depth: prefill "
            f"logits kernel vs plain path, relative L2 {rel:.3g} (limit "
            f"{spec.f32_rtol})")
        del p32, lg_kernel, lg_plain
        torch.cuda.empty_cache()

    scfg = s.get_smoke_config(spec.arch)
    sp = s.get_model(scfg, "cpu").init_params(torch.Generator().manual_seed(0))
    sb = {"tokens": np.random.RandomState(0).randint(
        0, scfg.vocab_size, size=(2, 37)).astype(np.int32)}
    want, _ = s.get_model(scfg, "cpu").prefill(sp, sb)
    got, _ = s.get_model(scfg, dev).prefill(to_device(sp, dev), sb)
    err = float((got.cpu() - want).abs().max())
    require(err <= 1e-4, f"smoke model: card logits differ from the CPU's "
            f"by {err:.3g} (limit 1e-4)")
    want = s.ServeEngine(scfg, sp, max_seq=64, device="cpu").generate(sb, 8)
    got = s.ServeEngine(scfg, to_device(sp, dev), max_seq=64,
                        device=dev).generate(sb, 8)
    require(np.array_equal(got, want), "smoke model: card tokens != CPU's")
    log(f"smoke {spec.arch} (f32) on the card: prefill logits within "
        f"{err:.3g} of the CPU's plain path, 8 greedy tokens identical")
    return res


PRIME_PROMPT = 2053   # a prime prompt length: the SSD runs Q 1, nc 2,053


def prime_prefill(s, spec: ServeSpec) -> dict:
    """A prefill of SERVE_BATCH prompts of PRIME_PROMPT tokens on
    ``spec.arch`` (full depth, bf16, the serve run's seeded weights): after
    a warm-up, the kernel path with the launch counts set to 0 just before
    and read just after, and its memory peak; then the plain path
    ``spec.plain`` selects, and the logits of both within ``spec.rtol``."""
    dev = torch.device("cuda")
    cfg = s.get_config(spec.arch).replace(n_layers=spec.layers)
    params = s.get_model(cfg, dev).init_params(
        torch.Generator(device=dev).manual_seed(0))
    batch = {"tokens": np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(SERVE_BATCH, PRIME_PROMPT)).astype(np.int32)}
    model = s.get_model(cfg, dev)
    with torch.inference_mode():
        model.prefill(params, batch)                    # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s.build.reset_launches()
        t = time.monotonic()
        lg_kernel, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        kernel_ms = (time.monotonic() - t) * 1e3
        launches = s.build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t = time.monotonic()
        lg_plain, _ = s.get_model(cfg.replace(**spec.plain), dev).prefill(
            params, batch)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t) * 1e3
    want = serve_launches(cfg, 1)           # the prefill's own launches
    for name, n in want.items():
        require(launches.get(name, 0) == n,
                f"prime prefill: {name} launched {launches.get(name, 0)} "
                f"times, want {n}")
    require(bool(torch.isfinite(lg_kernel).all()),
            "prime prefill: logits not finite")
    rel = float((lg_kernel - lg_plain).norm() / lg_plain.norm())
    require(rel <= spec.rtol,
            f"prime prefill {cfg.name}: logits of the kernel and plain paths "
            f"differ by {rel:.3g} (relative L2), over {spec.rtol}")
    res = {"arch": cfg.name, "prompt": PRIME_PROMPT, "batch": SERVE_BATCH,
           "prefill_ms": kernel_ms, "plain_prefill_ms": plain_ms,
           "logits_rel_err": rel, "launches": launches,
           "peak_bytes": peak, "peak_above_weights_bytes": peak - base}
    log(f"prime prefill {cfg.name}: {SERVE_BATCH} x {PRIME_PROMPT} tokens "
        f"(SSD Q 1, {PRIME_PROMPT} chunks) kernel path {kernel_ms:.2f} ms, "
        f"plain path {plain_ms:.2f} ms; logits relative L2 {rel:.3g} (limit "
        f"{spec.rtol}); max memory allocated {peak} B ({peak - base} B above "
        f"the weights); launches {launches}")
    del params, lg_kernel, lg_plain
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


L2_BYTES = 50 << 20            # H100 SXM L2 cache, NVIDIA data sheet


def device_kernel_ms(fn, kernels, iters: int = 20, cold: bool = False,
                     per_call: int = 1, recorded: dict = None):
    """Device time per call of ``fn``, from torch.profiler: for each name
    in ``kernels`` (a name or a tuple of them; each call launches each
    kernel ``per_call`` times) the mean time per launch of the CUDA
    kernels whose name contains it, over the launches the profile recorded
    (a window that missed some is profiled again; a shortfall that stays
    is logged), times ``per_call``, summed over the names; None when the
    profile has none of them.  ``recorded``, if given, gets each name's
    launches in the window kept.
    Back to back, a working set under the 50 MB L2 stays cached;
    with ``cold``, twice the L2 is overwritten before every call."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.int32,
                        device="cuda") if cold else None
    names = (kernels,) if isinstance(kernels, str) else kernels
    fn()
    torch.cuda.synchronize()
    # the profiler at times records only part of a window's launches, or
    # none: profile again, up to five windows, until it has seen all of
    # them, and otherwise keep the window that saw the most
    best = None
    for _attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        seen = {}
        for kernel in names:
            hits = [e for e in prof.key_averages() if kernel in e.key]
            seen[kernel] = (sum(e.self_device_time_total for e in hits),
                            sum(e.count for e in hits))
        if best is None or (min(c for _, c in seen.values())
                            > min(c for _, c in best.values())):
            best = seen
        if all(count == iters * per_call for _, count in seen.values()):
            break
    if recorded is not None:
        recorded.update({kernel: c for kernel, (_, c) in best.items()})
    ms = 0.0
    for kernel, (total, count) in best.items():
        if count != iters * per_call:
            log(f"profile of {kernel} ({'cold' if cold else 'warm'}) "
                f"recorded {count} launches of {iters} calls")
        if not total:
            return None
        ms += total / count * per_call / 1e3
    return ms


def host_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def main_path_inputs(shapes: dict, read_inputs: dict,
                     run_input: tuple) -> dict:
    """Inputs at the largest shape each write-path kernel saw in phases
    3-5, the largest matrix the pattern encoders handed ``row_run_starts``
    (``run_input``: (V, diff)), and the arrays the read phase handed the
    read-side kernels.  The direct counterparts that the main path no
    longer launches get their successors' inputs: ``row_boundaries`` the
    difference rows ``row_run_starts`` compared, ``digram_codes`` the
    stream ``digram_counts`` counted."""
    def top(name):
        require(bool(shapes.get(name)), f"{name} saw no main-path call")
        return max(shapes[name], key=lambda s: int(np.prod(s)))

    (n_dz,) = top("delta_zigzag")
    (n_uv,) = top("uvarint_pack64")
    c, r = top("fit_columns")
    V, diff = run_input
    V = V.numpy()
    stream, t_dg = read_inputs["digram_counts"]
    all_terms, n_bins = read_inputs["histogram"]
    ticks = read_inputs["delta_zigzag_varint"]
    return {
        "delta_zigzag": (tick_stream(n_dz, "mono", 1).view(np.int32), ()),
        "uvarint_encode64": (ragged_u64(n_uv, 2).view(np.int64), ()),
        "uvarint_pack64": (ragged_u64(n_uv, 2).view(np.int64), ()),
        "fit_columns": (fit_matrix(c, r, 3, 0), ()),
        "row_boundaries": (V[1:] - V[:-1] if diff else V, ()),
        "row_run_starts": (V, (diff,)),
        "digram_codes": (stream, (t_dg,)),
        "digram_counts": (stream, (t_dg,)),
        "histogram": (all_terms, (n_bins,)),
        "delta_zigzag_varint": (ticks.astype(np.uint32).view(np.int32), ()),
    }


def varint_bytes(k, x: torch.Tensor) -> int:
    """Bytes of the uvarints of the u64 values ``x`` (int64 bit patterns)."""
    return int(k.de_ref.uvarint_encode64_ref(x)[0].sum())


DE_SRC = "src/repro_torch/kernels/csrc/delta_encode.cu"
GS_SRC = "src/repro_torch/kernels/csrc/grammar_stats.cu"
DE_TPU = "src/repro/kernels/delta_encode/delta_encode.py"
GS_TPU = "src/repro/kernels/grammar_stats/grammar_stats.py"


def run_starts_library(x: torch.Tensor, diff: bool) -> torch.Tensor:
    """The run starts by one PyTorch call, ``torch.unique_consecutive``
    over the rows (after the difference, with ``diff``): its counts are the
    run lengths."""
    rows = x[1:] - x[:-1] if diff else x
    counts = torch.unique_consecutive(rows, dim=0, return_counts=True)[1]
    return torch.cumsum(counts, 0) - counts


def digram_bytes(k, x: torch.Tensor, t: int) -> int:
    """The stream in, the distinct codes and their counts out."""
    return 8 * x.numel() + 16 * k.gs_ref.digram_counts_ref(x, t)[0].numel()


def starts_bytes(k, x: torch.Tensor, diff: bool) -> int:
    """The rows in, their run starts out."""
    return 8 * x.numel() + 8 * k.gs_ref.row_run_starts_ref(x, diff).numel()


def kernel_report(k, p, shapes: dict, launches: dict,
                  read_inputs: dict, run_input: tuple) -> list:
    dev = torch.device("cuda")
    inputs = main_path_inputs(shapes, read_inputs, run_input)
    # name: (wrapper, plain version, source, TPU kernel, device kernel name,
    #        bytes moved, integer operations, library call or None)
    specs = {
        "delta_zigzag": (
            k.de.delta_zigzag, k.de_ref.delta_zigzag_ref, DE_SRC,
            f"{DE_TPU}:40", "delta_zigzag_kernel",
            lambda x: 8 * x.numel(), lambda x: 6 * x.numel(), None),
        "uvarint_encode64": (
            k.de.uvarint_encode64, k.de_ref.uvarint_encode64_ref, DE_SRC,
            f"{DE_TPU}:155", "uvarint_encode64_kernel",
            lambda x: 22 * x.numel(), lambda x: 60 * x.numel(), None),
        # bytes: the values in, the packed stream out (its length is what
        # these values need)
        "uvarint_pack64": (
            k.de.uvarint_pack64, k.de_ref.uvarint_pack64_ref, DE_SRC,
            f"{DE_TPU}:155", "uvarint_pack64_kernel",
            lambda x: 8 * x.numel() + varint_bytes(k, x),
            lambda x: 6 * x.numel() + 4 * varint_bytes(k, x), None),
        "fit_columns": (
            k.de.fit_columns, k.de_ref.fit_columns_ref, DE_SRC,
            f"{DE_TPU}:202", "fit_columns_",
            lambda x: 8 * x.numel() + 12 * x.shape[0],
            lambda x: 4 * x.numel(), None),
        "row_boundaries": (
            k.gs.row_boundaries, k.gs_ref.row_boundaries_ref, GS_SRC,
            f"{GS_TPU}:48", "row_boundaries_kernel",
            lambda x: 8 * x.numel() + x.shape[0],
            lambda x: 2 * x.numel(), None),
        # bytes: the rows in, the starts out (as many as these rows have)
        "row_run_starts": (
            k.gs.row_run_starts, k.gs_ref.row_run_starts_ref, GS_SRC,
            f"{GS_TPU}:48", "row_run_starts_kernel",
            lambda x, d: starts_bytes(k, x, d),
            lambda x, d: (4 if d else 2) * x.numel(), run_starts_library),
        "delta_zigzag_varint": (
            k.de.delta_zigzag_varint, k.de_ref.delta_zigzag_varint_ref,
            DE_SRC, f"{DE_TPU}:100", "delta_zigzag_varint_kernel",
            lambda x: 17 * x.numel(), lambda x: 25 * x.numel(), None),
        "histogram": (
            k.gs.histogram, k.gs_ref.histogram_ref, GS_SRC, f"{GS_TPU}:79",
            "histogram_",
            lambda x, b: 8 * x.numel() + 8 * b, lambda x, b: 3 * x.numel(),
            lambda x, b: torch.bincount(x, minlength=b)),
        "digram_codes": (
            k.gs.digram_codes, k.gs_ref.digram_codes_ref, GS_SRC,
            f"{GS_TPU}:113", "digram_codes_kernel",
            lambda x, t: 16 * x.numel(), lambda x, t: 2 * x.numel(), None),
        # bytes: the stream in, the distinct codes and counts out
        "digram_counts": (
            k.gs.digram_counts, k.gs_ref.digram_counts_ref, GS_SRC,
            f"{GS_TPU}:113", "digram_counts",
            lambda x, t: digram_bytes(k, x, t), lambda x, t: 3 * x.numel(),
            None),
    }
    # the encode dispatch each kernel serves (uvarint_encode64 and
    # digram_codes serve none now: pack_uvarints_batch launches
    # uvarint_pack64, digram_histogram digram_counts; run_boundaries keeps
    # row_boundaries, but nothing on the main path calls it)
    host_calls = {
        "delta_zigzag": lambda a, b: p.eb.delta_zigzag(a.view(np.uint32), b),
        "uvarint_encode64": None,
        "uvarint_pack64": lambda a, b: p.eb.pack_uvarints_batch(
            a.view(np.uint64), b),
        "fit_columns": lambda a, b: p.eb.fit_classify(a, b),
        "row_boundaries": lambda a, b: p.eb.run_boundaries(a, b),
        "row_run_starts": lambda a, b, d: p.eb.run_starts(a, b, d),
        "delta_zigzag_varint": lambda a, b: p.eb.encode_ticks_varint(
            a.view(np.uint32), b),
        "histogram": lambda a, b, n_bins: p.eb.terminal_histogram(a, n_bins,
                                                                  b),
        "digram_codes": None,
        "digram_counts": lambda a, b, t: p.eb.digram_histogram(a, t, b),
    }
    rows = []
    for name, (kern, plain, source, replaces, kname, nbytes, nops,
               library) in specs.items():
        host, extra = inputs[name]
        x_cpu = torch.from_numpy(np.ascontiguousarray(host))
        x = x_cpu.to(dev)
        out = kern(x, *extra)
        ref = plain(x, *extra)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((o.to(torch.float64) - q.to(torch.float64))
                        .abs().max()) if o.numel() else 0.0
                  for o, q in zip(outs, refs))
        require(err == 0.0, f"{name}: kernel != plain at the main path shape")
        ms = cuda_ms(lambda: kern(x, *extra))
        recorded = {}
        device_ms = device_kernel_ms(lambda: kern(x, *extra), kname,
                                     recorded=recorded)
        device_cold_ms = device_kernel_ms(lambda: kern(x, *extra), kname,
                                          cold=True)
        plain_ms = cuda_ms(lambda: plain(x, *extra))
        library_ms = None
        if library is not None:
            require(torch.equal(library(x, *extra), outs[0]),
                    f"{name}: library call disagrees")
            library_ms = cuda_ms(lambda: library(x, *extra))
        h2d_ms = cuda_ms(lambda: x_cpu.to(dev), iters=50)
        d2h_ms = cuda_ms(lambda: [o.cpu() for o in outs], iters=50)
        bytes_ms = nbytes(x, *extra) / HBM_BYTES_PER_S * 1e3
        ops_ms = nops(x, *extra) / CORE_OPS_PER_S * 1e3
        call = host_calls[name]
        on_path = launches.get(name, 0) > 0
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "shape": list(x.shape) + list(extra), "device_ms": device_ms,
            "device_cold_ms": device_cold_ms,
            # launches the warm profile recorded, of its 20 calls
            "device_launches": {"recorded": recorded, "of": 20},
            "h2d_ms": h2d_ms, "d2h_ms": d2h_ms,
            "d2h_bytes": sum(o.numel() * o.element_size() for o in outs),
            "main_path": on_path,
            "dispatch_cuda_ms": None if call is None else host_ms(
                lambda: call(host, "cuda", *extra), iters=10),
            "dispatch_numpy_ms": None if call is None else host_ms(
                lambda: call(host, "numpy", *extra), iters=10),
        })
        log(f"{name} at {rows[-1]['shape']}: kernel {ms:.4f} ms per call "
            f"(device {device_ms} ms, L2 flushed {device_cold_ms} ms), "
            f"plain {plain_ms:.4f} ms, library {library_ms} ms, bound "
            f"{rows[-1]['bound_ms']:.6f} ms, "
            f"H2D {h2d_ms:.4f} ms, D2H {d2h_ms:.4f} ms of "
            f"{rows[-1]['d2h_bytes']} B; dispatch cuda "
            f"{rows[-1]['dispatch_cuda_ms']} ms vs numpy "
            f"{rows[-1]['dispatch_numpy_ms']} ms"
            + ("" if on_path else " (not on the main path)"))
    big = big_report(k)
    for row in rows:
        if row["name"] in big:
            row["at_16m"] = big[row["name"]]
        if row["name"] == "fit_columns":
            row["at_shapes"] = fit_report(k, p.eb)
    return rows


def big_report(k) -> dict:
    """``digram_counts`` and ``row_run_starts`` at 16,777,216 terminals /
    rows (``BIG_DIGRAMS``, ``BIG_RUNS``): per case the wrapper's ms (CUDA
    events), device ms warm and with L2 flushed (profiler), the bound, the
    plain version's ms and, for ``row_run_starts``, the library call's.
    Past the dense route's limit the device time is ``digram_codes``'
    alone; the wrapper's ms include the range check and the sort."""
    dev = torch.device("cuda")
    dense_t = k.gs.dense_max_terminals(dev)
    out = {"digram_counts": [], "row_run_starts": []}

    def measure(case, fn, plain, names, nbytes, nops, iters, library=None):
        got = fn()
        want = plain()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            require(torch.equal(g, w), f"{case}: kernel != plain at 16.8M")
        library_ms = None
        if library is not None:
            require(torch.equal(library(), got), f"{case}: library call "
                    f"disagrees")
            library_ms = cuda_ms(library, iters=iters, warmup=1)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / CORE_OPS_PER_S * 1e3
        recorded = {}
        row = {
            "case": case, "ms": cuda_ms(fn, iters=iters, warmup=1),
            "device_ms": device_kernel_ms(fn, names, iters=iters,
                                          recorded=recorded),
            "device_cold_ms": device_kernel_ms(fn, names, iters=iters,
                                               cold=True),
            "device_launches": {"recorded": recorded, "of": iters},
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "plain_ms": cuda_ms(plain, iters=iters, warmup=1),
            "library_ms": library_ms}
        log(f"{case} at 16.8M: kernel {row['ms']:.4f} ms per call (device "
            f"{row['device_ms']} ms, L2 flushed {row['device_cold_ms']} "
            f"ms), bound {row['bound_ms']:.6f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {library_ms} ms")
        return row

    for case, make, t in BIG_DIGRAMS:
        x = torch.from_numpy(make()).to(dev)
        out["digram_counts"].append(measure(
            f"digram_counts {case}", lambda: k.gs.digram_counts(x, t),
            lambda: k.gs_ref.digram_counts_ref(x, t),
            "digram_codes_kernel" if t > dense_t
            else "digram_counts_dense", digram_bytes(k, x, t), 3 * x.numel(),
            20))
    for case, make, diff in BIG_RUNS:
        x = torch.from_numpy(make()).to(dev)
        out["row_run_starts"].append(measure(
            f"row_run_starts {case}", lambda: k.gs.row_run_starts(x, diff),
            lambda: k.gs_ref.row_run_starts_ref(x, diff),
            "row_run_starts_kernel", starts_bytes(k, x, diff),
            (4 if diff else 2) * x.numel(), 20,
            library=lambda: run_starts_library(x, diff)))
    return out


# the fit_columns shapes of the report: (C, R), what each stands for
FIT_SHAPES = (((6, 32), "the main path (IOR's columns, 32 ranks)"),
              ((6, 16384), "IOR's columns at 16,384 ranks"),
              ((256, 16384), "a richer CST at 16,384 ranks"),
              ((65536, 32), "many signatures at 32 ranks"),
              ((65536, 4), "small R"))


def fit_report(k, eb) -> list:
    """``fit_columns`` at ``FIT_SHAPES`` (rows mixing constant, linear and
    irregular, ``fit_matrix``): exact against the plain version, then per
    shape its planned route (``fit_plan``, computed from the SM count, C
    and R: not read from the launch), the wrapper's ms (CUDA events), device
    ms warm and with L2 flushed (profiler), the bytes bound (8 C R read, 12
    C written), its share of the L2-flushed device time, the plain
    version's ms, the host's copy of the matrix to the card from pageable
    and through pinned memory, and the dispatch's (``eb.fit_classify``
    from numpy) on ``cuda`` and on ``numpy`` (host clock).  No single
    PyTorch call computes this function."""
    dev = torch.device("cuda")
    rows = []

    def sync(t):
        torch.cuda.synchronize()
        return t

    for (c, r), what in FIT_SHAPES:
        host = fit_matrix(c, r, c + r, 0)
        t_host = torch.from_numpy(host)
        x = t_host.to(dev)
        got = k.de.fit_columns(x)
        want = k.de_ref.fit_columns_ref(x)
        for g, w in zip(got, want):
            require(torch.equal(g, w), f"fit_columns ({c}, {r}): kernel != "
                    f"plain")
        dispatches = 200 if c * r < 1 << 20 else 10   # host clock: many
        # an older checkout (chip_ab.py) has one kernel and no plan
        plan = getattr(k.de, "fit_plan", None)
        route, span, nspans = plan(c, r, dev) if plan else (None, r, 1)
        recorded = {}
        bytes_ms = (8 * c * r + 12 * c) / HBM_BYTES_PER_S * 1e3
        row = {"shape": [c, r], "what": what,
               "ms": cuda_ms(lambda: k.de.fit_columns(x)),
               "device_ms": device_kernel_ms(lambda: k.de.fit_columns(x),
                                             "fit_columns", recorded=recorded),
               "device_cold_ms": device_kernel_ms(
                   lambda: k.de.fit_columns(x), "fit_columns", cold=True),
               "planned_route": route, "planned_span": span,
               "planned_spans": nspans,
               "device_launches": {"recorded": recorded, "of": 20},
               "bound_ms": bytes_ms, "bound_by": "bytes",
               "plain_ms": cuda_ms(lambda: k.de_ref.fit_columns_ref(x)),
               "library_ms": None,
               "h2d_pageable_ms": host_ms(
                   lambda: sync(t_host.to(dev)), iters=dispatches),
               "h2d_pinned_ms": host_ms(
                   lambda: sync(t_host.pin_memory().to(dev,
                                                       non_blocking=True)),
                   iters=dispatches),
               "dispatch_cuda_ms": host_ms(
                   lambda: eb.fit_classify(host, "cuda"), iters=dispatches),
               "dispatch_numpy_ms": host_ms(
                   lambda: eb.fit_classify(host, "numpy"),
                   iters=dispatches)}
        row["share"] = (bytes_ms / row["device_cold_ms"]
                        if row["device_cold_ms"] else None)
        log(f"fit_columns at ({c}, {r}) ({what}): kernel {row['ms']:.4f} ms "
            f"per call (device {row['device_ms']} ms, L2 flushed "
            f"{row['device_cold_ms']} ms; planned {route}, {nspans} "
            f"span(s) a row, {span} ranks a step), bound "
            f"{bytes_ms:.6f} ms, share {row['share']}, plain "
            f"{row['plain_ms']:.4f} ms; H2D pageable "
            f"{row['h2d_pageable_ms']:.4f} ms, pinned "
            f"{row['h2d_pinned_ms']:.4f} ms; dispatch cuda "
            f"{row['dispatch_cuda_ms']:.4f} ms vs numpy "
            f"{row['dispatch_numpy_ms']:.4f} ms")
        rows.append(row)
    return rows


FA_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
RN_SRC = "src/repro_torch/kernels/csrc/rmsnorm.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
FA_TPU = "src/repro/kernels/flash_attention/flash_attention.py:72"
RN_TPU = "src/repro/kernels/rmsnorm/rmsnorm.py:25"
SSD_TPU = "src/repro/kernels/ssd_scan/ssd_scan.py:63"
# the device kernels one bf16 call launches (the f32 paths keep the
# CUDA-core kernels flash_attention_kernel and ssd_scan_kernel)
FA_KERNELS = ("flash_attention_wgmma",)
SSD_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of an S x S attention."""
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    hi = i + 1 if causal else np.full(S, S)
    return int((hi - lo).sum())


def ssd_serve_shape(s, arch: str) -> tuple:
    """(B, nc, Q, nh, hd, ns) of the SSD scans of ``arch``'s serve run:
    the chunk length as ``models.ssm.ssd_apply`` chooses it."""
    cfg = s.get_config(arch)
    spec = next(sp for sp in SERVE_SPECS if sp.arch == arch)
    Q = min(cfg.ssm_chunk, spec.prompt)
    while spec.prompt % Q:
        Q -= 1
    return (SERVE_BATCH, spec.prompt // Q, Q, cfg.ssm_heads,
            cfg.ssm_head_dim, cfg.ssm_state)


def ssd_work(shape: tuple, elt: int) -> tuple:
    """(bytes, operations) of one SSD scan of (B, nc, Q, nh, hd, ns) with
    x, b and c of ``elt`` bytes.  Bytes: x, b, c, dt, da in, y and the f32
    state out.  Operations: the causal triangle the function needs, as
    the flash row counts its visible pairs -- scores (ns) and weights
    times x (hd) for each of a chunk's Q(Q+1)/2 pairs q >= p, then c . h
    and the state update per (q, state entry); 2 per multiply-add."""
    B, nc, Q, nh, hd, ns = shape
    nbytes = (2 * elt * B * nc * Q * nh * hd + 2 * elt * B * nc * Q * ns
              + 2 * 4 * B * nc * Q * nh + 4 * B * nh * ns * hd)
    ops = B * nc * nh * (Q * (Q + 1) * (ns + hd) + 4 * Q * ns * hd)
    return nbytes, ops


class MeasuredCall:
    """One kernel call at one shape, measured for the kernels line: held
    against its plain version (and the library call, if any) on the same
    bf16 inputs, timed with CUDA events and the profiler, and bounded by
    the larger of its bytes over the memory rate and its operations over
    ``peak``."""

    def __init__(self, shape, args, kwargs, kernel, plain, nbytes, nops,
                 peak, iters, scale, library=None, per_call=1):
        self.shape, self.args, self.kwargs = shape, args, kwargs
        self.kernel, self.plain, self.library = kernel, plain, library
        self.nbytes, self.nops, self.peak = nbytes, nops, peak
        self.iters, self.scale, self.per_call = iters, scale, per_call

    def _first(self, out):
        return out[0] if isinstance(out, tuple) else out

    def run(self):
        return self._first(self.kernel(*self.args, **self.kwargs))

    def measure(self, kname, what: str) -> dict:
        plain_kw = {a: b for a, b in self.kwargs.items()
                    if a != "return_state"}
        plain = lambda: self._first(  # noqa: E731
            self.plain(*self.args, **plain_kw))
        ref = plain()
        err = close_err(self.run(), ref, what, self.scale)
        library_ms = None
        if self.library is not None:
            close_err(self.library(), ref, f"{what}: library call")
            library_ms = cuda_ms(self.library, iters=self.iters)
        del ref
        bytes_ms = self.nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = self.nops / self.peak * 1e3
        recorded, prof_iters = {}, 20
        return {
            "max_abs_err": err, "ms": cuda_ms(self.run, iters=self.iters),
            "plain_ms": cuda_ms(plain, iters=max(self.iters // 4, 5)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "shape": self.shape,
            "options": plain_kw, "dtype": "bfloat16",
            "device_ms": device_kernel_ms(self.run, kname, prof_iters,
                                          per_call=self.per_call,
                                          recorded=recorded),
            # launches of each kernel the warm profile recorded, of
            # prof_iters * per_call
            "device_launches": {"recorded": recorded,
                                "of": prof_iters * self.per_call},
            "device_cold_ms": device_kernel_ms(self.run, kname, prof_iters,
                                               cold=True,
                                               per_call=self.per_call),
            "bytes": self.nbytes, "operations": self.nops,
        }

    def f32_ms(self) -> float:
        args = [a.float() for a in self.args]
        return cuda_ms(lambda: self.kernel(*args, **self.kwargs), iters=5)


def model_kernel_report(k, s, shapes: dict, launches: dict,
                        ssd_memory: dict) -> list:
    """Rows of the kernels line for flash attention and RMSNorm at the
    largest shapes the qwen3-32b serve run gave them (bf16, causal), and
    for the SSD scan at the mamba2-370m serve prefill's shape (bf16), with
    the launch counts of those runs' main paths (``launches``: arch ->
    counts; every run's count is kept in ``launches_by_run``).  The SSD
    scan's row also carries the prime prefill's shape (Q 1, in groups) and
    the memory checks of the kernels phase (``ssd_memory``)."""
    import torch.nn.functional as F

    def top(name):
        require(bool(shapes.get(name)), f"{name} saw no main-path call")
        return max(shapes[name], key=lambda s: int(np.prod(s)))

    kv_heads = s.get_config(SERVE_ARCH).n_kv_heads
    B, S, H, D = top("flash_attention")
    bf = torch.bfloat16
    q = randn((B, S, H, D), 21, bf)
    kk = randn((B, S, kv_heads, D), 22, bf)
    v = randn((B, S, kv_heads, D), 23, bf)
    x = randn(top("rmsnorm"), 24, bf)
    w = torch.rand(x.shape[-1], generator=torch.Generator(
        device="cuda").manual_seed(25), device="cuda")
    pairs = attention_pairs(S, True, 0)
    sB, snc, sQ, snh, shd, sns = ssd_serve_shape(s, SSD_ARCH)
    require((sB, snc, sQ, snh, shd) in shapes.get("ssd_scan", {}),
            f"ssd_scan saw no call at the {SSD_ARCH} serve shape")
    ssd_args = ssd_inputs(sB, snc, sQ, snh, shd, sns, bf, 26)
    hcfg = s.get_config("hymba-1.5b")
    hspec = next(sp for sp in SERVE_SPECS if sp.arch == "hymba-1.5b")
    hq = randn((SERVE_BATCH, hspec.prompt, hcfg.n_heads, hcfg.hd), 28, bf)
    hk = randn((SERVE_BATCH, hspec.prompt, hcfg.n_kv_heads, hcfg.hd), 29, bf)
    hv = randn((SERVE_BATCH, hspec.prompt, hcfg.n_kv_heads, hcfg.hd), 30, bf)
    win = hcfg.sliding_window
    require(tuple(hq.shape) in shapes.get("flash_attention", {}),
            "flash_attention saw no call at the hymba-1.5b serve shape")
    hshape = ssd_serve_shape(s, "hymba-1.5b")
    hargs = ssd_inputs(*hshape, bf, 27)
    pshape = ssd_prompt_shape(PRIME_PROMPT)
    require(pshape[:5] in shapes.get("ssd_scan", {}),
            f"ssd_scan saw no call at the prime prefill's shape {pshape}")
    G, _ = k.ssd.scratch_plan(*pshape)
    prime_call = MeasuredCall(
        list(pshape), ssd_inputs(*pshape, bf, 35), {"return_state": True},
        k.ssd.ssd_scan, k.ssd_ref.ssd_scan_chunked_ref,
        *ssd_work(pshape, 2), BF16_TENSOR_OPS_PER_S, 5, SSD_TOL_SCALE,
        per_call=-(-pshape[1] // G))
    # name: (source, TPU kernel, device kernel names, run of the launches,
    #        the main shape's MeasuredCall, hymba-1.5b's MeasuredCall)
    specs = {
        "flash_attention": (
            FA_SRC, FA_TPU, FA_KERNELS, SERVE_ARCH, MeasuredCall(
            [list(q.shape), list(kk.shape)], (q, kk, v), {},
            k.fa.flash_attention, k.fa_ref.flash_attention_ref,
            2 * (2 * q.numel() + kk.numel() + v.numel()),
            4 * B * H * D * pairs, BF16_TENSOR_OPS_PER_S, 20, 1,
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)),
            MeasuredCall(
                [list(hq.shape), list(hk.shape)], (hq, hk, hv),
                {"window": win}, k.fa.flash_attention,
                k.fa_ref.flash_attention_ref,
                2 * (2 * hq.numel() + hk.numel() + hv.numel()),
                4 * SERVE_BATCH * hcfg.n_heads * hcfg.hd * attention_pairs(
                    hspec.prompt, True, win),
                BF16_TENSOR_OPS_PER_S, 20, 1)),
        "rmsnorm": (
            RN_SRC, RN_TPU, "rmsnorm_kernel", SERVE_ARCH, MeasuredCall(
            [list(x.shape)], (x, w), {"eps": 1e-6}, k.rn.rmsnorm,
            k.rn_ref.rmsnorm_ref, 2 * 2 * x.numel() + 4 * w.numel(),
            4 * x.numel(), CORE_OPS_PER_S, 200, 1,
            lambda: F.rms_norm(x, (x.shape[-1],), w.to(bf), 1e-6)), None),
        "ssd_scan": (
            SSD_SRC, SSD_TPU, SSD_KERNELS, SSD_ARCH, MeasuredCall(
            [[sB, snc, sQ, snh, shd], [sB, snc, sQ, sns]], ssd_args,
            {"return_state": True}, k.ssd.ssd_scan,
            k.ssd_ref.ssd_scan_chunked_ref,
            *ssd_work((sB, snc, sQ, snh, shd, sns), 2),
            BF16_TENSOR_OPS_PER_S, 20, SSD_TOL_SCALE),
            MeasuredCall(
                list(hshape), hargs, {"return_state": True}, k.ssd.ssd_scan,
                k.ssd_ref.ssd_scan_chunked_ref, *ssd_work(hshape, 2),
                BF16_TENSOR_OPS_PER_S, 20, SSD_TOL_SCALE)),
    }
    rows, f32_ms = [], {}
    for name, (source, replaces, kname, run, main_call,
               other_call) in specs.items():
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[run].get(name, 0),
               "launches_run": run,
               "launches_by_run": {a: c.get(name, 0)
                                   for a, c in launches.items()}}
        row.update(main_call.measure(kname, f"{name} at the serve shape"))
        log(f"{name} at {row['shape']} bf16: kernel {row['ms']:.4f} ms per "
            f"call (device {row['device_ms']} ms, L2 flushed "
            f"{row['device_cold_ms']} ms), plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']} ms, bound {row['bound_ms']:.6f} ms "
            f"by {row['bound_by']} ({row['bytes']} B, {row['operations']} "
            f"operations; at the 67 TFLOP/s f32 CUDA-core rate "
            f"{row['operations'] / CORE_OPS_PER_S * 1e3:.4f} ms), max abs "
            f"error {row['max_abs_err']:.3g}")
        if other_call is not None:
            row["other_shape"] = {"arch": "hymba-1.5b", **other_call.measure(
                kname, f"{name} at the hymba-1.5b serve shape")}
            log(f"{name} at the hymba-1.5b serve shape bf16: "
                f"{row['other_shape']}")
            # the f32 path (the CUDA-core kernel) at both serve shapes
            for arch, call in ((run, main_call), ("hymba-1.5b", other_call)):
                f32_ms[f"{name} {arch}"] = call.f32_ms()
        if name == "ssd_scan":
            row["prime_shape"] = {
                "prompt": PRIME_PROMPT, "planned_groups": prime_call.per_call,
                **prime_call.measure(kname, f"{name} at the prime prefill "
                                     f"shape")}
            row["memory_by_prompt"] = ssd_memory
            log(f"ssd_scan at the prime prefill shape {pshape} bf16 "
                f"({prime_call.per_call} groups): {row['prime_shape']}")
        rows.append(row)
    log("f32 paths (CUDA-core kernels) at the serve shapes, ms per call: "
        + json.dumps(f32_ms))
    return rows


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this run needs the card", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    import repro_torch.core.apis  # noqa: F401  (populate the registry)
    from repro_torch.core import encode_backend as eb
    from repro_torch.core import recorder, streaming
    from repro_torch.core.apis import posix
    from repro_torch.core.comm import run_process_world, run_thread_world
    from repro_torch.core.patterns import IntraPatternTracker
    from repro_torch.core import trace_format
    from repro_torch.core.reader import TraceReader
    from repro_torch.core.sequitur import Sequitur, expand_grammar
    from repro_torch.core.specs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_encode import ops as de_ops
    from repro_torch.kernels.delta_encode import ref as de_ref
    from repro_torch.kernels.grammar_stats import ops as gs_ops
    from repro_torch.kernels.grammar_stats import ref as gs_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.rmsnorm import ref as rn_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    from repro_torch.traceserve import QUERY_FAMILIES, TraceService
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models.convert import flat_params
    from repro_torch.serve import ServeEngine

    k = SimpleNamespace(de=de_ops, de_ref=de_ref, gs=gs_ops, gs_ref=gs_ref,
                        fa=fa_ops, fa_ref=fa_ref, rn=rn_ops, rn_ref=rn_ref,
                        ssd=ssd_ops, ssd_ref=ssd_ref)
    # the tracer's kernels; uvarint_encode64 (lens and byte planes),
    # row_boundaries (a row-change mask) and digram_codes (the pair code
    # of every position) stay the direct counterparts of the Pallas
    # kernels, but the main path runs their successors uvarint_pack64,
    # row_run_starts and digram_counts and must not launch them
    wrappers = ((de_ops, "delta_zigzag"), (de_ops, "uvarint_pack64"),
                (de_ops, "fit_columns"), (gs_ops, "row_run_starts"),
                (de_ops, "delta_zigzag_varint"), (gs_ops, "histogram"),
                (gs_ops, "digram_counts"))
    counterparts = ((de_ops, "uvarint_encode64"), (gs_ops, "row_boundaries"),
                    (gs_ops, "digram_codes"))
    model_wrappers = ((fa_ops, "flash_attention"), (rn_ops, "rmsnorm"),
                      (ssd_ops, "ssd_scan"))
    p = SimpleNamespace(eb=eb, recorder=recorder, posix=posix,
                        Recorder=recorder.Recorder,
                        RecorderConfig=recorder.RecorderConfig,
                        session=recorder.session, REGISTRY=REGISTRY,
                        run_thread_world=run_thread_world,
                        run_process_world=run_process_world, build=_build,
                        TraceReader=TraceReader, Sequitur=Sequitur,
                        IntraPatternTracker=IntraPatternTracker,
                        expand_grammar=expand_grammar,
                        trace_format=trace_format, TraceService=TraceService,
                        QUERY_FAMILIES=QUERY_FAMILIES)
    srv = SimpleNamespace(get_config=get_config,
                          get_smoke_config=get_smoke_config,
                          get_model=get_model, ServeEngine=ServeEngine,
                          flat_params=flat_params, build=_build,
                          session=recorder.session,
                          RecorderConfig=recorder.RecorderConfig,
                          TraceReader=TraceReader)
    # f32 products in full f32 (PyTorch's default, stated): the f32 checks
    # against plain versions assume it
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    require(eb.default_backend() == "cuda", "cuda must be the default")
    shutil.rmtree(WORK, ignore_errors=True)
    t_all = time.monotonic()

    with Phase("build"):
        build_s = phase_build(_build)
    ssm_calls = ssm_serve_kernel_calls(srv)
    with Phase("kernels"):
        ssd_memory = phase_kernels(k, ssm_calls)

    # the main paths: the tracer's (phases 3-6) and the serving runs of
    # phases 7-8; counts start at 0 just before each and are read just
    # after (phase_serve does so around its traced run).  A shim records
    # the shape each wrapper is called with (the wrapper itself counts its
    # launches).
    shapes = collections.defaultdict(collections.Counter)
    run_inputs = []    # the largest row_run_starts call's (V, diff)
    lock = threading.Lock()
    originals = []
    for mod, name in wrappers + counterparts + model_wrappers:
        real = getattr(mod, name)

        def shim(*args, _real=real, _name=name, **kw):
            with lock:
                shapes[_name][tuple(args[0].shape)] += 1
                if _name == "row_run_starts" and args[0].numel() > max(
                        (a[0].numel() for a in run_inputs), default=-1):
                    run_inputs[:] = [(args[0].cpu(), bool(
                        args[1] if len(args) > 1 else kw.get("diff")))]
            return _real(*args, **kw)
        originals.append((mod, name, real))
        setattr(mod, name, shim)
    # the calls that must launch one kernel each: every varint pack, run
    # scan and digram count on cuda, and every streaming flush on cuda,
    # whatever its blocks
    packs, flushes = collections.Counter(), []

    def pack_shim(values, backend, _real=eb.pack_uvarints_batch):
        if backend == "cuda" and len(values):
            with lock:
                packs["cuda"] += 1
        return _real(values, backend)

    def starts_shim(V, backend=None, diff=False, _real=eb.run_starts):
        rows = len(V) - int(diff)
        if rows > 0 and eb.resolve(backend, rows) == "cuda":
            with lock:
                packs["run_starts"] += 1
        return _real(V, backend, diff)

    def digram_shim(stream, n_terminals, backend=None,
                    _real=eb.digram_histogram):
        if len(stream) >= 2 and eb.resolve(backend, len(stream)) == "cuda":
            with lock:
                packs["digrams"] += 1
        return _real(stream, n_terminals, backend)

    def flush_shim(ticks, block_records, backend=None,
                   _real=streaming.compress_timestamps_blocked):
        before = _build.launch_counts().get("delta_zigzag", 0)
        blocks = _real(ticks, block_records, backend=backend)
        after = _build.launch_counts().get("delta_zigzag", 0)
        if len(ticks) and eb.resolve(backend, len(ticks)) == "cuda":
            flushes.append((len(ticks), block_records, len(blocks),
                            after - before))
        return blocks
    for mod, name, fn in ((eb, "pack_uvarints_batch", pack_shim),
                          (eb, "run_starts", starts_shim),
                          (eb, "digram_histogram", digram_shim),
                          (streaming, "compress_timestamps_blocked",
                           flush_shim)):
        originals.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)
    _build.reset_launches()
    try:
        with Phase("ior"):
            ior_runs, ior_counts = phase_ior(p)
        with Phase("facade"):
            phase_facade(p)
        with Phase("patterns"):
            phase_patterns(p)
        with Phase("read"):
            read_inputs = phase_read(p)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        n_packs, main_flushes = packs["cuda"], list(flushes)
        n_scans, n_digrams = packs["run_starts"], packs["digrams"]
        with Phase("multiproc"):
            multiproc = phase_multiproc(p, ior_runs, ior_counts)
        serves = {}
        with Phase("serve"):
            serves[SERVE_ARCH] = phase_serve(srv, SERVE_SPECS[0])
        with Phase("serve_ssm"):
            for spec in SERVE_SPECS[1:]:
                serves[spec.arch] = phase_serve(srv, spec)
            prime = prime_prefill(srv, SERVE_SPECS[1])
    finally:
        for mod, name, real in originals:
            setattr(mod, name, real)
    serve_counts = {a: r["launches"] for a, r in serves.items()}
    serve_counts[f"{prime['arch']}@{PRIME_PROMPT}"] = prime["launches"]
    log(f"main-path launches, phases 3-6: {launches}; serve runs: "
        f"{serve_counts}")
    for _mod, name in wrappers:
        require(launches.get(name, 0) > 0,
                f"{name} was not launched on the main path")
        log(f"{name} main-path shapes: {dict(shapes[name].most_common(4))}")
    for _mod, name in counterparts:
        require(launches.get(name, 0) == 0,
                f"{name} was launched on the main path")
    require(launches.get("uvarint_pack64", 0) == n_packs,
            f"{n_packs} varint packs on cuda launched uvarint_pack64 "
            f"{launches.get('uvarint_pack64', 0)} times")
    require(bool(main_flushes) and all(n == 1 for *_, n in main_flushes),
            f"streaming flushes on cuda launched delta_zigzag "
            f"{[n for *_, n in main_flushes]} times each")
    require(any(b > 1 for _, _, b, _ in main_flushes),
            "no streaming flush on cuda wrote more than one block")
    # one encode_many and one push_stream on cuda (phase 5); one digram
    # count a rank and one a unique grammar of the aggregate (phase 6)
    require(n_scans == 2 and launches.get("row_run_starts", 0) == n_scans,
            f"{n_scans} run scans on cuda (want 2) launched row_run_starts "
            f"{launches.get('row_run_starts', 0)} times")
    want_digrams = N_RANKS + read_inputs["n_grammars"]
    require(n_digrams == want_digrams
            and launches.get("digram_counts", 0) == n_digrams,
            f"{n_digrams} digram counts on cuda (want {want_digrams}) "
            f"launched digram_counts {launches.get('digram_counts', 0)} "
            f"times")
    log(f"main path: {n_scans} run scans on cuda, one row_run_starts "
        f"launch each, no row_boundaries; {n_digrams} digram counts on "
        f"cuda ({N_RANKS} ranks, {read_inputs['n_grammars']} unique "
        f"grammar(s)), one digram_counts launch each, no digram_codes")
    log(f"main path: {n_packs} varint packs on cuda, one uvarint_pack64 "
        f"launch each, no uvarint_encode64; {len(main_flushes)} streaming "
        f"flushes on cuda ((records, records a block, blocks): flushes "
        f"{sorted(collections.Counter(f[:3] for f in main_flushes).items())}"
        f"), one delta_zigzag launch each")
    for _mod, name in model_wrappers:
        runs = [a for a, c in serve_counts.items() if c.get(name, 0) > 0]
        require(bool(runs), f"{name} was not launched on a serve main path")
        log(f"{name} launched in the serve runs of {runs}; shapes: "
            f"{dict(shapes[name].most_common(4))}")
    for name, calls in ssm_calls.items():
        for call in calls:
            require(call[0] in shapes[name],
                    f"{name}: the kernels phase checked {call[0]}, which "
                    f"no serve run gave it")
    log("serve summary: " + json.dumps(
        {a: {k: v for k, v in r.items() if k != "top_kernels"}
         for a, r in serves.items()}))
    log("prime prefill summary: " + json.dumps(prime))
    log("multiproc summary: " + json.dumps(multiproc))

    with Phase("report"):
        rows = kernel_report(k, p, shapes, launches, read_inputs,
                             run_inputs[0])
        rows += model_kernel_report(k, srv, shapes, serve_counts, ssd_memory)
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"total {time.monotonic() - t_all:.1f} s (build {build_s:.2f} s)")
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"gpu: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
