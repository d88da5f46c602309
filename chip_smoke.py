#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of the Recorder write path.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports only ``repro_torch``, ``torch``, ``numpy`` and the standard
library, builds the port's CUDA kernels from ``src/repro_torch/kernels/
csrc`` and then runs, in order:

1. build     -- compile every kernel source (one nvcc each, in parallel);
2. kernels   -- each kernel against its plain PyTorch version on the card,
                exact, at edge and full sizes;
3. IOR       -- the main path: 32 ranks x 16,384 lseek+write iterations
                (paper Listing 3, 1 MiB transfers to one shared file) as
                ThreadComm ranks, finalized tree and flat on the ``cuda``
                backend and once on ``numpy``; all ``*.bin`` bytes must
                agree and the port's reader must give back the offsets;
4. facade    -- one rank through ``session`` + the ``posix`` facade (real
                file I/O, deterministic clock), one-shot and streaming,
                ``cuda`` against ``numpy`` bytes;
5. patterns  -- the batched pattern encoders (``encode_many``,
                ``push_stream``) on the card, against ``numpy``;
6. report    -- the kernels' launch counts from phases 3-5 (each must be
                above 0) and their times at the shapes phases 3-5 gave
                them, as one JSON line.

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


def phase_kernels(k) -> None:
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
    for c, r in ((4096, 32), (1, 2), (257, 3), (32, 32)):
        for base in (0, 1 << 31, (1 << 61)):
            V = torch.from_numpy(fit_matrix(c, r, c + r, base)).to(dev)
            f, d = k.de.fit_columns(V)
            fp, dp = k.de_ref.fit_columns_ref(V)
            same(f, fp, f"fit_columns flags {c}x{r} base={base}")
            same(d, dp, f"fit_columns d0 {c}x{r} base={base}")
    log("fit_columns exact at (4096, 32), (1, 2), (257, 3), (32, 32), "
        "values >= 2^31")
    for n, kk in ((65535, 3), (1, 1), (257, 1), (4099, 2)):
        for base in (0, 1 << 40):
            R = np.random.RandomState(n).randint(0, 2, size=(n, kk)) + base
            R = torch.from_numpy(R.astype(np.int64)).to(dev)
            same(k.gs.row_boundaries(R), k.gs_ref.row_boundaries_ref(R),
                 f"row_boundaries ({n}, {kk}) base={base}")
    log("row_boundaries exact at (65535, 3), (1, 1), (257, 1), (4099, 2)")


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


def run_ior(p, trace_dir: str, topology: str, backend: str) -> None:
    """One IOR job: ranks are threads feeding ``Recorder.record`` with
    explicit ticks (the facade's wrapper slot is process-global)."""
    fid = {n: p.REGISTRY.id_of(n)
           for n in ("open", "lseek", "write", "fsync", "close")}
    path = "/scratch/ior/testFile"

    def worker(comm, rank):
        rec = p.Recorder(rank=rank, config=p.RecorderConfig(
            finalize_topology=topology, encode_backend=backend))
        t = iter(ior_ticks(rank).tolist())
        fd = 3
        rec.record(fid["open"], (path, os.O_RDWR | os.O_CREAT, 0o644), fd,
                   0, *next(t))
        for i in range(N_ITER):
            off = rank * XFER + i * N_RANKS * XFER
            rec.record(fid["lseek"], (fd, off, 0), off, 0, *next(t))
            rec.record(fid["write"], (fd, XFER), XFER, 0, *next(t))
        rec.record(fid["fsync"], (fd,), 0, 0, *next(t))
        rec.record(fid["close"], (fd,), 0, 0, *next(t))
        rec.forget_handle(fd)
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


def phase_ior(p) -> dict:
    from torch.profiler import ProfilerActivity, profile
    runs = {}
    for name, topology, backend in (("tree-cuda", "tree", BACKEND),
                                    ("flat-cuda", "flat", BACKEND),
                                    ("tree-numpy", "tree", "numpy")):
        d = os.path.join(WORK, "ior", name)
        p.eb.set_default_backend(backend)
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.monotonic()
                run_ior(p, d, topology, backend)
                torch.cuda.synchronize()
                secs = time.monotonic() - t
        finally:
            p.eb.set_default_backend(BACKEND)
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
        f"offset, size and tick")
    return runs


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
                      ("stream", {"flush_every_n_records": 4096})):
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


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 200) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after warm-up."""
    for _ in range(5):
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


def device_kernel_ms(fn, kernel: str, iters: int = 20):
    """Mean device time per call of the CUDA kernel whose name contains
    ``kernel``, from torch.profiler; None when the profile has none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if kernel in e.key)
    return total / iters / 1e3 if total else None


def host_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def main_path_inputs(shapes: dict) -> dict:
    """Inputs at the largest shape each kernel saw in phases 3-5."""
    def top(name):
        require(bool(shapes.get(name)), f"{name} saw no main-path call")
        return max(shapes[name], key=lambda s: int(np.prod(s)))

    rng = np.random.RandomState(11)
    (n_dz,) = top("delta_zigzag")
    (n_uv,) = top("uvarint_encode64")
    c, r = top("fit_columns")
    n_rb, k_rb = top("row_boundaries")
    return {
        "delta_zigzag": tick_stream(n_dz, "mono", 1).view(np.int32),
        "uvarint_encode64": ragged_u64(n_uv, 2).view(np.int64),
        "fit_columns": fit_matrix(c, r, 3, 0),
        "row_boundaries": rng.randint(0, 3, size=(n_rb, k_rb))
        .astype(np.int64),
    }


def kernel_report(k, p, shapes: dict, launches: dict) -> list:
    dev = torch.device("cuda")
    inputs = main_path_inputs(shapes)
    specs = {
        "delta_zigzag": (
            k.de.delta_zigzag, k.de_ref.delta_zigzag_ref,
            "src/repro_torch/kernels/csrc/delta_encode.cu",
            "src/repro/kernels/delta_encode/delta_encode.py:40",
            lambda x: 8 * x.numel(), lambda x: 6 * x.numel()),
        "uvarint_encode64": (
            k.de.uvarint_encode64, k.de_ref.uvarint_encode64_ref,
            "src/repro_torch/kernels/csrc/delta_encode.cu",
            "src/repro/kernels/delta_encode/delta_encode.py:155",
            lambda x: 22 * x.numel(), lambda x: 60 * x.numel()),
        "fit_columns": (
            k.de.fit_columns, k.de_ref.fit_columns_ref,
            "src/repro_torch/kernels/csrc/delta_encode.cu",
            "src/repro/kernels/delta_encode/delta_encode.py:202",
            lambda x: 8 * x.numel() + 12 * x.shape[0],
            lambda x: 4 * x.numel()),
        "row_boundaries": (
            k.gs.row_boundaries, k.gs_ref.row_boundaries_ref,
            "src/repro_torch/kernels/csrc/grammar_stats.cu",
            "src/repro/kernels/grammar_stats/grammar_stats.py:48",
            lambda x: 8 * x.numel() + x.shape[0], lambda x: 2 * x.numel()),
    }
    host_calls = {
        "delta_zigzag": lambda a, b: p.eb.delta_zigzag(
            a.view(np.uint32).astype(np.int64), b),
        "uvarint_encode64": lambda a, b: p.eb.pack_uvarints_batch(
            a.view(np.uint64), b),
        "fit_columns": lambda a, b: p.eb.fit_classify(a, b),
        "row_boundaries": lambda a, b: p.eb.run_boundaries(a, b),
    }
    rows = []
    for name, (kern, plain, source, replaces, nbytes, nops) in specs.items():
        host = inputs[name]
        x_cpu = torch.from_numpy(np.ascontiguousarray(host))
        x = x_cpu.to(dev)
        out = kern(x)
        ref = plain(x)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((o.to(torch.float64) - q.to(torch.float64))
                        .abs().max()) if o.numel() else 0.0
                  for o, q in zip(outs, refs))
        require(err == 0.0, f"{name}: kernel != plain at the main path shape")
        ms = cuda_ms(lambda: kern(x))
        device_ms = device_kernel_ms(lambda: kern(x), f"{name}_kernel")
        plain_ms = cuda_ms(lambda: plain(x))
        h2d_ms = cuda_ms(lambda: x_cpu.to(dev), iters=50)
        d2h_ms = cuda_ms(lambda: [o.cpu() for o in outs], iters=50)
        bytes_ms = nbytes(x) / HBM_BYTES_PER_S * 1e3
        ops_ms = nops(x) / CORE_OPS_PER_S * 1e3
        call = host_calls[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "shape": list(x.shape), "device_ms": device_ms,
            "h2d_ms": h2d_ms, "d2h_ms": d2h_ms,
            "dispatch_cuda_ms": host_ms(lambda: call(host, "cuda")),
            "dispatch_numpy_ms": host_ms(lambda: call(host, "numpy")),
        })
        log(f"{name} at {list(x.shape)}: kernel {ms:.4f} ms per call "
            f"(device {device_ms} ms), plain "
            f"{plain_ms:.4f} ms, bound {rows[-1]['bound_ms']:.6f} ms, "
            f"H2D {h2d_ms:.4f} ms, D2H {d2h_ms:.4f} ms; dispatch cuda "
            f"{rows[-1]['dispatch_cuda_ms']:.4f} ms vs numpy "
            f"{rows[-1]['dispatch_numpy_ms']:.4f} ms")
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
    from repro_torch.core import recorder
    from repro_torch.core.apis import posix
    from repro_torch.core.comm import run_thread_world
    from repro_torch.core.patterns import IntraPatternTracker
    from repro_torch.core.reader import TraceReader
    from repro_torch.core.sequitur import Sequitur
    from repro_torch.core.specs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_encode import ops as de_ops
    from repro_torch.kernels.delta_encode import ref as de_ref
    from repro_torch.kernels.grammar_stats import ops as gs_ops
    from repro_torch.kernels.grammar_stats import ref as gs_ref

    k = SimpleNamespace(de=de_ops, de_ref=de_ref, gs=gs_ops, gs_ref=gs_ref)
    p = SimpleNamespace(eb=eb, recorder=recorder, posix=posix,
                        Recorder=recorder.Recorder,
                        RecorderConfig=recorder.RecorderConfig,
                        session=recorder.session, REGISTRY=REGISTRY,
                        run_thread_world=run_thread_world,
                        TraceReader=TraceReader, Sequitur=Sequitur,
                        IntraPatternTracker=IntraPatternTracker)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    require(eb.default_backend() == "cuda", "cuda must be the default")
    shutil.rmtree(WORK, ignore_errors=True)
    t_all = time.monotonic()

    with Phase("build"):
        build_s = phase_build(_build)
    with Phase("kernels"):
        phase_kernels(k)

    # the main path, phases 3-5: counts start at 0 here and are read after;
    # a shim records the shape each wrapper is called with (the wrapper
    # itself counts its launches)
    shapes = collections.defaultdict(collections.Counter)
    lock = threading.Lock()
    originals = []
    for mod, name in ((de_ops, "delta_zigzag"), (de_ops, "uvarint_encode64"),
                      (de_ops, "fit_columns"), (gs_ops, "row_boundaries")):
        real = getattr(mod, name)

        def shim(*args, _real=real, _name=name):
            with lock:
                shapes[_name][tuple(args[0].shape)] += 1
            return _real(*args)
        originals.append((mod, name, real))
        setattr(mod, name, shim)
    _build.reset_launches()
    try:
        with Phase("ior"):
            phase_ior(p)
        with Phase("facade"):
            phase_facade(p)
        with Phase("patterns"):
            phase_patterns(p)
    finally:
        for mod, name, real in originals:
            setattr(mod, name, real)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    log(f"main-path launches: {launches}")
    for name in ("delta_zigzag", "uvarint_encode64", "fit_columns",
                 "row_boundaries"):
        require(launches.get(name, 0) > 0,
                f"{name} was not launched on the main path")
        log(f"{name} main-path shapes: {dict(shapes[name].most_common(4))}")

    with Phase("report"):
        rows = kernel_report(k, p, shapes, launches)
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
