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
                CUDA-core ones; and each model kernel's autograd Function
                (forward on the kernel, backward by recomputing the plain
                version) against plain autograd: every input gradient
                equal bit for bit, f32 and bf16, at prime lengths, hymba's
                windowed attention and the train phase's shapes; and the
                SSD scan's backward kernel ``ssd_scan_bwd`` against the
                plain version's autograd (each gradient's largest error
                within SSD_BWD_TOL of its largest value), two calls
                bit-identical, one launch a call;
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
7a. durability -- the write path's faults and recovery on ``cuda``:
                phase 3's IOR cut to 2,048 iterations a rank (4,099
                records) on 32 ThreadComm ranks, a flush every 1,024
                records (4 epochs and finalize's tail), in five jobs:
                synchronous flushes; async flushes, each drained, whose
                commit runs on the recorder's pool thread (the bytes must
                be job 1's); rank 1 mute in epoch 2 (a seeded
                ``FaultPlan``, the degraded protocol): ``ranks_present``
                must leave rank 1 out of epoch 2 only, its records ride
                epoch 3, and the bytes must be the same job's on
                ``numpy``; rank 0's commit of epoch 2 crashes at
                ``pre-manifest``, then a restarted job records from epoch
                2 into the same directory (the bytes, ``merged/``
                included, must be job 1's); a torn ``timestamps.bin`` in
                epoch 2 must be caught by the checksum and reported by
                ``check_trace_invariants``.  Every flush on ``cuda`` must
                launch ``delta_zigzag`` once on the thread that ran it
                (the rank's, or its pool thread's), counted where the
                kernel launches (``_build.thread_launch_counts``).  Then the crash case
                on 4 processes over ``TorchDistComm`` (rank 0's commit of
                epoch 2 crashing: a ``WorldError`` naming rank 0; a
                second world resumes),
                whose directory must be the same calls' uninterrupted
                ThreadComm run's.  It prints each job's wall time, flush
                and drain times and device busy time;
7b. finalize_scaling -- ``workloads.synth_rank_states(2048, n_groups=32,
                n_calls=64, pattern="mixed_all")`` (synthesized on
                ``numpy``), finalized flat on ``cuda`` (one
                ``fit_columns`` launch), tree on ``cuda`` and flat on
                ``numpy``: the written ``*.bin`` bytes must be equal; it
                prints each finalize's seconds, launches and device busy
                time;
8. serve     -- the model workload the tracer watches: qwen3-32b at every
                published width, 8 of its 64 layers, bf16, random weights
                from a seeded generator, served by ``ServeEngine`` (4
                prompts of 1,024 tokens, 32 new tokens each) on the kernel
                path inside a ``session``; the trace must read back 31
                ``serve_step`` records, the model kernels must be launched
                as often as the structure implies, and the same weights
                and prompts run again on the plain ``"torch"`` attention
                path to compare with; the qwen3-32b smoke model on the
                card must give the CPU's logits and tokens; a request that
                would decode past ``max_seq`` on its dense KV cache must
                raise ``ValueError`` before any launch;
9. serve_ssm -- the same for the SSM family, mamba2-370m at full depth (48
                layers), and the hybrid one, hymba-1.5b at full depth (32
                layers), with 4 prompts of 2,048 tokens each; their plain
                run flips both ``attn_impl`` and ``ssm_impl`` to
                ``"torch"``; then a mamba2 prefill of 4 prompts of 2,053
                tokens (a prime: Q 1) at 16 of its 48 layers, kernel path
                against plain path, with its peak memory;
9b. serve_moe_mla_vlm -- the same for deepseek-moe-16b (14 of its 28
                layers: one dense, then 64 routed experts top-6 and 2
                shared), deepseek-v2-lite-16b (14 of its 27 layers: MLA
                and MoE) and llava-next-34b (8 of 60 layers, 2,880 seeded
                patch embeddings before the 1,024 tokens of each prompt,
                GQA group 7); MoE's plain run is held with the kernel
                path's routing replayed and prints the routing flips of
                each MoE layer, freely routed and replayed; MLA has no
                plain run (its attention is the plain path whatever
                ``attn_impl`` says; its one kernel, RMSNorm on the latent,
                is held in the kernels phase at (4, 1,024, 512) and (4, 1,
                512)); f32 at 4 layers for MoE and the VLM;
9c. serve_encdec -- the same for the encoder-decoder,
                seamless-m4t-large-v2 at full depth (24 encoder and 24
                decoder layers), 1,024 seeded frames and 128 target tokens
                a prompt, max_seq 2,048, so that decode masks the cross
                attention to the encoder's length; the encoder runs the
                flash kernel without a causal mask, the decoder with one
                (48 launches a prefill); frames past max_seq must be
                refused before any launch; f32 at 4 + 4 layers against
                the plain path, and 8 decode steps fed the true next
                tokens against ``train_forward``'s logits;
10. train    -- the training workload: mamba2-370m at its published
                widths and depth (48 layers), bf16 compute with f32 master
                weights and moments, block remat, 4 x 1,024 synthetic
                tokens a step, inside a ``session`` on the ``cuda`` encode
                backend: step 1's gradient of every parameter leaf finite
                and non-zero on the kernel path and its loss within bf16
                2e-2 of the plain path's; a ``Trainer`` takes 4 steps and
                checkpoints (about 5 GB, keep 1), a new one auto-resumes
                with a bit-identical state and takes 2 more; ``ssd_scan``
                and ``rmsnorm`` counted step by step (48 each a forward,
                twice that under block remat; ``ssd_scan_bwd`` 48 a
                backward), the finalize's
                ``delta_zigzag`` and ``uvarint_pack64``, and the trace
                read back (6 ``step`` records, the checkpoint's
                ``shard_write_at`` and ``shard_read_at`` calls); one
                profiled step; every leaf's f32 gradient (the SSD's
                forward and backward kernels) within relative L2 1e-3 of
                the plain path's (no SSD kernel in either pass) at full
                width and 4 layers (2e-2 at 48, where f32 rounding alone
                moves some leaves by 7e-3); then
                qwen1.5-0.5b (all 24 layers, bf16) for flash attention's
                gradient: the same guard and loss check and 2 steps; then
                deepseek-moe-16b at full width, 3 layers (one dense, two
                MoE): the same guard (the router's and every expert's
                gradient finite and non-zero) and a ``Trainer``'s 2 steps,
                loss, aux and gradient norm finite, aux above 0; then
                seamless-m4t-large-v2 at full width and depth on the train
                launcher's data (4 x 1,024 frames and tokens): the same
                guard and loss check and a ``Trainer``'s 2 steps, each
                run's peak memory under 70 GB above what it began with.
                It
                prints step time, tokens/s, device busy and idle share,
                peak memory, checkpoint seconds and bytes and the trace's
                records and bytes beside the card's name and power limit;
11. evaluation -- the paper's size evaluation through the port's
                ``run_ranks`` and baselines on the ``cuda`` backend, at the
                reference scripts' rank counts: Figs 4-5 (IOR, 4-64 ranks,
                32-1,024 calls, patterns on and off), Fig 6 (FLASH, 60
                iterations, 4 to 512 ranks: Recorder's pattern bytes within
                16 B, Recorder-old's growing; growing and rolling files at
                8 ranks), Fig 7 (collective, 64 and 1,024 ranks), Table 4
                (16, 64 and 256 ranks, 100 iterations, both modes:
                Recorder-old over 5x Recorder, Darshan-like beside them),
                each job recorded once and finalized flat on ``cuda``, then
                again flat on ``numpy`` (sizes and bytes equal) and, but in
                Fig 7, tree (sizes equal); one
                ``fit_columns`` launch a fit dispatch (at least one where
                ranks have groups to fit, up to (groups, 1,024)) and one
                ``delta_zigzag`` a rank with timestamps on, counts set to 0
                before each job; then Fig 10, the record-path cost of no
                tool, Recorder, Recorder-old and Darshan-like (one rank,
                1,000 iterations, best of 3), printed only;
11a. sharded -- the sharding layer's real path on the card: a one-rank
                NCCL group and a (1, 1) ("data", "model") mesh;
                ``launch.steps.build_cell`` with full parameters drives
                qwen3-32b x 8 (bf16, a prefill of 4 x 1,024 tokens and
                32 greedy decode steps), mamba2-370m x 48 (the same with
                4 x 2,048) and qwen1.5-0.5b x 24 (2 train steps, ZeRO-1
                over the one-rank data axis) as DTensors, each held
                against the unsharded path on the same weights and inputs
                on the card: tokens, logits, losses and new master
                bit-identical, and as many flash attention, RMSNorm and
                SSD launches (counts set to 0 before each path), both
                paths timed; first, RMSNorm's host cost a call through
                its operator against its wrapper;
11b. dryrun  -- ``launch.dryrun`` on a fake 256-rank group under
                ``FakeTensorMode`` on ``cuda``: every applicable cell on
                the single-pod mesh and qwen3-32b and deepseek-moe-16b on
                the multi-pod one, in worker processes that start after
                the build and run beside phases 2-3 (fake tensors launch
                nothing on the card; the phase reads their results and
                checks them); each prints its
                status, seconds, per-chip argument and peak-estimate
                bytes, FLOPs a chip against ``model_flops_per_chip``,
                collective bytes by kind, H100 roofline terms and
                bottleneck, whether it fits in 80 GB and the gathers of
                the port's own layout it includes; no cell may fail and
                ``long_500k`` is a SKIP for the eight full-attention
                architectures; four cells run again on ``cpu`` fake
                tensors must give the same FLOPs and collective bytes,
                and but in decode the same peak; then the roofline
                report (``launch.roofline.analyze_cell``) of four cells,
                qwen3-32b ``train_4k``, mamba2-370m ``prefill_32k``,
                deepseek-moe-16b ``decode_32k`` and hymba-1.5b
                ``long_500k``, in the dry run's worker processes: their
                extrapolated FLOPs and collective bytes must be the dry
                run's (the clamp of a negative per-layer delta must not
                bind), and ``report()`` prints their table;
11c. examples -- ``examples/torch_quickstart.py`` (4 steps) and
                ``examples/torch_workflow_analysis.py`` on the card with the
                ``cuda`` encode backend, their traces read back;
12. report   -- the kernels' launch counts from phases 3-6 and from the
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
                (``other_shape``), flash attention at llava-next-34b's and
                seamless-m4t-large-v2's encoder's, and their f32 paths
                (the CUDA-core kernels) at the serve shapes on a line
                before it; each
                row also carries its ``evaluation_launches``.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the run exits non-zero and prints no such line.  Without a
CUDA card, or without the rest of the repository beside it, it fails.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import warnings
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
# activations at the same width and ``f32_layers`` layers (the serve run's
# depth when None).  ``plain`` is None where ``attn_impl`` switches no
# kernel of the model.  A MoE model's plain path is held with the kernel
# path's routing replayed (``RouteLog``); its own routing is compared and
# its flips counted.  A VLM's prompt is its ``n_patches`` patch embeddings
# and then ``prompt`` tokens; an encoder-decoder's is ``frames`` frame
# embeddings beside ``prompt`` target tokens, and ``layers`` and
# ``f32_layers`` cut its encoder as its decoder.
ServeSpec = collections.namedtuple(
    "ServeSpec", "arch layers of prompt max_seq plain rtol f32_rtol "
    "f32_layers frames", defaults=(None, 0))
SERVE_SPECS = (
    # 8 of 64 layers (half a stage of four; 16 until the run's time
    # limit needed the room).  The paths differ by the bf16 rounding of p
    # in every attention, which the bf16 layers carry to the logits: the
    # 3-layer bf16 smoke model shows 1.2e-2 on the CPU.  The bound is
    # 5e-2 / 16 a layer (held at 16 layers before), times 8
    ServeSpec("qwen3-32b", 8, 64, 1024, 2048, {"attn_impl": "torch"},
              5e-2 / 16 * 8, None),
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
    # 14 of 28 layers (one dense layer, 13 MoE; full depth until the run's
    # time limit needed the room).  With the routing replayed the paths
    # differ by flash's bf16 rounding of p alone, as qwen3's do: qwen3's
    # bound a layer (5e-2 / 16, three times its reading of 1.0e-3 a layer)
    # times 14 layers.  In f32 at 4 layers the paths agree to f32
    # rounding, held to the SSM runs' f32 bound
    ServeSpec("deepseek-moe-16b", 14, 28, 1024, 2048, {"attn_impl": "torch"},
              5e-2 / 16 * 14, 1e-3, 4),
    # 14 of 27 layers (full depth until the run's time limit needed the
    # room); MLA's attention is the plain chunked path whatever attn_impl
    # says (the reference's routing), so there is no plain run: its one
    # kernel, RMSNorm on the latent, is held in the kernels phase
    ServeSpec("deepseek-v2-lite-16b", 14, 27, 1024, 2048, None, None, None),
    # 8 of 60 layers (16 until the run's time limit needed the room);
    # 2,880 patches + 1,024 tokens a prompt.  qwen3's bound a layer times
    # 8 layers; f32 at 4 layers as above
    ServeSpec("llava-next-34b", 8, 60, 1024, 4096, {"attn_impl": "torch"},
              5e-2 / 16 * 8, 1e-3, 4),
    # full depth (24 encoder + 24 decoder layers), 1,024 frames and 128
    # target tokens a prompt, max_seq 2,048, so the cross-attention mask
    # cuts the cache at the encoder's length.  The paths differ by flash's
    # bf16 rounding of p in both self-attentions (cross attention is plain
    # on both): the 2 + 2-layer bf16 smoke model reads 1.32e-2 to 1.62e-2
    # on the CPU (weight seeds 0-2, tests/test_torch_encdec.py), at most
    # 4.05e-3 an attention layer; times the 48 attention layers, 0.194,
    # held to 0.2.  f32 at 4 + 4 layers as above
    ServeSpec("seamless-m4t-large-v2", 24, 24, 128, 2048,
              {"attn_impl": "torch"}, 0.2, 1e-3, 4, 1024),
)
SERVE_ARCH = SERVE_SPECS[0].arch   # rows 8 and 9 are measured at its shapes
SSD_ARCH = SERVE_SPECS[1].arch     # row 10 at mamba2's
MODEL_KERNELS = ("flash_attention", "rmsnorm", "ssd_scan", "ssd_scan_bwd")
# tolerances of tests/test_kernels.py for kernel against plain version
# (the SSD scan is held to 5 times these there, and here)
FLOAT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSD_TOL_SCALE = 5
# the SSD backward kernel against the plain version's autograd: each
# gradient's largest error as a share of its largest value.  dx, db and dc
# carry the inputs' dtype: in bf16 the readings are 0.0007-0.0032 (a bf16
# ulp is 0.0039 of a value), so 1e-2; the f32 gradients, and ddt and dda
# (f32 whatever the inputs' dtype), read 9e-7 to 5.3e-6, so
# SSD_TOL_SCALE x FLOAT_TOL[f32] = 1e-4 (H100 80GB HBM3 at 700 W, PERF.md)
SSD_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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


def phase_kernels(k, serve_calls: dict) -> dict:
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
    return model_kernels(k, serve_calls)


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


def serve_kernel_calls(s) -> dict:
    """The flash-attention and RMSNorm calls of the serve runs after
    qwen3's, from their configurations: the prefill's attention (q shape,
    KV heads, window, causal) where it takes the flash kernel (not SSM,
    not MLA; a VLM's prompt holds its patches; an encoder-decoder's
    encoder attends over its frames without a causal mask, its decoder
    over the target tokens with one); the SSD gate norm's input in the
    prefill (B, S, nh, hd) and in decode (B, nh, hd); MLA's latent norm's
    input, a column slice of the down-projection made contiguous, in the
    prefill (B, S, kv_lora_rank) and in decode (B, 1, kv_lora_rank)."""
    calls = {"flash_attention": [], "rmsnorm": []}
    for spec in SERVE_SPECS[1:]:
        cfg = s.get_config(spec.arch)
        n_pos = spec.prompt + (cfg.n_patches if cfg.family == "vlm" else 0)
        if cfg.n_encoder_layers:
            calls["flash_attention"].append(
                ((SERVE_BATCH, spec.frames, cfg.n_heads, cfg.hd),
                 cfg.n_kv_heads, cfg.sliding_window, False))
        if cfg.family != "ssm" and not cfg.mla:
            calls["flash_attention"].append(
                ((SERVE_BATCH, n_pos, cfg.n_heads, cfg.hd),
                 cfg.n_kv_heads, cfg.sliding_window, True))
        if cfg.family == "ssm" or cfg.hybrid:
            calls["rmsnorm"] += [
                ((SERVE_BATCH, n_pos, cfg.ssm_heads, cfg.ssm_head_dim),),
                ((SERVE_BATCH, cfg.ssm_heads, cfg.ssm_head_dim),)]
        if cfg.mla:
            calls["rmsnorm"] += [((SERVE_BATCH, n_pos, cfg.kv_lora_rank),),
                                 ((SERVE_BATCH, 1, cfg.kv_lora_rank),)]
    return calls


def flash_check(k, q, kk, v, window: int, causal: bool, what: str) -> float:
    """Flash attention against its plain version, one sequence of the
    batch at a time (the plain version's f32 scores of a 3,904-token
    prompt take 3.4 GB a sequence at 56 heads)."""
    got = k.fa.flash_attention(q, kk, v, causal=causal, window=window)
    return max(close_err(got[b:b + 1], k.fa_ref.flash_attention_ref(
        q[b:b + 1], kk[b:b + 1], v[b:b + 1], causal=causal, window=window),
        what) for b in range(q.shape[0]))


def model_kernels(k, serve_calls: dict) -> dict:
    """Flash attention and RMSNorm against their plain versions: bf16 and
    f32, GQA groups 1 and 8, causal, non-causal and windowed masks, prime
    and ragged lengths, every supported head dim, the serve shapes (the
    later serve runs' from ``serve_calls``: GQA group 7 and 3,904 keys of
    llava-next-34b, RMSNorm at MLA's D 512)."""
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
        for (B, S, H, D), kvh, window, causal in \
                serve_calls["flash_attention"]:
            q = randn((B, S, H, D), 41, dtype)
            kk = randn((B, S, kvh, D), 42, dtype)
            v = randn((B, S, kvh, D), 43, dtype)
            what = (f"flash_attention at the serve shape q {(B, S, H, D)}, "
                    f"{kvh} KV heads, causal={causal}, window {window}, "
                    f"{dtype}")
            err = flash_check(k, q, kk, v, window, causal, what)
            del q, kk, v
            log(f"{what}: max abs error {err:.3g}")
        for (shape,) in serve_calls["rmsnorm"]:
            # the last dim doubled and sliced, as MLA slices the latent
            # off its down-projection, then made contiguous
            x = randn(shape[:-1] + (2 * shape[-1],), 44, dtype)
            x = x[..., :shape[-1]].contiguous()
            w = torch.rand(shape[-1], generator=torch.Generator(
                device="cuda").manual_seed(1), device="cuda")
            err = close_err(k.rn.rmsnorm(x, w, eps=1e-5),
                            k.rn_ref.rmsnorm_ref(x, w, eps=1e-5),
                            f"rmsnorm {shape} {dtype}")
            log(f"rmsnorm at the serve shape {shape} {dtype}: max abs "
                f"error {err:.3g}")
    torch.cuda.empty_cache()
    function_grad_checks(k)
    ssd_backward_checks(k)
    torch.cuda.empty_cache()
    return ssd_kernel_checks(k)


# the autograd Functions' shapes: (B, S, H, KVH, D, causal, window) of
# flash attention, rows of RMSNorm, (B, nc, Q, nh, hd, ns) of the SSD scan:
# prime lengths, lengths off the kernels' 64- and 128-row tiles, hymba's
# windowed attention at a prime length past its window, and the shapes the
# train phase gives them (qwen1.5-0.5b's attention and seamless's decoder
# self-attention, seamless's encoder without a causal mask, mamba2-370m's
# gate norm and SSD at 4 x 1,024 tokens)
GRAD_FLASH = ((2, 37, 8, 2, 64, True, 0), (1, 257, 4, 4, 128, False, 0),
              (1, 2053, 25, 5, 64, True, 1024),
              (4, 1024, 16, 16, 64, True, 0),
              (4, 1024, 16, 16, 64, False, 0))
GRAD_NORM = ((37, 64), (3, 13, 128), (4, 1024, 32, 64))
GRAD_SSD = ((2, 3, 37, 4, 64, 128), (1, 7, 1, 3, 16, 16),
            (4, 4, 256, 32, 64, 128))
# da scaled so that exp(cs_q - cs_p) above the diagonal overflows, as
# mamba2's decays do within a 256-token chunk: the gradients stay finite.
# cs then reaches -1,121 in a chunk, and cs_q - cs_p loses f32 digits in
# both versions: against the f64 plain version the f32 kernel's y is off
# by 3.10e-4 and the plain version's by 1.94e-4, the state by 4.18e-5 and
# 1.58e-5 (on an H100, PERF.md), so the two differ beyond FLOAT_TOL with
# neither at fault.  Here each output of the kernel is held to
# SSD_EXACT_RATIO times the plain version's own max abs error against the
# f64 plain version (readings 1.0-2.7).
GRAD_SSD_STRONG_DECAY = 16
SSD_EXACT_RATIO = 4


def function_grad_checks(k) -> None:
    """Each model kernel's autograd Function (forward on the kernel,
    backward by recomputing the plain version) against plain autograd
    through the plain version, on the card, f32 and bf16.  The forward
    outputs are the kernel's: each must lie within FLOAT_TOL of the plain
    version's (SSD_TOL_SCALE times that for the SSD scan, as in
    ``ssd_check``), which holds the bf16 tensor-core kernels that a
    training step launches at its own shapes; the SSD scan with
    GRAD_SSD_STRONG_DECAY against the f64 plain version (see there).  The
    input gradients must be equal bit for bit, since the backward IS the
    plain recompute; the SSD scan also with an upstream gradient on its
    final state."""
    def grads(fn, inputs, kwargs, used):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = fn(*xs, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        gos = [randn(tuple(outs[i].shape), 90 + i, outs[i].dtype)
               for i in used]
        return ([o.detach() for o in outs],
                torch.autograd.grad([outs[i] for i in used], xs, gos))

    worst = collections.defaultdict(float)

    def against_exact(outs, want_outs, inputs, plain, what):
        """Each output's max abs error against ``plain`` in f64, the
        kernel's within SSD_EXACT_RATIO times the plain version's."""
        with torch.no_grad():
            exact = plain(*(t.double() for t in inputs))
        for i, (o, w, e) in enumerate(zip(outs, want_outs, exact)):
            ek, ep = (float((t.double() - e).abs().max()) for t in (o, w))
            require(ek <= SSD_EXACT_RATIO * ep,
                    f"{what}: output {i} of the Function off the f64 plain "
                    f"version by {ek:.3g}, the f32 plain version by {ep:.3g}")
            log(f"{what}: output {i} against the f64 plain version: kernel "
                f"{ek:.3g}, plain {ep:.3g} (max abs error)")

    def check(kernel, plain, inputs, kwargs, what, used=(0,), scale=1,
              exact=False):
        outs, got = grads(functools.partial(k.grad.apply, kernel, plain),
                          inputs, kwargs, used)
        want_outs, want = grads(plain, inputs, kwargs, used)
        if exact:
            against_exact(outs, want_outs, inputs, plain, what)
        else:
            for i, (o, w) in enumerate(zip(outs, want_outs)):
                err = close_err(o, w, f"{what}: output {i} of the Function",
                                scale)
                key = (what.split()[0], str(inputs[0].dtype)[6:])
                worst[key] = max(worst[key], err)
        for i, (a, b) in enumerate(zip(got, want)):
            require(a.dtype == b.dtype and bool(torch.isfinite(a).all())
                    and torch.equal(a, b),
                    f"{what}: gradient of input {i} through the Function "
                    f"!= plain autograd")

    ssd = functools.partial(k.ssd.ssd_scan, return_state=True)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, KVH, D, causal, window in GRAD_FLASH:
            qkv = (randn((B, S, H, D), S, dtype),
                   randn((B, S, KVH, D), S + 1, dtype),
                   randn((B, S, KVH, D), S + 2, dtype))
            check(k.fa.flash_attention, k.fa_ref.flash_attention_ref, qkv,
                  {"causal": causal, "window": window},
                  f"flash_attention {(B, S, H, KVH, D)} causal={causal} "
                  f"window={window} {dtype}")
            n += 1
        for shape in GRAD_NORM:
            w = torch.rand(shape[-1], generator=torch.Generator(
                device="cuda").manual_seed(3), device="cuda") + 0.5
            check(k.rn.rmsnorm, k.rn_ref.rmsnorm_ref,
                  (randn(shape, 7, dtype), w), {"eps": 1e-5},
                  f"rmsnorm {shape} {dtype}")
            n += 1
        for shape in GRAD_SSD:
            args = ssd_inputs(*shape, dtype, 61)
            for used in ((0,), (0, 1)):
                check(ssd, k.ssd_ref.ssd_scan_chunked_ref, args, {},
                      f"ssd_scan {shape} {dtype} outputs {used}", used,
                      SSD_TOL_SCALE)
                n += 1
        *xbc, dt, da = ssd_inputs(*GRAD_SSD[-1], dtype, 62)
        check(ssd, k.ssd_ref.ssd_scan_chunked_ref,
              (*xbc, dt, da * GRAD_SSD_STRONG_DECAY), {},
              f"ssd_scan {GRAD_SSD[-1]} {dtype}, decay overflowing above "
              f"the diagonal", exact=True)
        n += 1
        torch.cuda.empty_cache()
    log(f"autograd Functions on the card: {n} cases (flash attention "
        f"{GRAD_FLASH}, RMSNorm rows {GRAD_NORM}, SSD scan {GRAD_SSD} with "
        f"and without a state gradient and with da x "
        f"{GRAD_SSD_STRONG_DECAY}; f32 and bf16): every forward output "
        f"within tolerance of the plain version's, the strong decay's "
        f"against the f64 plain version (max abs error "
        + ", ".join(f"{name} {dt} {e:.3g}" for (name, dt), e in
                    sorted(worst.items()))
        + "), every input gradient finite and equal to plain autograd's, "
        "bit for bit")


def ssd_backward_checks(k) -> None:
    """The SSD chunk scan's backward kernel (``ssd_scan_bwd``) against the
    plain version's autograd at GRAD_SSD, f32 and bf16, with and without a
    final state's gradient: each gradient's largest error within
    SSD_BWD_TOL of its largest value (dx, db, dc in the inputs' dtype, ddt
    and dda f32); a second call bit-identical; one counted launch a call,
    also through the model's Function."""
    names = ("dx", "db", "dc", "ddt", "dda")
    worst = collections.defaultdict(float)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in GRAD_SSD:
            args = ssd_inputs(*shape, dtype, 63)
            B, _, _, nh, hd, ns = shape
            dy = randn(tuple(args[0].shape), 64, dtype)
            for dh in (None, randn((B, nh, ns, hd), 65, torch.float32)):
                k.ssd._build.reset_launches()
                got = k.ssd.ssd_scan_bwd(*args, dy, dh)
                again = k.ssd.ssd_scan_bwd(*args, dy, dh)
                torch.cuda.synchronize()
                require(k.ssd._build.launch_counts() == {"ssd_scan_bwd": 2},
                        f"ssd_scan_bwd {shape}: launches "
                        f"{k.ssd._build.launch_counts()}")
                want = k.ssd._plain_grads(args, (True,) * 5, dy, dh)
                for name, g, a, w in zip(names, got, again, want):
                    require(torch.equal(g, a), f"ssd_scan_bwd {shape} "
                            f"{dtype}: {name} differs between two calls")
                    require(g.dtype == w.dtype and bool(
                        torch.isfinite(g).all()), f"ssd_scan_bwd {shape} "
                        f"{dtype}: {name} {g.dtype} or not finite")
                    err = float((g.double() - w.double()).abs().max()
                                / w.double().abs().max().clamp_min(1e-30))
                    tol = SSD_BWD_TOL[g.dtype]
                    require(err <= tol, f"ssd_scan_bwd {shape} {dtype} "
                            f"dh={dh is not None}: {name} off the plain "
                            f"version's by {err:.3g} of its largest value, "
                            f"over {tol}")
                    key = (name, str(dtype)[6:])
                    worst[key] = max(worst[key], err)
        xs = [t.detach().clone().requires_grad_(True) for t in args]
        k.ssd._build.reset_launches()
        y, _ = k.ssd.ssd_scan_with_grad(k.ssd_ref.ssd_scan_chunked_ref, *xs)
        torch.autograd.grad(y, xs, dy)
        require(k.ssd._build.launch_counts() == {"ssd_scan_bwd": 1},
                f"the model's Function launched "
                f"{k.ssd._build.launch_counts()} in a backward")
    log(f"ssd_scan_bwd at {GRAD_SSD}, f32 and bf16, with and without a "
        f"state gradient: two calls bit-identical, one launch a call; the "
        f"largest error as a share of the largest value: "
        + ", ".join(f"{n} {d} {e:.3g}" for (n, d), e in
                    sorted(worst.items())))


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


def ior_ticks(rank: int, n_iter: int = N_ITER) -> np.ndarray:
    n = 2 * n_iter + 3
    rng = np.random.RandomState(1000 + rank)
    return np.cumsum(rng.randint(1, 40, size=2 * n)).reshape(n, 2)


def ior_record(rec, comm, registry, rank: int, flush_every: int = 0,
               n_iter: int = N_ITER, start: int = 0, flush=None) -> None:
    """Rank ``rank``'s IOR calls into ``rec`` with explicit ticks; with
    ``flush_every``, a (collective) flush every that many records:
    ``rec.flush(comm)``, or ``flush(k)`` for the k-th flush where given.
    ``start`` skips the first ``start`` records (a restarted job records
    the rest, at the same ticks, and flushes at the same records)."""
    fid = {n: registry.id_of(n)
           for n in ("open", "lseek", "write", "fsync", "close")}
    t = iter(ior_ticks(rank, n_iter).tolist())
    done = 0
    flush = flush or (lambda k: rec.flush(comm))

    def record(f, args, ret):
        nonlocal done
        ticks = next(t)
        if done >= start:
            rec.record(f, args, ret, 0, *ticks)
        done += 1
        if flush_every and done % flush_every == 0 and done > start:
            flush(done // flush_every - 1)

    fd = 3
    record(fid["open"], ("/scratch/ior/testFile", os.O_RDWR | os.O_CREAT,
                         0o644), fd)
    for i in range(n_iter):
        off = rank * XFER + i * comm.size * XFER
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


def device_busy_ms(prof, events=None) -> float:
    """Device time (kernels and copies) a CUDA-only profile recorded;
    ``events``, where given, is its ``key_averages()`` already taken (a
    serve run's profile holds 10^5 events, and each call sorts them
    again)."""
    events = prof.key_averages() if events is None else events
    return sum(e.self_device_time_total for e in events) / 1e3


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
    from repro_torch.kernels import _build, _grad
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


# phase durability: the write path's faults and recovery on the card
# phase 3's IOR cut to 2,048 iterations a rank: at 8,192 the phase took
# 167.1 s on the card, more than the run's time limit leaves it
DUR_ITER = 2048
DUR_FLUSH = 1024         # records a flush: 4 flushes and finalize's tail
DUR_EPOCH = 2            # the epoch the faults hit
DUR_TIMEOUT_S = 3.0      # a hop's receive timeout, degraded protocol
DUR_PROCS, DUR_PROC_ITER, DUR_PROC_FLUSH = 4, 2048, 1024


def durable_job(comm, rank, registry, rec_mod, faults, trace_dir: str,
                backend: str, *, n_iter: int, flush_every: int,
                plans=None, start: int = 0, **config) -> dict:
    """One rank of a durability job: rank ``rank``'s IOR calls (from record
    ``start``), a flush every ``flush_every`` records (each drained at
    once with ``async_flush`` in ``config``, the rest of the recorder's
    config: the commit runs on the recorder's pool thread), then a
    finalize.  ``plans`` maps a flush's index to the ``FaultPlan`` in
    force during it, which rank 0 installs between barriers: the one plan
    of every ThreadComm rank, in a process world rank 0's alone.  Returns
    each flush's seconds (and drain seconds), its ``ranks_present``, the
    epoch counters and, on rank 0, the counters of each plan."""
    rec = rec_mod.Recorder(rank=rank, config=rec_mod.RecorderConfig(
        trace_dir=trace_dir, encode_backend=backend, **config))
    out = {"flush_s": [], "drain_s": [], "present": [], "plans": []}
    plans = plans or {}

    def swap(plan) -> None:
        comm.barrier()
        if rank == 0 and plan is None:
            faults.uninstall()
        elif rank == 0:
            faults.install(plan)
        comm.barrier()

    def flush(k: int) -> None:
        plan = plans.get(k)
        if plan is not None:
            swap(plan)
        comm.barrier()      # a flush's timeouts (and its clock) start at once
        t = time.monotonic()
        rec.flush(comm)
        out["flush_s"].append(time.monotonic() - t)
        if config.get("async_flush"):
            t = time.monotonic()
            rec.drain()
            out["drain_s"].append(time.monotonic() - t)
        o = rec.last_flush_outcome
        out["present"].append(None if o is None else list(o.ranks_present))
        if plan is not None:
            if rank == 0:
                out["plans"].append(dict(plan.counters))
            swap(None)

    ior_record(rec, comm, registry, rank, flush_every, n_iter, start, flush)
    stats = rec.finalize(comm)
    out.update(n_records=None if stats is None else stats.n_records,
               **{k: getattr(rec, k) for k in (
                   "epochs_resumed", "epochs_restored", "epochs_degraded",
                   "epochs_coalesced")})
    return out


def durable_proc_rank(comm, rank: int, trace_dir: str, part: str,
                      backend: str) -> dict:
    """One process of the durability phase's process case: ``part``
    "crash" kills rank 0's commit of epoch 2 at ``pre-manifest`` (the
    world ends in ``WorldError``), "resume" records from epoch 2 again
    into the same directory and finalizes.  Each process counts its own
    launches."""
    import repro_torch.core.apis  # noqa: F401  (populate the registry)
    from repro_torch.core import encode_backend as eb
    from repro_torch.core import faults, recorder
    from repro_torch.core.specs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_encode import ops as de

    if backend == "cuda":       # the CUDA context and the kernels first
        de.delta_zigzag(torch.zeros(4, dtype=torch.int32, device="cuda"))
        de.uvarint_pack64(torch.zeros(4, dtype=torch.int64, device="cuda"))
        torch.cuda.synchronize()
    eb.set_default_backend(backend)
    _build.reset_launches()
    crash = {DUR_EPOCH: faults.FaultPlan(crash_point="pre-manifest")}
    out = durable_job(comm, rank, REGISTRY, recorder, faults, trace_dir,
                      backend, n_iter=DUR_PROC_ITER,
                      flush_every=DUR_PROC_FLUSH,
                      plans=crash if part == "crash" else None,
                      start=DUR_EPOCH * DUR_PROC_FLUSH
                      if part == "resume" else 0)
    if backend == "cuda":
        torch.cuda.synchronize()
    out["launches"] = _build.launch_counts()
    return out


def durable_thread_job(p, name: str, trace_dir: str, backend: str,
                       flushes: list, **kw) -> dict:
    """A durability job on ``N_RANKS`` ThreadComm ranks in this process,
    profiled; what it launched, its flushes (by the flush shim: records,
    records a block, blocks, ``delta_zigzag`` launches of that flush on
    its thread) and its per-rank results."""
    from torch.profiler import ProfilerActivity, profile
    p.eb.set_default_backend(backend)
    before, first = p.build.launch_counts(), len(flushes)
    err = None
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.monotonic()
            try:
                res = p.run_thread_world(N_RANKS, lambda comm, rank:
                                         durable_job(
                                             comm, rank, p.REGISTRY,
                                             p.recorder, p.faults,
                                             trace_dir, backend,
                                             n_iter=DUR_ITER,
                                             flush_every=DUR_FLUSH, **kw))
            except BaseException as e:  # noqa: BLE001  (a crash job)
                res, err = None, e
            torch.cuda.synchronize()
            wall = time.monotonic() - t
    finally:
        p.eb.set_default_backend(BACKEND)
        p.faults.uninstall()
    job = {"wall_s": wall, "device_busy_ms": device_busy_ms(prof),
           "launches": counts_since(p.build, before),
           "flushes": flushes[first:], "res": res, "error": err}
    if res is not None:
        job["flush_s_rank0"] = res[0]["flush_s"]
        job["flush_s_max"] = [max(r["flush_s"][i] for r in res)
                              for i in range(len(res[0]["flush_s"]))]
        if res[0]["drain_s"]:
            job["drain_s_rank0"] = res[0]["drain_s"]
    log(f"durability {name} ({backend}): {N_RANKS} ThreadComm ranks x "
        f"{2 * DUR_ITER + 3} records, a flush every {DUR_FLUSH}; wall "
        f"{wall:.2f} s; flush s (rank 0) "
        f"{[round(x, 4) for x in job.get('flush_s_rank0', [])]}, slowest "
        f"rank {[round(x, 4) for x in job.get('flush_s_max', [])]}"
        + (f", drain s (rank 0) {[round(x, 4) for x in job['drain_s_rank0']]}"
           if "drain_s_rank0" in job else "")
        + f"; device busy {job['device_busy_ms']:.3f} ms; launches "
        f"{job['launches']}" + (f"; raised {type(err).__name__}" if err
                                else ""))
    return job


def phase_durability(p, flushes: list) -> dict:
    """Phase durability (see the module docstring)."""
    root = os.path.join(WORK, "durability")
    shutil.rmtree(root, ignore_errors=True)
    d = {n: os.path.join(root, n) for n in (
        "sync", "async", "mute", "mute-numpy", "crash", "torn")}
    jobs = {}
    jobs["sync"] = durable_thread_job(p, "sync", d["sync"], BACKEND,
                                      flushes)
    jobs["async"] = durable_thread_job(p, "async", d["async"], BACKEND,
                                       flushes, async_flush=True)
    for name, backend in (("mute", BACKEND), ("mute-numpy", "numpy")):
        jobs[name] = durable_thread_job(
            p, "mute", d[name], backend, flushes, flush_timeout_s=
            DUR_TIMEOUT_S, plans={DUR_EPOCH: p.faults.FaultPlan(
                seed=7, dead_ranks=(1,))})
    jobs["crash"] = durable_thread_job(
        p, "crash", d["crash"], BACKEND, flushes,
        plans={DUR_EPOCH: p.faults.FaultPlan(crash_point="pre-manifest")})
    crashed = p.trace_format.read_manifest(d["crash"])
    orphan = os.path.isdir(os.path.join(
        d["crash"], p.trace_format.segment_name(DUR_EPOCH)))
    jobs["resume"] = durable_thread_job(p, "resume", d["crash"], BACKEND,
                                        flushes,
                                        start=DUR_EPOCH * DUR_FLUSH)
    jobs["torn"] = durable_thread_job(
        p, "torn", d["torn"], BACKEND, flushes,
        plans={DUR_EPOCH: p.faults.FaultPlan(torn_file="timestamps.bin")})
    bins = {n: bin_files(path) for n, path in d.items()}
    n_rec = 2 * DUR_ITER + 3
    n_flush = n_rec // DUR_FLUSH
    # every job but the crash finalizes: stats on rank 0, every record
    for name, job in jobs.items():
        if name == "crash":
            continue
        require(job["error"] is None, f"durability {name}: raised "
                f"{job['error']!r}")
        require(job["res"][0]["n_records"] == n_rec - (
            DUR_EPOCH * DUR_FLUSH if name == "resume" else 0),
            f"durability {name}: rank 0 finalized "
            f"{job['res'][0]['n_records']} records")
        if name.endswith("numpy"):
            continue
        # each flush on cuda launches delta_zigzag once, on the thread
        # that ran it (the flushing rank, or its pool thread when async)
        dz = [n for *_, n in job["flushes"]]
        require(bool(dz) and all(n == 1 for n in dz),
                f"durability {name}: delta_zigzag launches a flush {dz}")
        require(job["launches"].get("delta_zigzag", 0) == len(dz),
                f"durability {name}: {len(dz)} flushes on cuda launched "
                f"delta_zigzag {job['launches'].get('delta_zigzag', 0)} "
                f"times")
    # 1, 2: async flushes write the sync flushes' bytes
    require(bins["sync"] == bins["async"], "durability: async flushes "
            f"wrote other bytes ({digest(bins['async'])[:16]} vs "
            f"{digest(bins['sync'])[:16]})")
    require(len(jobs["sync"]["flushes"]) == N_RANKS * (n_flush + 1),
            f"durability sync: {len(jobs['sync']['flushes'])} rank flushes")
    segs = sorted(x for x in os.listdir(d["sync"])
                  if x.startswith(p.trace_format.SEGMENT_PREFIX))
    require(len(segs) == n_flush + 1 and os.path.isdir(
        os.path.join(d["sync"], "merged")), f"durability sync: {segs}")
    # 3: rank 1 mute in epoch 2; the survivors commit it with a mask, and
    # rank 1's records ride epoch 3; the bytes are numpy's
    mask = [r for r in range(N_RANKS) if r != 1]
    m = p.trace_format.read_manifest(d["mute"])
    got_masks = [e.get("ranks_present") for e in m["segments"]]
    require(got_masks == [None] * DUR_EPOCH + [mask]
            + [None] * (len(got_masks) - DUR_EPOCH - 1),
            f"durability mute: ranks_present by epoch {got_masks}")
    require(jobs["mute"]["res"][0]["present"][DUR_EPOCH] == mask,
            "durability mute: rank 0's outcome "
            f"{jobs['mute']['res'][0]['present'][DUR_EPOCH]}")
    restored = [r["epochs_restored"] for r in jobs["mute"]["res"]]
    require(restored == [1 if r == 1 else 0 for r in range(N_RANKS)],
            f"durability mute: epochs restored by rank {restored}")
    require(bins["mute"] == bins["mute-numpy"], "durability mute: cuda "
            "and numpy bytes differ")
    with warnings.catch_warnings():     # the reader warns of the mask
        warnings.simplefilter("ignore")
        view = p.TraceReader(d["mute"], mode="stitched")
        require(view.ranks_partial == [1] and view.degraded_epochs == {
            p.trace_format.segment_name(DUR_EPOCH): mask},
            f"durability mute: reader {view.ranks_partial} "
            f"{view.degraded_epochs}")
    # 4: the crash leaves epochs 0-1 and an orphan; the resumed job's
    # directory is the uninterrupted one's, merged/ included
    require(type(jobs["crash"]["error"]).__name__ == "SimulatedCrash",
            f"durability crash: raised {jobs['crash']['error']!r}")
    require([e["epoch"] for e in crashed["segments"]] == list(
        range(DUR_EPOCH)) and "merged" not in crashed and orphan,
        f"durability crash: left {crashed} (orphan {orphan})")
    require(jobs["resume"]["res"][0]["epochs_resumed"] == DUR_EPOCH,
            "durability resume: epochs resumed "
            f"{jobs['resume']['res'][0]['epochs_resumed']}")
    require(bins["crash"] == bins["sync"], "durability resume: the "
            "resumed directory differs from the uninterrupted one")
    # 5: a torn timestamps.bin has its size, so only the checksum sees it
    torn = jobs["torn"]["res"][0]["plans"]
    require(torn == [{**torn[0], "files_torn": 1}], f"durability torn: "
            f"plan counters {torn}")
    seg = p.trace_format.segment_name(DUR_EPOCH)
    entry = p.trace_format.read_manifest(d["torn"])["segments"][DUR_EPOCH]
    reason = p.trace_format.validate_segment(d["torn"], entry)
    require(reason is not None and "checksum" in reason,
            f"durability torn: validate_segment says {reason!r}")
    report = p.faults.check_trace_invariants(d["torn"])
    require(report["readable"] and [x["segment"] for x in report[
        "skipped"]] == [seg] and report["n_records"] == N_RANKS * (
        n_rec - DUR_FLUSH), f"durability torn: report {report}")
    procs = durable_processes(p)
    summary = {n: {k: v for k, v in j.items()
                   if k not in ("res", "flushes", "error")}
               for n, j in jobs.items()}
    summary["mute"]["ranks_present"] = got_masks
    summary["torn"]["report"] = {k: report[k] for k in (
        "readable", "n_records", "skipped")}
    summary["processes"] = procs
    log(f"durability: sync = async bytes ({digest(bins['sync'])[:16]}); "
        f"rank 1 mute in epoch {DUR_EPOCH}: ranks_present {mask[:3]}... "
        f"({len(mask)} ranks), cuda = numpy bytes; crash at pre-manifest in "
        f"epoch {DUR_EPOCH}, resumed = uninterrupted bytes, merged/ "
        f"included; torn timestamps.bin reported: {reason}")
    return summary


def durable_processes(p) -> dict:
    """The process case: ``DUR_PROCS`` processes over ``TorchDistComm``,
    world A crashing and world B resuming, against the same calls
    uninterrupted on ThreadComm in this process."""
    root = os.path.join(WORK, "durability", "procs")
    ref_dir, sd = os.path.join(root, "threads"), os.path.join(root, "procs")
    ref = p.run_thread_world(DUR_PROCS, lambda comm, rank: durable_job(
        comm, rank, p.REGISTRY, p.recorder, p.faults, ref_dir, BACKEND,
        n_iter=DUR_PROC_ITER, flush_every=DUR_PROC_FLUSH))
    out = {}
    t = time.monotonic()
    try:
        p.run_process_world(DUR_PROCS, durable_proc_rank,
                            (sd, "crash", BACKEND),
                            deadline_s=MP_DEADLINE_S,
                            workdir=os.path.join(root, "world_a"))
        raise AssertionError("durability processes: world A did not fail")
    except p.WorldError as e:
        out["world_a_s"] = time.monotonic() - t
        require("SimulatedCrash" in e.errors.get(0, ""),
                f"durability processes: world A's errors {e.errors}")
    m = p.trace_format.read_manifest(sd)
    require([x["epoch"] for x in m["segments"]] == list(range(DUR_EPOCH))
            and "merged" not in m, f"durability processes: world A left "
            f"{m}")
    t = time.monotonic()
    res = p.run_process_world(DUR_PROCS, durable_proc_rank,
                              (sd, "resume", BACKEND),
                              deadline_s=MP_DEADLINE_S,
                              workdir=os.path.join(root, "world_b"))
    out["world_b_s"] = time.monotonic() - t
    require(res[0]["epochs_resumed"] == DUR_EPOCH,
            f"durability processes: resumed {res[0]['epochs_resumed']}")
    got, want = bin_files(sd), bin_files(ref_dir)
    require(any(x.startswith("merged") for x in got) and got == want,
            "durability processes: the resumed directory differs from "
            "the uninterrupted ThreadComm run's")
    dz = [r["launches"].get("delta_zigzag", 0) for r in res]
    require(all(n > 0 for n in dz), f"durability processes: delta_zigzag "
            f"launches by rank {dz}")
    out.update(flush_s_rank0=res[0]["flush_s"], delta_zigzag_by_rank=dz,
               sha256=digest(got)[:16], threadcomm_flush_s_rank0=ref[0][
                   "flush_s"])
    log(f"durability processes: {DUR_PROCS} processes over TorchDistComm, "
        f"world A (rank 0's commit of epoch {DUR_EPOCH} crashes) "
        f"{out['world_a_s']:.2f} s, world B (resumed) "
        f"{out['world_b_s']:.2f} s; bytes as the uninterrupted ThreadComm "
        f"run ({out['sha256']}); delta_zigzag launches by rank {dz}")
    return out


# phase finalize_scaling: thousands of synthetic ranks.  2,048: at 4,096
# the phase took 55.6-62.8 s on the card and a run 1,227.0 s, over its
# 1,200 s limit
FS_RANKS, FS_GROUPS, FS_CALLS = 2048, 32, 64


def phase_finalize_scaling(p, ev, shapes) -> dict:
    """Phase finalize_scaling (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile
    root = os.path.join(WORK, "finalize_scaling")
    shutil.rmtree(root, ignore_errors=True)
    p.eb.set_default_backend("numpy")
    try:
        t = time.monotonic()
        csts, cfgs = ev.wl.synth_rank_states(
            FS_RANKS, n_groups=FS_GROUPS, n_calls=FS_CALLS,
            pattern="mixed_all")
        synth_s = time.monotonic() - t
    finally:
        p.eb.set_default_backend(BACKEND)
    log(f"finalize_scaling: synth_rank_states({FS_RANKS}, n_groups="
        f"{FS_GROUPS}, n_calls={FS_CALLS}, pattern='mixed_all') on numpy "
        f"in {synth_s:.2f} s")
    runs, out = {}, {"ranks": FS_RANKS, "synth_s": synth_s}
    for name, topology, backend in (("flat-cuda", "flat", BACKEND),
                                    ("tree-cuda", "tree", BACKEND),
                                    ("flat-numpy", "flat", "numpy")):
        d = os.path.join(root, name)
        p.eb.set_default_backend(backend)
        before = p.build.launch_counts()
        fit_shapes = collections.Counter(shapes["fit_columns"])
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.monotonic()
                if topology == "flat":
                    merge, cfgres = p.ip.finalize_ranks(
                        csts, cfgs, p.REGISTRY,
                        fit_mode="cuda" if backend == "cuda"
                        else "vectorized")
                else:
                    merge, cfgres = p.ip.tree_finalize_ranks(
                        csts, cfgs, p.REGISTRY)
                torch.cuda.synchronize()
                fin_s = time.monotonic() - t
                p.trace_format.write_trace(
                    d, registry=p.REGISTRY, merged_cst=merge.merged_entries,
                    unique_cfgs=cfgres.unique_cfgs,
                    cfg_index=cfgres.cfg_index,
                    rank_timestamps=[b""] * FS_RANKS, meta_extra={})
                torch.cuda.synchronize()
                all_s = time.monotonic() - t
        finally:
            p.eb.set_default_backend(BACKEND)
        runs[name] = bin_files(d)
        launches = counts_since(p.build, before)
        new_fit = dict(collections.Counter(shapes["fit_columns"])
                       - fit_shapes)
        out[name] = {"finalize_s": fin_s, "with_write_s": all_s,
                     "device_busy_ms": device_busy_ms(prof),
                     "launches": launches, "fit_columns_shapes": {
                         str(k): v for k, v in new_fit.items()},
                     "merged_entries": len(merge.merged_entries),
                     "rank_patterns": merge.n_rank_patterns,
                     "unique_cfgs": len(cfgres.unique_cfgs),
                     "bin_bytes": sum(map(len, runs[name].values()))}
        log(f"finalize_scaling {name}: {FS_RANKS} ranks finalized in "
            f"{fin_s:.3f} s ({all_s:.3f} s with the trace written); device "
            f"busy {out[name]['device_busy_ms']:.3f} ms; launches "
            f"{launches}; fit_columns shapes {new_fit}; "
            f"{len(merge.merged_entries)} merged entries, "
            f"{merge.n_rank_patterns} rank patterns, .bin "
            f"{out[name]['bin_bytes']} B, sha256 {digest(runs[name])[:16]}")
    require(runs["flat-cuda"] == runs["tree-cuda"] == runs["flat-numpy"],
            "finalize_scaling: tree, flat and numpy bytes differ")
    require(out["flat-cuda"]["launches"].get("fit_columns", 0) == 1,
            f"finalize_scaling: the flat cuda finalize launched "
            f"fit_columns {out['flat-cuda']['launches']}")
    return out


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
    flash_attention per attention layer of the prefill (MoE's first dense
    layer included; an encoder-decoder's encoder layers too, its cross
    attention being plain; none for MLA, whose attention is the plain
    chunked path), one ssd_scan per SSD layer of the prefill, and per
    layer and
    token two rmsnorm for QK-norm, one for the SSD gate norm and one for
    MLA's latent norm (the prefill's cache takes the attention's own
    projection, so a prefill norms the latent once a layer, as each decode
    step does)."""
    ssd = cfg.family == "ssm" or cfg.hybrid
    flash = cfg.family != "ssm" and not cfg.mla
    return {"flash_attention": (cfg.n_layers + cfg.n_encoder_layers)
            if flash else 0,
            "ssd_scan": cfg.n_layers if ssd else 0,
            "ssd_scan_bwd": 0,
            "rmsnorm": cfg.n_layers * n_new * (2 * cfg.qk_norm + ssd
                                               + cfg.mla)}


class RouteLog:
    """Stands in for ``models.layers.top_k`` while the serve phases run
    (``main`` installs it).  Outside a ``use`` block it passes through; in
    ``record`` it keeps each call's experts (one call a MoE layer of a
    prefill); in ``compare`` it counts, call by call, the tokens whose
    expert set differs from the recorded one (routing flips); ``replay``
    counts them too and returns the recorded experts with this run's
    probabilities at them, so the run routes as the recorded one did."""

    def __init__(self, real):
        self.real, self.mode = real, None
        self.routes, self.flips, self.i = [], [], 0

    @contextlib.contextmanager
    def use(self, mode: str):
        if mode == "record":
            self.routes = []
        self.mode, self.flips, self.i = mode, [], 0
        try:
            yield self
        finally:
            self.mode = None

    def __call__(self, probs, k):
        w, idx = self.real(probs, k)
        if self.mode == "record":
            self.routes.append(idx)
        elif self.mode in ("compare", "replay"):
            ref = self.routes[self.i]
            self.i += 1
            self.flips.append(int((idx.sort(-1).values
                                   != ref.sort(-1).values).any(-1).sum()))
            if self.mode == "replay":
                w, idx = probs.gather(-1, ref), ref
        return w, idx


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def kernel_vs_plain(s, cfg, plain: dict, params, batch) -> dict:
    """Prefill logits of the kernel path against the plain path ``plain``
    selects, on the same weights and prompts: relative L2 ``rel`` (the
    plain path routing freely) and, for a MoE model, ``rel_replayed``
    (routing replayed from the kernel path) and the routing flips per MoE
    layer of both plain runs."""
    dev = param_device(s, params)
    out = {}
    with torch.inference_mode():
        with s.routes.use("record"):
            lg_kernel, _ = s.get_model(cfg, dev).prefill(params, batch)
        require(bool(torch.isfinite(lg_kernel).all()),
                f"serve {cfg.name}: logits not finite")
        plain_model = s.get_model(cfg.replace(**plain), dev)
        with s.routes.use("compare") as r:
            lg_plain, _ = plain_model.prefill(params, batch)
        out.update(rel=rel_l2(lg_kernel, lg_plain),
                   max_abs=float((lg_kernel - lg_plain).abs().max()),
                   max_logit=float(lg_plain.abs().max()))
        if cfg.is_moe:
            out["flips"] = r.flips
            with s.routes.use("replay") as r:
                lg_replay, _ = plain_model.prefill(params, batch)
            out["rel_replayed"] = rel_l2(lg_kernel, lg_replay)
            out["flips_replayed"] = r.flips
            out["routed_tokens"] = int(np.prod(batch["tokens"].shape))
    return out


def serve_batch(cfg, n: int, prompt: int, seed: int, device,
                frames: int = 0) -> dict:
    """``n`` prompts of ``prompt`` tokens (numpy seed ``seed``); a VLM's
    ``n_patches`` patch embeddings before them, normal at the token
    embeddings' scale 0.02, from a generator on ``device`` seeded
    ``seed``; an encoder-decoder's ``frames`` frame embeddings beside
    them, normal, from the same generator (as the serve launcher's, whose
    frames are numpy draws)."""
    batch = {"tokens": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(n, prompt)).astype(np.int32)}
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "vlm":
        batch["patches"] = 0.02 * torch.randn(
            (n, cfg.n_patches, cfg.d_model), generator=gen, device=device)
    if cfg.n_encoder_layers:
        batch["frames"] = torch.randn((n, frames, cfg.d_model),
                                      generator=gen, device=device)
    return batch


def param_device(s, params) -> torch.device:
    return next(iter(s.flat_params(params).values())).device


def refused_before_launch(s, eng, batch, n_new: int, what: str) -> str:
    """``eng.generate(batch, n_new)`` must raise ``ValueError`` before any
    kernel launch; returns its message."""
    torch.cuda.synchronize()
    s.build.reset_launches()
    try:
        eng.generate(batch, n_new)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"{what} were not refused")
    torch.cuda.synchronize()
    require(s.build.launch_counts() == {} and eng.stats == {},
            f"{what}: the refused request launched "
            f"{s.build.launch_counts()}")
    return refused


def phase_serve(s, spec: ServeSpec) -> dict:
    """Serve ``spec.arch`` (``spec.layers`` layers, full widths) on the
    kernel path: a warm-up, a timed run, then the main path -- launch
    counts set to 0 just before, read just after -- inside a ``session``
    under the profiler.  Then the plain path ``spec.plain`` selects on the
    same weights and prompts (``kernel_vs_plain``), in bf16 and, where
    ``spec.f32_rtol`` is set, in f32, and the smoke model on the card
    against the CPU."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    cfg = cut_layers(s.get_config(spec.arch), spec.layers)
    require(cfg.attn_impl == "cuda" and cfg.ssm_impl == "cuda",
            "the kernel paths must be the defaults")
    t = time.monotonic()
    params = s.get_model(cfg, dev).init_params(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    flat = s.flat_params(params)
    n_params = sum(x.numel() for x in flat.values())
    n_bytes = sum(x.numel() * x.element_size() for x in flat.values())
    log(f"serve: {cfg.name}, {cfg.n_layers} of {spec.of} layers"
        + (f" (and {cfg.n_encoder_layers} encoder layers)"
           if cfg.n_encoder_layers else "") + f" at d "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads x "
        f"{cfg.hd}, window {cfg.sliding_window}, d_ff {cfg.d_ff}, SSD "
        f"{cfg.ssm_heads if cfg.ssm_state else 0} heads x {cfg.ssm_head_dim}"
        f", state {cfg.ssm_state}, vocab {cfg.vocab_size} (padded "
        f"{cfg.padded_vocab}), {cfg.param_dtype}: {n_params} parameters, "
        f"{n_bytes} B, initialised in {time.monotonic() - t:.2f} s")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "param_bytes": n_bytes}
    batch = serve_batch(cfg, SERVE_BATCH, spec.prompt, 0, dev, spec.frames)
    n_pos = s.prompt_len(cfg, batch)
    eng = s.ServeEngine(cfg, params, max_seq=spec.max_seq, device=dev)
    if cfg.family != "ssm" and not cfg.sliding_window:
        # a dense KV or latent cache holds max_seq positions: a request
        # whose last step would write past them is refused before any
        # kernel launch (a VLM's prompt counts its patches)
        over = spec.max_seq - n_pos + 2
        refused = refused_before_launch(
            s, eng, batch, over, f"serve {cfg.name}: {n_pos} + {over} "
            f"positions past max_seq {spec.max_seq}")
        res["overrun_refused"] = True
        log(f"serve {cfg.name}: a prompt of {n_pos} positions + {over} new "
            f"tokens past max_seq {spec.max_seq} refused before any kernel "
            f"launch: {refused}")
    if cfg.n_encoder_layers:
        # the cross K/V hold max_seq encoder positions: so do the frames
        n = spec.max_seq + 1
        refused = refused_before_launch(
            s, eng, serve_batch(cfg, SERVE_BATCH, spec.prompt, 0, dev, n), 2,
            f"serve {cfg.name}: {n} frames past max_seq {spec.max_seq}")
        res["long_encoder_refused"] = True
        log(f"serve {cfg.name}: {n} frames past max_seq {spec.max_seq} "
            f"refused before any kernel launch: {refused}")
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
        f"{n_pos} positions"
        + (f" and {spec.frames} frames" if cfg.n_encoder_layers else "")
        + f" {res['prefill_ms']:.2f} ms, decode "
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
    events = prof.key_averages()
    busy = device_busy_ms(prof, events)
    res["traced_s"], res["busy_ms"] = secs, busy
    res["idle_share"] = 1 - busy / (secs * 1e3)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    res["top_kernels"] = [[e.key[:70], e.self_device_time_total / 1e3,
                           e.count] for e in top]
    # the bf16 serve path must run the tensor-core kernels: the profile
    # (which may miss some launches) must show each kernel of a model
    # kernel that ran, and none of one that did not
    want = serve_launches(cfg, SERVE_NEW)
    seen = {name: sum(e.count for e in events if name in e.key)
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

    if spec.plain is None:
        with torch.inference_mode():
            lg, _ = s.get_model(cfg, dev).prefill(params, batch)
        require(bool(torch.isfinite(lg).all()),
                f"serve {cfg.name}: logits not finite")
        log(f"serve {cfg.name}: prefill logits finite (max |logit| "
            f"{float(lg.abs().max()):.3g}); no plain run: attn_impl "
            f"switches no kernel of this model, and its RMSNorm calls are "
            f"held against the plain version in the kernels phase")
        del params, eng, flat, lg
        torch.cuda.empty_cache()
    else:
        cmp = kernel_vs_plain(s, cfg, spec.plain, params, batch)
        res["logits_rel_err"] = cmp["rel"]
        res["logits_max_abs_err"] = cmp["max_abs"]
        held = "rel_replayed" if cfg.is_moe else "rel"
        require(cmp[held] <= spec.rtol,
                f"serve {cfg.name}: prefill logits of the kernel and plain "
                f"paths differ by {cmp[held]:.3g} (relative L2, {held}), "
                f"over {spec.rtol}")
        tcfg = cfg.replace(**spec.plain)
        eng_t = s.ServeEngine(tcfg, params, max_seq=spec.max_seq, device=dev)
        toks_t = eng_t.generate(batch, SERVE_NEW)
        res["plain_prefill_ms"] = eng_t.stats["prefill_s"] * 1e3
        res["plain_decode_ms_per_step"] = (eng_t.stats["decode_s"] * 1e3
                                           / eng_t.stats["decode_steps"])
        same = toks == toks_t
        prefix = [int(np.argmin(row)) if not row.all() else SERVE_NEW
                  for row in same]
        res["tokens_agree"] = int(same.sum())
        if cfg.is_moe:
            res.update({k: cmp[k] for k in ("rel_replayed", "flips",
                                             "flips_replayed")})
            log(f"serve {cfg.name}: routing flips per MoE layer of the "
                f"prefill (tokens of {cmp['routed_tokens']} whose top-"
                f"{cfg.moe_top_k} experts differ), plain path routing "
                f"freely: {cmp['flips']}; with the kernel path's routing "
                f"replayed (the flips its own routing would make): "
                f"{cmp['flips_replayed']}; logits relative L2 with the "
                f"routing replayed {cmp['rel_replayed']:.3g} (limit "
                f"{spec.rtol})")
        log(f"serve {cfg.name}: prefill logits kernel vs plain path "
            f"({spec.plain}): relative L2 {cmp['rel']:.3g}"
            f"{'' if cfg.is_moe else f' (limit {spec.rtol})'}, max abs "
            f"{cmp['max_abs']:.3g}, max |logit| {cmp['max_logit']:.3g}; "
            f"generated tokens that agree: {res['tokens_agree']} of "
            f"{n_tok}, common prefix per sequence {prefix}; plain path "
            f"prefill {res['plain_prefill_ms']:.2f} ms, decode "
            f"{res['plain_decode_ms_per_step']:.3f} ms per step")
        del params, eng, eng_t, flat
        torch.cuda.empty_cache()
    if spec.f32_rtol is not None:
        c32 = cut_layers(cfg.replace(dtype="float32", param_dtype="float32"),
                         spec.f32_layers or cfg.n_layers)
        p32 = s.get_model(c32, dev).init_params(
            torch.Generator(device=dev).manual_seed(0))
        cmp = kernel_vs_plain(s, c32, spec.plain, p32, batch)
        held = "rel_replayed" if cfg.is_moe else "rel"
        res["f32_logits_rel_err"] = cmp[held]
        res["f32_layers"] = c32.n_layers
        require(cmp[held] <= spec.f32_rtol,
                f"serve {cfg.name} in f32 x {c32.n_layers}: prefill logits "
                f"of the kernel and plain paths differ by {cmp[held]:.3g}, "
                f"over {spec.f32_rtol}")
        log(f"serve {cfg.name} in f32 at the same width, {c32.n_layers} "
            f"layers: prefill logits kernel vs plain path, relative L2 "
            f"{cmp[held]:.3g} ({held}; limit {spec.f32_rtol})" + (
                f"; free routing {cmp['rel']:.3g}, flips {cmp['flips']}, "
                f"replayed {cmp['flips_replayed']}" if cfg.is_moe else ""))
        if cfg.n_encoder_layers:
            res["teacher_forced"] = teacher_forced(s, c32, p32, spec)
        del p32
        torch.cuda.empty_cache()

    scfg = s.get_smoke_config(spec.arch)
    sp = s.get_model(scfg, "cpu").init_params(torch.Generator().manual_seed(0))
    sb = serve_batch(scfg, 2, 37, 0, "cpu", SMOKE_FRAMES)
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


def cut_layers(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers (an encoder-decoder's encoder
    too)."""
    enc = {"n_encoder_layers": layers} if cfg.n_encoder_layers else {}
    return cfg.replace(n_layers=layers, **enc)


# an encoder-decoder smoke model's frames a prompt on the card and the CPU:
# fewer than its max_seq of 64, so the cross-attention mask cuts the cache
SMOKE_FRAMES = 48
# teacher forcing on the card: TEACHER_STEPS decode steps fed the true next
# tokens after the serve run's prefix, their f32 logits against
# train_forward's at the same positions (relative L2, a step at a time).
# The paths differ in f32 rounding (the flash kernel against the plain
# chunked decode attention, batched against one-row products): held to
# the f32 bound of the serve runs.  Attending to the zero keys behind the
# encoder's, as the JAX package's decode does, is off by O(1) on the CPU
# smoke model (tests/test_torch_encdec.py)
TEACHER_STEPS, TEACHER_RTOL = 8, 1e-3


def teacher_forced(s, cfg, params, spec: ServeSpec) -> dict:
    """``cfg`` (f32) fed SERVE_BATCH prompts of ``spec.prompt`` +
    TEACHER_STEPS tokens (numpy seed 0) beside the serve run's frames: the
    prefill of the first ``spec.prompt`` tokens seated in a
    ``spec.max_seq`` cache, then a decode step at each true next token;
    each step's logits against ``train_forward`` over all the tokens."""
    dev = param_device(s, params)
    P = spec.prompt
    batch = serve_batch(cfg, SERVE_BATCH, P + TEACHER_STEPS, 0, dev,
                        spec.frames)
    tok = batch["tokens"]
    model = s.get_model(cfg, dev)
    errs, worst_abs = [], 0.0
    with torch.inference_mode():
        full, _ = model.train_forward(params, batch)
        logits, cache = model.prefill(params, dict(batch, tokens=tok[:, :P]))
        cache = s.seat(model.init_cache(SERVE_BATCH, spec.max_seq), cache)
        require(int(cache["xlen"][0]) == spec.frames < spec.max_seq,
                f"teacher forcing: encoder length {int(cache['xlen'][0])}")
        steps = [(logits, full[:, P - 1])]
        for i in range(P, P + TEACHER_STEPS):
            lg, cache = s.encdec.step_logits(cfg, params, cache,
                                             tok[:, i:i + 1])
            steps.append((lg[:, 0], full[:, i]))
        for got, want in steps:
            errs.append(rel_l2(got, want))
            worst_abs = max(worst_abs, float((got - want).abs().max()))
    require(max(errs) <= TEACHER_RTOL,
            f"teacher forcing {cfg.name}: decode logits off train_forward's "
            f"by {max(errs):.3g} (relative L2), over {TEACHER_RTOL}")
    log(f"teacher forcing {cfg.name} f32 x {cfg.n_layers} + "
        f"{cfg.n_encoder_layers}: {spec.frames} frames in a {spec.max_seq} "
        f"cross cache, prefill of {P} tokens and {TEACHER_STEPS} decode "
        f"steps fed the true tokens: logits against train_forward's, "
        f"relative L2 a step {[f'{e:.3g}' for e in errs]} (limit "
        f"{TEACHER_RTOL}), max abs {worst_abs:.3g}")
    return {"rel_l2": errs, "max_abs": worst_abs, "limit": TEACHER_RTOL}


PRIME_PROMPT = 2053   # a prime prompt length: the SSD runs Q 1, nc 2,053
# the prime prefill's depth: 16 of mamba2's 48 layers (48 until the run's
# time limit needed the room; its plain path took 55 s), held to the serve
# run's bound a layer times 16
PRIME_LAYERS = 16


def prime_prefill(s, spec: ServeSpec) -> dict:
    """A prefill of SERVE_BATCH prompts of PRIME_PROMPT tokens on
    ``spec.arch`` (PRIME_LAYERS layers, bf16, the serve run's seeded
    weights): after a warm-up, the kernel path with the launch counts set
    to 0 just before and read just after, and its memory peak; then the
    plain path ``spec.plain`` selects, and the logits of both within
    ``spec.rtol`` a layer of the serve run times PRIME_LAYERS."""
    dev = torch.device("cuda")
    cfg = s.get_config(spec.arch).replace(n_layers=PRIME_LAYERS)
    rtol = spec.rtol / spec.layers * PRIME_LAYERS
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
    require(rel <= rtol,
            f"prime prefill {cfg.name}: logits of the kernel and plain paths "
            f"differ by {rel:.3g} (relative L2), over {rtol}")
    res = {"arch": cfg.name, "layers": PRIME_LAYERS, "prompt": PRIME_PROMPT,
           "batch": SERVE_BATCH,
           "prefill_ms": kernel_ms, "plain_prefill_ms": plain_ms,
           "logits_rel_err": rel, "launches": launches,
           "peak_bytes": peak, "peak_above_weights_bytes": peak - base}
    log(f"prime prefill {cfg.name}: {SERVE_BATCH} x {PRIME_PROMPT} tokens "
        f"(SSD Q 1, {PRIME_PROMPT} chunks), {PRIME_LAYERS} layers: kernel "
        f"path {kernel_ms:.2f} ms, plain path {plain_ms:.2f} ms; logits "
        f"relative L2 {rel:.3g} (limit {rtol:.3g}); max memory allocated {peak} B ({peak - base} B above "
        f"the weights); launches {launches}")
    del params, lg_kernel, lg_plain
    torch.cuda.empty_cache()
    return res


# the train phase: mamba2-370m at its published widths and depth (48
# layers), bf16 compute with f32 master weights and moments, block remat,
# weights from a CUDA generator seeded 0, TRAIN_BATCH x TRAIN_SEQ tokens of
# ``synthetic_batch`` (seed 0) a step; then qwen1.5-0.5b the same way for
# flash attention's gradient (all 24 layers)
TRAIN_ARCH, DENSE_TRAIN_ARCH = "mamba2-370m", "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS, RESUME_STEPS, DENSE_STEPS = 4, 2, 2
TRAIN_OCFG = dict(lr=1e-3, warmup_steps=2,
                  total_steps=TRAIN_STEPS + RESUME_STEPS)
TRAIN_PLAIN = {"attn_impl": "torch", "ssm_impl": "torch"}
# step 1's loss, kernel path against plain path (relative), set from
# readings: 8.15e-6 (mamba2-370m) and 1.23e-5 (qwen1.5-0.5b) on an H100
# 80GB HBM3 at 700 W (PERF.md), so about 100 times the readings and 20
# times under the kernels' bf16 tolerance.  At random init the final norm
# and the head set the logits' scale, so the loss moves little whatever a
# kernel returns: a wrong kernel is caught by its forward check at the
# train shapes (``function_grad_checks``), not here.
TRAIN_LOSS_RTOL = 1e-3
# every leaf's gradient in f32, kernel path against plain path (relative
# L2): the SSM/hybrid serve runs' f32 bound (SERVE_SPECS), at
# F32_GRAD_LAYERS of the 48 layers.  Deeper, the random layers amplify f32
# rounding past it on their own: ``f32_grad_check`` also measures the
# plain path against itself with the weights perturbed by a relative
# 1e-7, which at 48 layers moves some leaves' gradients by more than 5e-3
# on an H100 (PERF.md).  At full depth each leaf is held to
# F32_GRAD_FULL_RTOL, above that floor; a cut or wrong gradient is off by
# O(1) at any depth.
GRAD_F32_RTOL, F32_GRAD_LAYERS = 1e-3, 4
F32_GRAD_FULL_RTOL = 2e-2


def train_launches(cfg, passes: int) -> dict:
    """Model-kernel launches of ``passes`` forward and backward passes:
    each forward launches what a prefill does (``serve_launches``); block
    remat runs every block's forward again in the backward; the backward
    launches ``ssd_scan_bwd`` once per SSD layer and recomputes the plain
    versions of the other kernels, which launch nothing."""
    remat = 2 if cfg.remat == "block" else 1
    out = {k: v * passes * remat for k, v in serve_launches(cfg, 1).items()}
    out["ssd_scan_bwd"] = passes * (cfg.n_layers if cfg.family == "ssm"
                                    or cfg.hybrid else 0)
    return out


def train_data(s, cfg):
    """The train launcher's data (``launch.train.build_data``):
    TRAIN_BATCH x TRAIN_SEQ tokens of ``synthetic_batch`` (seed 0) a step,
    and as many frames for an encoder-decoder."""
    return s.build_data(cfg, TRAIN_BATCH, TRAIN_SEQ)


def loss_and_grads(s, cfg, params, batch) -> tuple:
    """(loss, {name: gradient}) of one forward and backward."""
    flat = s.flat_params(params)
    dev = next(iter(flat.values())).device
    loss, _ = s.get_model(cfg, dev).loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    torch.cuda.synchronize()
    return loss.detach(), dict(zip(flat, grads))


@contextlib.contextmanager
def plain_ssd_backward(s):
    """The SSD chunk scan's gradient by the plain version's autograd,
    recomputed, in place of its backward kernel (``ssd_scan_bwd``), which
    ``ssd_scan_with_grad`` runs on either ``ssm_impl``: inside, a plain
    path (TRAIN_PLAIN) is plain end to end."""
    ssd = s.k.ssd
    kernel = ssd.ssd_scan_bwd
    ssd.ssd_scan_bwd = lambda *a: ssd._plain_grads(a[:5], (True,) * 5,
                                                   *a[5:])
    try:
        yield
    finally:
        ssd.ssd_scan_bwd = kernel


def kernel_path_grads(s, cfg, state, batch) -> dict:
    """One forward and backward of ``cfg`` on the kernel path from the
    compute params of ``state``: every parameter leaf's gradient must be
    finite and non-zero (a graph cut at a kernel leaves A_log, dt_bias and
    gate_norm, or wq, wk and wv, with none), the model kernels must launch
    as ``train_launches`` says, and the plain path's loss on the same
    params and batch must lie within TRAIN_LOSS_RTOL."""
    params = s.cast_params(state["master"], getattr(torch, cfg.param_dtype))
    s.build.reset_launches()
    loss, grads = loss_and_grads(s, cfg, params, batch)
    launches = s.build.launch_counts()
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())
           or not bool(g.abs().max() > 0)]
    require(not bad, f"train {cfg.name}: {len(bad)} of {len(grads)} leaves "
            f"have a zero or non-finite gradient on the kernel path: "
            f"{bad[:8]}")
    for name, n in train_launches(cfg, 1).items():
        require(launches.get(name, 0) == n,
                f"train {cfg.name}: a forward and backward launched {name} "
                f"{launches.get(name, 0)} times, want {n}")
    with torch.no_grad():
        plain, _ = s.get_model(cfg.replace(**TRAIN_PLAIN),
                               param_device(s, params)).loss_fn(params, batch)
    loss, plain = float(loss), float(plain)
    rel = abs(loss - plain) / abs(plain)
    require(np.isfinite(loss) and rel <= TRAIN_LOSS_RTOL,
            f"train {cfg.name}: step 1 loss {loss} on the kernel path, "
            f"{plain} on the plain path (relative {rel:.3g}, limit "
            f"{TRAIN_LOSS_RTOL})")
    log(f"train {cfg.name}: step 1 on the kernel path, all {len(grads)} "
        f"parameter leaves have finite non-zero gradients; loss {loss:.6f} "
        f"against the plain path's {plain:.6f} (relative {rel:.3g}, limit "
        f"{TRAIN_LOSS_RTOL}); launches of one forward and backward "
        f"{launches}")
    return {"loss": loss, "plain_loss": plain, "loss_rel_err": rel,
            "leaves": len(grads), "launches": launches}


def backward_ms(k, kernel, plain, inputs, apply=None) -> float:
    """CUDA-event ms of one backward through a kernel's autograd Function
    (the plain recompute and its gradients, or, with ``apply`` the SSD
    scan's ``ssd_scan_with_grad``, its backward kernel), the forward taken
    once."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = apply(kernel, *xs) if apply is not None \
        else k.grad.apply(kernel, plain, *xs)
    y = out[0] if isinstance(out, tuple) else out
    go = torch.ones_like(y)
    return cuda_ms(lambda: torch.autograd.grad(y, xs, go,
                                               retain_graph=True),
                   iters=5, warmup=1)


def trace_summary(s, tdir: str) -> dict:
    reader = s.TraceReader(tdir)
    recs = list(reader.iter_records(0))
    funcs = collections.Counter(r.func for r in recs)
    steps = [r.arg("step_idx") for r in recs if r.func == "step"]
    ck = {r.func: r for r in recs if r.func in ("ckpt_begin", "ckpt_end")}
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for root, _d, files in os.walk(tdir) for f in files)
    return {"records": len(recs), "by_function": dict(funcs),
            "steps": steps, "trace_bytes": nbytes,
            # ticks are microseconds (the trace's tick_unit)
            "ckpt_traced_s": (ck["ckpt_end"].t_entry
                              - ck["ckpt_begin"].t_exit) / 1e6}


def phase_train(s) -> dict:
    """mamba2-370m trains on the kernel path inside a ``session``: step 1's
    gradients and loss checked (``kernel_path_grads``); a ``Trainer`` takes
    TRAIN_STEPS steps and checkpoints (keep 1); a new ``Trainer``
    auto-resumes, its state bit-identical, and takes RESUME_STEPS more --
    launch counts set to 0 just before the two runs and read just after,
    and counted step by step.  Then one profiled step, the f32 gradient
    check at the same width (F32_GRAD_LAYERS layers, and all 48), and
    qwen1.5-0.5b's flash-attention gradients and DENSE_STEPS steps."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    cfg = s.get_config(TRAIN_ARCH)
    require(cfg.attn_impl == "cuda" and cfg.ssm_impl == "cuda"
            and cfg.remat == "block", "the kernel paths and block remat "
            "must be the defaults")
    root = os.path.join(WORK, "train")
    ckpt, tdir = os.path.join(root, "ckpt"), os.path.join(root, "trace")
    shutil.rmtree(root, ignore_errors=True)
    data = train_data(s, cfg)
    ocfg = s.AdamWConfig(**TRAIN_OCFG)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=dev).manual_seed(0)
    state = s.adamw_init(s.get_model(cfg, dev).init_params(gen))
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "state_bytes": s.state_nbytes(state),
           "step1": kernel_path_grads(s, cfg, state, data(0))}
    del state
    torch.cuda.empty_cache()

    marks = []

    def mark(step):
        marks.append((step, s.build.launch_counts()))

    def trainer(n):
        return s.Trainer(cfg, s.TrainerConfig(
            num_steps=n, ckpt_dir=ckpt, ckpt_every=TRAIN_STEPS, keep=1,
            seed=0), ocfg, data=data, fault_hook=mark, device=dev)
    torch.cuda.reset_peak_memory_stats()
    s.build.reset_launches()
    with s.session(s.RecorderConfig(trace_dir=tdir, encode_backend=BACKEND)):
        first = trainer(TRAIN_STEPS)
        first.run()
        mark(None)
        second = trainer(TRAIN_STEPS + RESUME_STEPS)
        t = time.monotonic()
        second.init_state()
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t
        require(second.start_step == TRAIN_STEPS,
                f"train: resumed at step {second.start_step}")
        a, b = (list(s.flat_params(tr.state).values())
                for tr in (first, second))
        require(len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b)),
            "train: the restored state differs from the saved one")
        del a, b            # else both states outlive the phase's later runs
        first.state = None
        second.run()
        mark(None)
    torch.cuda.synchronize()
    launches = s.build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = [{k: v - m0.get(k, 0) for k, v in m1.items()
                 if k in MODEL_KERNELS}
                for (st, m0), (_, m1) in zip(marks, marks[1:])
                if st is not None]
    want = {k: v for k, v in train_launches(cfg, 1).items() if v}
    require(len(per_step) == TRAIN_STEPS + RESUME_STEPS
            and all(p == want for p in per_step),
            f"train: model-kernel launches per step {per_step}, want {want}")
    for name in ("delta_zigzag", "uvarint_pack64"):
        require(launches.get(name, 0) > 0,
                f"train: the trace's finalize launched no {name}")
    log_ = first.metrics_log + second.metrics_log
    losses = [m["loss"] for m in log_]
    require(all(np.isfinite(losses)), f"train: losses {losses}")
    require(abs(losses[0] - res["step1"]["plain_loss"])
            <= TRAIN_LOSS_RTOL * abs(res["step1"]["plain_loss"]),
            f"train: the Trainer's step 1 loss {losses[0]} against the "
            f"plain path's {res['step1']['plain_loss']}")
    manifest = os.path.join(ckpt, f"step_{TRAIN_STEPS:08d}", "manifest.json")
    with open(manifest) as f:
        manifest = json.load(f)
    ckpt_bytes, n_arrays = manifest["total_bytes"], len(manifest["arrays"])
    require(ckpt_bytes == res["state_bytes"],
            f"train: checkpoint of {ckpt_bytes} B, state {res['state_bytes']}")
    trace = trace_summary(s, tdir)
    require(trace["steps"] == list(range(TRAIN_STEPS + RESUME_STEPS)),
            f"train trace: step records {trace['steps']}")
    # the save writes every array of the stacked layout and the manifest,
    # the resume reads them back
    for fn in ("shard_write_at", "shard_read_at"):
        require(trace["by_function"].get(fn) == n_arrays + 1,
                f"train trace: {trace['by_function'].get(fn)} {fn} "
                f"records, want {n_arrays + 1} (every array of the "
                f"checkpoint and its manifest)")
    step_s = [m["step_time_s"] for m in log_]

    batch = data(TRAIN_STEPS + RESUME_STEPS)
    step_fn = s.make_train_step(cfg, ocfg, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.monotonic()
        second.state, _ = step_fn(second.state, batch)
        torch.cuda.synchronize()
        prof_s = time.monotonic() - t
    events = prof.key_averages()
    busy = device_busy_ms(prof, events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    del first, second
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    res.update({
        "losses": losses, "step_s": step_s,
        "tokens_per_s": [tokens / x for x in step_s],
        "launches": launches, "launches_per_step": want,
        "peak_bytes": peak, "ckpt_bytes": ckpt_bytes,
        "ckpt_save_traced_s": trace["ckpt_traced_s"],
        "ckpt_restore_s": restore_s, "trace": trace,
        "profiled_step_s": prof_s, "busy_ms": busy,
        "idle_share": 1 - busy / (prof_s * 1e3),
        "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                        for e in top]})
    log(f"train {cfg.name} x {cfg.n_layers}, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens: losses {[round(x, 5) for x in losses]}; step s "
        f"{[round(x, 4) for x in step_s]}; launches per step {want}; "
        f"after the traced runs {launches}")
    log(f"train {cfg.name} resume: restored state bit-identical; restore "
        f"(init_state) {restore_s:.3f} s, save (ckpt_begin to ckpt_end in "
        f"the trace) {trace['ckpt_traced_s']:.3f} s, {ckpt_bytes} B")
    log(f"train {cfg.name} profiled step: {prof_s * 1e3:.2f} ms, device busy "
        f"{busy:.2f} ms (idle share {res['idle_share']:.4f}); top: "
        + "; ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in
                    res["top_kernels"]))

    res["f32_grads"] = [f32_grad_check(s, cfg, n, rtol, data(0)) for n, rtol
                        in ((F32_GRAD_LAYERS, GRAD_F32_RTOL),
                            (cfg.n_layers, F32_GRAD_FULL_RTOL))]

    # one backward per layer at the step's shapes: the SSD scan's by its
    # kernel and by the plain recompute, flash's by the plain recompute
    ssd_shape = (TRAIN_BATCH, TRAIN_SEQ // cfg.ssm_chunk, cfg.ssm_chunk,
                 cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    res["ssd_backward_ms"] = backward_ms(
        s.k, functools.partial(s.k.ssd.ssd_scan, return_state=True),
        s.k.ssd_ref.ssd_scan_chunked_ref,
        ssd_inputs(*ssd_shape, torch.bfloat16, 71))
    res["ssd_backward_kernel_ms"] = backward_ms(
        s.k, s.k.ssd.ssd_scan_op, s.k.ssd_ref.ssd_scan_chunked_ref,
        ssd_inputs(*ssd_shape, torch.bfloat16, 71),
        apply=s.k.ssd.ssd_scan_with_grad)
    res["dense"] = dense_train(s)
    res["moe"] = moe_train(s)
    res["encdec"] = encdec_train(s)
    res["flash_backward_ms"] = backward_ms(
        s.k, s.k.fa.flash_attention, s.k.fa_ref.flash_attention_ref,
        res["dense"].pop("qkv"))
    log(f"train: backward, bf16, per layer call: ssd_scan {ssd_shape} by "
        f"its kernel {res['ssd_backward_kernel_ms']:.3f} ms (x "
        f"{cfg.n_layers} a step), by plain recompute "
        f"{res['ssd_backward_ms']:.3f} ms; by plain recompute: "
        f"flash_attention at qwen1.5-0.5b's shape "
        f"{res['flash_backward_ms']:.3f} ms (x "
        f"{res['dense']['layers']} a step)")
    log(f"train numbers on {s.smi}: " + json.dumps(
        {k: v for k, v in res.items() if k not in ("top_kernels",)}))
    return res


def f32_grad_check(s, cfg, layers: int, rtol: float, batch) -> dict:
    """``cfg`` cut to ``layers`` layers in f32: every leaf's gradient on
    the kernel path (the SSD's forward and backward kernels, one
    ``ssd_scan_bwd`` a layer) within relative L2 ``rtol`` of the plain
    path's (no SSD kernel, the backward by ``plain_ssd_backward``) and
    non-zero; the plain path's own spread under a relative 1e-7
    perturbation of the weights is measured beside it."""
    dev = torch.device("cuda")
    c32 = cfg.replace(n_layers=layers, dtype="float32",
                      param_dtype="float32")

    def params(noise: float):
        p = s.get_model(c32, dev).init_params(
            torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(1)
        return s.cast_params(s.tree_map(lambda x, _: x * (1 + noise * (
            torch.randn(x.shape, generator=gen, device=dev))), p),
            torch.float32)

    def rel(a, b):
        return {n: float((a[n] - b[n]).norm() / b[n].norm()) for n in b}
    def plain_grads(p):
        with plain_ssd_backward(s):
            s.build.reset_launches()
            _, g = loss_and_grads(s, c32.replace(**TRAIN_PLAIN), p, batch)
            ssd = {n: s.build.launch_counts().get(n, 0)
                   for n in ("ssd_scan", "ssd_scan_bwd")}
        require(ssd == {"ssd_scan": 0, "ssd_scan_bwd": 0},
                f"train {cfg.name} f32 x {layers}: the plain path launched "
                f"{ssd}")
        return g
    p32 = params(0.0)
    s.build.reset_launches()
    _, gk = loss_and_grads(s, c32, p32, batch)
    bwd = s.build.launch_counts().get("ssd_scan_bwd", 0)
    require(bwd == layers, f"train {cfg.name} f32 x {layers}: the kernel "
            f"path launched ssd_scan_bwd {bwd} times, want {layers}")
    gp = plain_grads(p32)
    err = rel(gk, gp)
    worst = max(err, key=err.get)
    require(err[worst] <= rtol and all(bool(g.abs().max() > 0)
                                       for g in gk.values()),
            f"train {cfg.name} f32 x {layers}: gradient of {worst} differs "
            f"by {err[worst]:.3g} (relative L2, limit {rtol})")
    del gk, p32
    gq = plain_grads(params(1e-7))
    floor = rel(gq, gp)
    res = {"layers": layers, "limit": rtol, "leaves": len(err),
           "worst_leaf": worst, "worst": err[worst],
           "median": float(np.median(list(err.values()))),
           "plain_perturbed_worst": max(floor.values()),
           "plain_perturbed_median": float(np.median(list(floor.values())))}
    log(f"train {cfg.name} f32 x {layers} layers: every one of {len(err)} "
        f"leaves' gradients on the kernel path ({bwd} ssd_scan_bwd) within "
        f"relative L2 "
        f"{err[worst]:.3g} ({worst}; median {res['median']:.3g}) of the "
        f"plain path's, limit {rtol}; the plain path against itself with "
        f"the weights perturbed by 1e-7: worst "
        f"{res['plain_perturbed_worst']:.3g}, median "
        f"{res['plain_perturbed_median']:.3g}")
    del gp, gq
    torch.cuda.empty_cache()
    return res


def dense_train(s) -> dict:
    """qwen1.5-0.5b at full width and depth, bf16: step 1's gradients and
    loss on the kernel path (flash attention's Function), then DENSE_STEPS
    steps of ``make_train_step``, launches counted."""
    dev = torch.device("cuda")
    cfg = s.get_config(DENSE_TRAIN_ARCH)
    data = train_data(s, cfg)
    state = s.adamw_init(s.get_model(cfg, dev).init_params(
        torch.Generator(device=dev).manual_seed(0)))
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "step1": kernel_path_grads(s, cfg, state, data(0))}
    step = s.make_train_step(cfg, s.AdamWConfig(**TRAIN_OCFG), device=dev)
    s.build.reset_launches()
    losses, step_s = [], []
    for i in range(DENSE_STEPS):
        t = time.monotonic()
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
        step_s.append(time.monotonic() - t)
    launches = s.build.launch_counts()
    want = {k: v for k, v in train_launches(cfg, DENSE_STEPS).items() if v}
    require({k: launches.get(k, 0) for k in want} == want,
            f"train {cfg.name}: launches {launches}, want {want}")
    require(all(np.isfinite(losses)) and abs(
        losses[0] - res["step1"]["plain_loss"]) <= TRAIN_LOSS_RTOL * abs(
        res["step1"]["plain_loss"]), f"train {cfg.name}: losses {losses}")
    res.update({"losses": losses, "step_s": step_s, "launches": launches,
                "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / x
                                 for x in step_s]})
    log(f"train {cfg.name} x {cfg.n_layers}, bf16: {DENSE_STEPS} steps, "
        f"losses {losses}, step s {step_s}, launches {launches}")
    del state
    torch.cuda.empty_cache()
    res["qkv"] = tuple(randn((TRAIN_BATCH, TRAIN_SEQ, h, cfg.hd), 80 + i,
                             torch.bfloat16)
                       for i, h in enumerate((cfg.n_heads, cfg.n_kv_heads,
                                              cfg.n_kv_heads)))
    return res


# deepseek-moe-16b at full width, cut to its first dense layer and two MoE
# layers (about 1.68e9 parameters, 20 GB of f32 master and moments), on
# synthetic tokens; seamless-m4t-large-v2 at full width and depth (24 + 24
# layers, 2.03e9 parameters, 24.4 GB), with as many frames as tokens
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "deepseek-moe-16b", 3
ENCDEC_TRAIN_ARCH = "seamless-m4t-large-v2"
TRAINER_STEPS = 2
# the device memory such a run may take above what was allocated when it
# began (the card holds 80 GB); past it the depth would have to be cut
TRAINER_PEAK = 70e9


def moe_train(s) -> dict:
    cfg = s.get_config(MOE_TRAIN_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    return trainer_run(s, cfg, train_data(s, cfg))


def encdec_train(s) -> dict:
    cfg = s.get_config(ENCDEC_TRAIN_ARCH)
    return trainer_run(s, cfg, train_data(s, cfg))


def trainer_run(s, cfg, data) -> dict:
    """``cfg`` at full width, bf16: step 1's gradients and loss on the
    kernel path (``kernel_path_grads``: every leaf's gradient finite and
    non-zero -- a MoE router's and experts', an encoder-decoder's encoder
    and cross attention included -- and the loss within TRAIN_LOSS_RTOL
    of the plain path's), then a ``Trainer`` takes TRAINER_STEPS steps on
    ``data``, launches counted: losses and gradient norms finite, step 1's
    loss the kernel path's, a MoE's aux finite and above 0, the peak above
    what was allocated before under TRAINER_PEAK."""
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = s.adamw_init(s.get_model(cfg, dev).init_params(
        torch.Generator(device=dev).manual_seed(0)))
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_encoder_layers,
           "state_bytes": s.state_nbytes(state),
           "step1": kernel_path_grads(s, cfg, state, data(0))}
    del state
    torch.cuda.empty_cache()
    ckpt = os.path.join(WORK, "trainer_run")
    shutil.rmtree(ckpt, ignore_errors=True)
    tr = s.Trainer(cfg, s.TrainerConfig(num_steps=TRAINER_STEPS,
                                        ckpt_dir=ckpt, ckpt_every=0, seed=0),
                   s.AdamWConfig(**TRAIN_OCFG), data=data, device=dev)
    torch.cuda.reset_peak_memory_stats()
    s.build.reset_launches()
    tr.run()
    torch.cuda.synchronize()
    launches = s.build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v for k, v in train_launches(cfg, TRAINER_STEPS).items() if v}
    require({k: launches.get(k, 0) for k in want} == want,
            f"train {cfg.name}: launches {launches}, want {want}")
    log_ = tr.metrics_log
    for key in ("loss", "aux", "grad_norm"):
        vals = [m[key] for m in log_]
        require(len(vals) == TRAINER_STEPS and all(np.isfinite(vals)),
                f"train {cfg.name}: {key} {vals}")
    require(not cfg.is_moe or all(m["aux"] > 0 for m in log_),
            f"train {cfg.name}: aux {[m['aux'] for m in log_]}")
    plain = res["step1"]["plain_loss"]
    require(abs(log_[0]["loss"] - plain) <= TRAIN_LOSS_RTOL * abs(plain),
            f"train {cfg.name}: the Trainer's step 1 loss {log_[0]['loss']} "
            f"against the plain path's {plain}")
    require(peak - base <= TRAINER_PEAK,
            f"train {cfg.name}: peak {peak} B, {peak - base} B above the "
            f"{base} B allocated before, over {TRAINER_PEAK:.0f}")
    step_s = [m["step_time_s"] for m in log_]
    res.update({"losses": [m["loss"] for m in log_],
                "aux": [m["aux"] for m in log_],
                "grad_norm": [m["grad_norm"] for m in log_],
                "step_s": step_s, "launches": launches, "peak_bytes": peak,
                "allocated_before_bytes": base,
                "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / x
                                 for x in step_s]})
    log(f"train {cfg.name} x {cfg.n_layers}"
        + (f" + {cfg.n_encoder_layers} encoder layers"
           if cfg.n_encoder_layers else "")
        + f", bf16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: {TRAINER_STEPS} "
        f"Trainer steps, losses {res['losses']}, aux {res['aux']}, grad "
        f"norms {res['grad_norm']}, step s {step_s}, peak {peak} B ({base} "
        f"B allocated before), state {res['state_bytes']} B, launches "
        f"{launches}")
    del tr
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase examples: the port's quickstart and workflow-analysis examples on
# the card, at their smoke sizes (the qwen1.5-0.5b smoke model; the
# quickstart at EXAMPLE_STEPS steps), each trace read back
# ---------------------------------------------------------------------------

EXAMPLE_STEPS = 4
# name: (arguments, train steps, serve_step records)
EXAMPLES = {"torch_quickstart": (["--steps", str(EXAMPLE_STEPS)],
                                 EXAMPLE_STEPS, 0),
            "torch_workflow_analysis": ([], 20, 11)}


# ---------------------------------------------------------------------------
# phase 11a: the sharded path on a one-rank mesh; 11b: the dry run
# ---------------------------------------------------------------------------

# (arch, layers, prompt) of the sharded serve runs; SHARDED_NEW greedy
# steps each, SERVE_BATCH prompts
SHARDED_SERVES = (("qwen3-32b", 8, 1024), ("mamba2-370m", 48, 2048))
SHARDED_NEW = 32
SHARDED_TRAIN_ARCH, SHARDED_TRAIN_STEPS = "qwen1.5-0.5b", 2


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def full(t):
    """The whole tensor of a DTensor (plain tensors as they are)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def timed(fn):
    torch.cuda.synchronize()
    t = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t


def counted(s, fn):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: (its result, seconds, the model kernels' launches)."""
    s.build.reset_launches()
    out, sec = timed(fn)
    got = s.build.launch_counts()
    return out, sec, {k: got.get(k, 0) for k in MODEL_KERNELS}


def sharded_serve(s, mesh, arch: str, layers: int, prompt: int) -> dict:
    """Prefill and SHARDED_NEW greedy steps, unsharded and through
    ``build_cell`` on ``mesh``: the same tokens, logits and launches."""
    dev = torch.device("cuda")
    cfg = cut_layers(s.get_config(arch), layers)
    model = s.get_model(cfg, dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    batch = serve_batch(cfg, SERVE_BATCH, prompt, 0, dev)
    max_seq = prompt + SHARDED_NEW + 1
    B = SERVE_BATCH

    def first(logits):
        return torch.argmax(logits[:, :cfg.vocab_size], dim=-1).to(
            torch.int32)[:, None]

    def plain_prefill():
        with torch.no_grad():
            return model.prefill(params, batch)

    def plain_decode(cache, nxt):
        toks = []
        with torch.no_grad():
            for _ in range(SHARDED_NEW):
                nxt, cache = model.decode_step(params, cache, nxt)
                toks.append(nxt)
        return torch.cat(toks, dim=1)

    (p_logits, pf), p_pre_s, p_pre_n = counted(s, plain_prefill)
    cache = s.seat(model.init_cache(B, max_seq), pf)
    p_toks, p_dec_s, p_dec_n = counted(
        s, lambda: plain_decode(cache, first(p_logits)))
    del pf, cache

    tb = {"tokens": torch.as_tensor(batch["tokens"], device=dev)}
    step, args, _ = s.build_cell(cfg, s.ShapeSpec("p", prompt, B, "prefill"),
                                 mesh, params=params, inputs={"batch": tb})
    (d_logits, pf), d_pre_s, d_pre_n = counted(s, lambda: step(*args))
    d_logits = full(d_logits)
    pf = s.map_leaves(lambda _, t: full(t), pf)
    del step, args
    cache = s.seat(model.init_cache(B, max_seq), pf)
    del pf
    step, args, _ = s.build_cell(
        cfg, s.ShapeSpec("d", max_seq, B, "decode"), mesh, params=params,
        inputs={"cache": cache, "tokens": first(d_logits)})
    p_args, cache_d, tok = args

    def sharded_decode():
        nonlocal cache_d
        toks, t = [], tok
        for _ in range(SHARDED_NEW):
            t, cache_d = step(p_args, cache_d, t)
            toks.append(full(t))
        return torch.cat(toks, dim=1)
    d_toks, d_dec_s, d_dec_n = counted(s, sharded_decode)
    res = {"arch": arch, "layers": layers, "prompt": prompt,
           "logits_identical": bool(torch.equal(d_logits, p_logits)),
           "logits_max_abs": float((d_logits - p_logits).abs().max()),
           "tokens_identical": bool(torch.equal(d_toks, p_toks)),
           "prefill_s": {"sharded": d_pre_s, "unsharded": p_pre_s},
           "decode_s_per_step": {"sharded": d_dec_s / SHARDED_NEW,
                                 "unsharded": p_dec_s / SHARDED_NEW},
           "launches": {"sharded": {k: d_pre_n[k] + d_dec_n[k]
                                    for k in MODEL_KERNELS},
                        "unsharded": {k: p_pre_n[k] + p_dec_n[k]
                                      for k in MODEL_KERNELS}}}
    log(f"sharded {arch} x {layers}: {json.dumps(res)}")
    require(res["logits_identical"] and res["tokens_identical"],
            f"sharded {arch}: logits or tokens differ from the unsharded "
            f"path ({res['logits_max_abs']})")
    require(res["launches"]["sharded"] == res["launches"]["unsharded"],
            f"sharded {arch}: launches {res['launches']}")
    require(any(res["launches"]["sharded"].values()),
            f"sharded {arch}: no model kernel launched")
    del params, p_args, cache_d, step
    torch.cuda.empty_cache()
    return res


def sharded_train(s, mesh) -> dict:
    """SHARDED_TRAIN_STEPS steps of qwen1.5-0.5b at full depth, unsharded
    (``make_train_step``) and through ``build_cell`` with ZeRO-1 over the
    one-rank data axis, from the same state on the same data."""
    dev = torch.device("cuda")
    cfg = s.get_config(SHARDED_TRAIN_ARCH)
    data = train_data(s, cfg)
    params = s.get_model(cfg, dev).init_params(
        torch.Generator(device=dev).manual_seed(0))
    ocfg = s.AdamWConfig(**TRAIN_OCFG)

    def batch(i):
        return {k: torch.as_tensor(v, device=dev) for k, v in data(i).items()}

    plain = s.make_train_step(cfg, ocfg, device=dev)
    state = s.adamw_init(params)

    def run(step_fn, st, put):
        """The steps, each timed: (state, losses, seconds a step)."""
        losses, secs = [], []
        for i in range(SHARDED_TRAIN_STEPS):
            (st, m), sec = timed(lambda: step_fn(st, put(batch(i))))
            losses.append(float(full(m["loss"])))
            secs.append(sec)
        return st, losses, secs

    (p_state, p_losses, p_s), _, p_n = counted(
        s, lambda: run(plain, state, lambda b: b))
    p_master = s.flat_params(p_state["master"])
    del p_state

    step, args, meta = s.build_cell(
        cfg, s.ShapeSpec("t", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh,
        ocfg=ocfg, params=params, inputs={"batch": batch(0)})

    (d_state, d_losses, d_s), _, d_n = counted(s, lambda: run(
        step, args[0], lambda b: s.build_cell_batch(b, meta, mesh)))
    d_master = {k: full(v) for k, v in s.flat_params(
        d_state["master"]).items()}
    differ = {k: float((d_master[k] - p_master[k]).abs().max())
              for k in p_master if not torch.equal(d_master[k], p_master[k])}
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "steps": SHARDED_TRAIN_STEPS,
           "losses": {"sharded": d_losses, "unsharded": p_losses},
           "master_leaves": len(p_master), "master_differ": differ,
           # step 1 of the unsharded path, the first, pays the warm-up
           "step_s": {"sharded": d_s, "unsharded": p_s},
           "launches": {"sharded": d_n, "unsharded": p_n}}
    log(f"sharded train {cfg.name} x {cfg.n_layers}: {json.dumps(res)}")
    require(d_losses == p_losses and not differ,
            f"sharded train {cfg.name}: losses {d_losses} vs {p_losses}, "
            f"master differs at {differ}")
    require(d_n == p_n and d_n["flash_attention"] > 0,
            f"sharded train {cfg.name}: launches {res['launches']}")
    del d_state, args, d_master, p_master
    torch.cuda.empty_cache()
    return res


OP_DISPATCH_CALLS = 2000


def operator_dispatch() -> dict:
    """Host microseconds a call of RMSNorm through its operator
    (``repro_torch::rmsnorm``, the model's path to the kernel) and through
    its wrapper, at qwen3-32b's decode QK-norm shape (4, 1, 64, 128) bf16:
    OP_DISPATCH_CALLS calls queued back to back, synchronised once, in the
    order wrapper, operator, operator, wrapper."""
    from repro_torch.kernels.rmsnorm import ops
    x = torch.randn((4, 1, 64, 128), device="cuda", dtype=torch.bfloat16)
    w = torch.ones(128, device="cuda", dtype=torch.float32)

    def per_call(fn) -> float:
        for _ in range(50):
            fn(x, w, eps=1e-6)
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(OP_DISPATCH_CALLS):
            fn(x, w, eps=1e-6)
        torch.cuda.synchronize()
        return (time.monotonic() - t) / OP_DISPATCH_CALLS * 1e6
    runs = [per_call(f) for f in (ops.rmsnorm, ops.rmsnorm_op,
                                  ops.rmsnorm_op, ops.rmsnorm)]
    res = {"wrapper_us": (runs[0] + runs[3]) / 2,
           "operator_us": (runs[1] + runs[2]) / 2, "runs_us": runs}
    log(f"operator dispatch, rmsnorm (4, 1, 64, 128) bf16: wrapper "
        f"{res['wrapper_us']:.2f} us, operator {res['operator_us']:.2f} us "
        f"a call (runs {runs})")
    return res


def phase_sharded(s) -> dict:
    """Phase 11a (see the module docstring)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = s.make_debug_mesh(1, 1, device_type="cuda")
        out = {arch: sharded_serve(s, mesh, arch, layers, prompt)
               for arch, layers, prompt in SHARDED_SERVES}
        out["train"] = sharded_train(s, mesh)
    finally:
        dist.destroy_process_group()
    return out


DRYRUN_JOBS = 7
DRYRUN_MULTI = ("qwen3-32b", "deepseek-moe-16b")
# single-pod cells run again on cpu fake tensors: FLOPs and collective
# bytes must not depend on the fake tensors' device, nor the peak but in
# decode (on cuda ``lm.logits_f32`` writes f32 from the bf16 head without
# an f32 copy of it)
DRYRUN_CPU_CHECK = (("qwen3-32b", "prefill_32k"), ("qwen1.5-0.5b", "train_4k"),
                    ("stablelm-1.6b", "decode_32k"),
                    ("deepseek-moe-16b", "decode_32k"),
                    ("mamba2-370m", "train_4k"))


def dryrun_cells(s) -> list:
    """The dryrun phase's cells, shape by shape, so that the long train
    cells start first."""
    return [(a, sh, mk, "cuda", False, False) for sh in s.SHAPES
            for mk, archs in (("single", s.all_arch_names()),
                              ("multi", DRYRUN_MULTI)) for a in archs]


def start_dryrun(s) -> dict:
    """Start the dryrun phase's one pool of worker processes on a thread
    of its own: the roofline cells and the cpu checks first, then every
    cell.  Returns the handle ``phase_dryrun`` joins: the results, the
    seconds the pool took and what it raised."""
    job = {"results": [], "error": None, "seconds": None}
    cells = ([("roofline", a, sh, "cuda") for a, sh in ROOFLINE_CELLS]
             + [(a, sh, "single", "cpu", False, False)
                for a, sh in DRYRUN_CPU_CHECK] + dryrun_cells(s))

    def run():
        t = time.monotonic()
        try:
            job["results"].extend(s.dryrun.run_cells(
                cells, DRYRUN_JOBS, fn=dry_or_roofline))
        except BaseException as e:  # noqa: BLE001  (raised by the phase)
            job["error"] = e
        job["seconds"] = time.monotonic() - t

    job["thread"] = threading.Thread(target=run, name="dryrun", daemon=True)
    job["thread"].start()
    return job


def phase_dryrun(s, job: dict) -> dict:
    """Phase 11b (see the module docstring): the results of the pool
    ``start_dryrun`` started, checked."""
    cells = dryrun_cells(s)
    out, on_cpu, roof = {}, {}, []
    t = time.monotonic()
    job["thread"].join()
    if job["error"] is not None:
        raise job["error"]
    log(f"dry run: the worker pool took {job['seconds']:.1f} s beside "
        f"phases 2-3; this phase waited {time.monotonic() - t:.1f} s for it")
    for r in job["results"]:
        if r.get("kind") == "roofline":
            roof.append(r)
            continue
        if r["device"] == "cpu":
            on_cpu[f"{r['arch']} {r['shape']} single"] = r
            continue
        log(s.dryrun.format_result(r))
        key = f"{r['arch']} {r['shape']} {r['mesh']}"
        require(r["status"] != "fail", f"dry run {key}: {r.get('error')}\n"
                f"{r.get('traceback')}")
        ok = s.applicable(s.get_config(r["arch"]), r["shape"])[0]
        require((r["status"] == "ok") == ok, f"dry run {key}: {r['status']}")
        out[key] = {k: r.get(k) for k in (
            "status", "run_s", "memory", "flops_per_chip",
            "model_flops_per_chip", "fits_80gb", "departures")}
        if r["status"] == "ok":
            coll = r["collectives"]
            out[key]["collectives"] = dict(
                {k: coll[k]["bytes"] for k in s.dryrun.step_analysis.KINDS},
                total=coll["total_bytes"], cross_node=coll["cross_node_bytes"])
            out[key]["roofline"] = {k: r["roofline"][k] for k in (
                "t_compute_s", "t_memory_s", "t_collective_s",
                "bottleneck")}
    n_ok = sum(v["status"] == "ok" for v in out.values())
    n_skip = sum(v["status"] == "skip" for v in out.values())
    require(n_ok + n_skip == len(cells), f"dry run: {len(out)} cells")
    for key, r in on_cpu.items():
        same = {"flops": r["flops_per_chip"] == out[key]["flops_per_chip"],
                "collectives": r["collectives"]["total_bytes"]
                == out[key]["collectives"]["total"]}
        if s.SHAPES[r["shape"]].kind != "decode":
            same["peak"] = r["memory"] == out[key]["memory"]
        log(f"dry run {key}: cuda and cpu fake tensors agree: {same}")
        require(all(same.values()), f"dry run {key}: cpu {r['memory']}, "
                f"{r['flops_per_chip']}; cuda {out[key]}")
    log(f"dry run: {n_ok} cells ok, {n_skip} skipped, on a fake 256-rank "
        f"(512 for the multi-pod cells) mesh, with the roofline cells in "
        f"{job['seconds']:.1f} s")
    out["roofline"] = roofline_cells(s, out, roof)
    return out


def dry_or_roofline(cell) -> dict:
    """A dry-run cell, or a ("roofline", arch, shape, device) one: the
    worker function of the dryrun phase's processes."""
    from repro_torch.launch import dryrun, roofline
    if cell[0] == "roofline":
        return dict(roofline.run_one(cell[1:]), kind="roofline")
    arch, shape, mesh, device, smoke, full_depth = cell
    return dryrun.run_cell(arch, shape, mesh, device=device, smoke=smoke,
                           full_depth=full_depth)


# the roofline report's cells, each against the dry run's same cell
ROOFLINE_CELLS = (("qwen3-32b", "train_4k"), ("mamba2-370m", "prefill_32k"),
                  ("deepseek-moe-16b", "decode_32k"),
                  ("hymba-1.5b", "long_500k"))


def roofline_cells(s, dry: dict, results: list) -> dict:
    """The results of ``roofline.analyze_cell`` for ``ROOFLINE_CELLS`` on
    ``cuda`` fake tensors (run in the dry run's worker processes): each
    cell's extrapolated FLOPs and collective bytes must be the dry run's
    (the clamp of a negative per-layer delta must not bind), and
    ``report()`` prints them."""
    art = os.path.join(WORK, "roofline")
    out = {}
    require(len(results) == len(ROOFLINE_CELLS),
            f"roofline: {len(results)} cells")
    for r in results:
        r.pop("kind", None)
        key = f"{r['arch']} {r['shape']} single"
        require(r["status"] == "ok", f"roofline {key}: {r}")
        s.roofline.save(r, art)
        log(s.roofline.format_line(r))
        ext, d = r["extrapolated"], dry[key]
        same = {"flops": ext["flops"] == d["flops_per_chip"],
                "collectives": ext["coll"] == d["collectives"]["total"],
                "no clamp": min(r["per_layer_delta"].values()) >= 0}
        require(all(same.values()), f"roofline {key}: {same}; "
                f"{ext} against {d['flops_per_chip']}, "
                f"{d['collectives']['total']}")
        out[key] = {"extrapolated": ext,
                    "per_layer_delta": r["per_layer_delta"],
                    "roofline": {k: r["roofline"][k] for k in (
                        "t_compute_s", "t_memory_s", "t_memory_op_s",
                        "t_collective_s", "bottleneck",
                        "useful_flop_ratio", "roofline_fraction")}}
    log(f"roofline: {len(out)} cells as the dry run's, fake 256-rank "
        f"mesh:\n{s.roofline.report(art)}")
    return out


def phase_examples(s) -> dict:
    """Each example's ``main`` on the card (``--device cuda``, the trace
    on the ``cuda`` encode backend) under a work directory of its own:
    launch counts set to 0 before and read after (the model trains and
    serves through the flash kernel; the finalize packs varints and
    compresses timestamps on the card); its trace read back with the
    step and serve-step records the example made."""
    import importlib.util
    out = {}
    for name, (args, steps, serve_steps) in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        work = os.path.join(WORK, "examples", name)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.synchronize()
        s.build.reset_launches()
        t = time.monotonic()
        rc = mod.main(args + ["--device", "cuda", "--encode-backend",
                              BACKEND, "--work-dir", work])
        torch.cuda.synchronize()
        secs = time.monotonic() - t
        launches = s.build.launch_counts()
        require(rc == 0, f"example {name} returned {rc}")
        for kernel in ("flash_attention", "delta_zigzag", "uvarint_pack64"):
            require(launches.get(kernel, 0) > 0,
                    f"example {name}: {kernel} was not launched")
        recs = list(s.TraceReader(os.path.join(work, "trace")
                                  ).iter_records(0))
        funcs = collections.Counter(r.func for r in recs)
        require(funcs["step"] == steps and funcs["serve_step"] == serve_steps,
                f"example {name}: trace reads back {funcs['step']} step and "
                f"{funcs['serve_step']} serve_step records")
        out[name] = {"s": secs, "records": len(recs),
                     "functions": len(funcs), "launches": launches}
        log(f"example {name} on the card: {secs:.2f} s, trace reads back "
            f"{len(recs)} records of {len(funcs)} functions ({steps} step, "
            f"{serve_steps} serve_step); launches {launches}")
    shutil.rmtree(os.path.join(WORK, "examples"), ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase evaluation: the paper's size evaluation (Figs 4-7, Table 4, Fig 10)
# through the port's run_ranks and baselines, at the rank counts of the
# reference's own scripts
# ---------------------------------------------------------------------------

EVAL_FIG6_RANKS = (4, 16, 64, 256, 512)  # examples/constant_trace_scaling.py
EVAL_TABLE4_RANKS = (16, 64, 256)        # benchmarks/tool_comparison.py
EVAL_FIG10_ITERS = 1000                  # benchmarks/overhead.py, best of 3
EVAL_FIG10_REPEATS = 3
EVAL_KERNELS = ("fit_columns", "delta_zigzag", "uvarint_pack64")


def parts_digest(parts: dict) -> str:
    """sha256 over what ``run_ranks``'s sizes count: the merged CST
    entries, the unique grammars, the cfg index and the timestamp blobs."""
    h = hashlib.sha256()
    for key in ("merged_entries", "unique_cfgs", "timestamps"):
        h.update(key.encode() + len(parts[key]).to_bytes(8, "little"))
        for blob in parts[key]:
            h.update(len(blob).to_bytes(8, "little") + blob)
    h.update(np.asarray(parts["cfg_index"], np.int64).tobytes())
    return h.hexdigest()


class Tee:
    """Feeds every record to several baseline tools: one pass of the calls
    serves them all."""

    def __init__(self, *tools):
        self.tools = tools

    def record(self, *args) -> None:
        for tool in self.tools:
            tool.record(*args)


class Evaluation:
    """The jobs of phase evaluation.  ``job`` runs one workload through
    ``run_ranks`` flat on ``cuda``, the launch counts set to 0 just before
    and read just after; then ``finalize_recorders`` finalizes the same
    recorded calls flat on ``numpy`` (sizes equal; merged entries,
    grammars, cfg index and timestamp blobs equal bit for bit) and, with
    ``tree``, tree on ``cuda`` (sizes equal).  ``fit_classify`` is counted
    by backend, so that each ``cuda`` job must launch ``fit_columns`` once
    a fit dispatch of its ``numpy`` twin."""

    def __init__(self, ev, smi: str):
        self.ev, self.smi = ev, smi
        self.data_dir = os.path.join(WORK, "eval", "data")
        self.fits = []               # (backend, (C, R)) of each dispatch
        self.launches = collections.Counter()   # summed over cuda jobs
        self.jobs = 0
        self.tree_jobs = 0
        self.fit_jobs = 0
        self.max_fit = (0, 0)        # (C, R) of the most ranks fitted
        self.cuda_s = 0.0
        self.busy_ms = 0.0           # device busy time of the cuda jobs

    def fit_shim(self, V, backend=None, _real=None):
        self.fits.append((backend, tuple(V.shape)))
        return _real(V, backend)

    def finalize(self, recs: list, backend: str, topology: str,
                 parts=None) -> dict:
        """The recorded calls of ``recs`` finalized again on ``backend``."""
        ev = self.ev
        configs = [rec.config for rec in recs]
        ev.eb.set_default_backend(backend)
        try:
            for rec in recs:
                rec.config = dataclasses.replace(rec.config,
                                                 encode_backend=backend)
            return ev.wl.finalize_recorders(recs, topology, parts=parts)
        finally:
            for rec, config in zip(recs, configs):
                rec.config = config
            ev.eb.set_default_backend(BACKEND)

    def job(self, workload: str, nprocs: int, cfg_kw: dict, tree: bool,
            **kw) -> dict:
        from torch.profiler import ProfilerActivity, profile
        ev, build = self.ev, self.ev.build
        what = f"{workload} x {nprocs} {cfg_kw} {kw}"
        self.fits.clear()
        got_parts, want_parts = {}, {}
        torch.cuda.synchronize()
        build.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.monotonic()
            got = ev.wl.run_ranks(
                getattr(ev.wl, workload), nprocs,
                ev.RecorderConfig(encode_backend=BACKEND, **cfg_kw), "flat",
                parts=got_parts, data_dir=self.data_dir, **kw)
            torch.cuda.synchronize()
            self.cuda_s += time.monotonic() - t
        self.busy_ms += device_busy_ms(prof)
        launches = build.launch_counts()
        cuda_fits = [shape for b, shape in self.fits if b == BACKEND]
        self.fits.clear()
        recs = got_parts["recorders"]
        want = self.finalize(recs, "numpy", "flat", want_parts)
        numpy_fits = [shape for b, shape in self.fits if b == "numpy"]
        require(got == want, f"evaluation {what}: cuda sizes {got} != "
                f"numpy sizes {want}")
        require(parts_digest(got_parts) == parts_digest(want_parts),
                f"evaluation {what}: cuda and numpy bytes differ")
        n_fit = launches.get("fit_columns", 0)
        require(n_fit == len(cuda_fits) == len(numpy_fits),
                f"evaluation {what}: {len(numpy_fits)} fit dispatches on "
                f"numpy, {len(cuda_fits)} on cuda, {n_fit} fit_columns "
                f"launches")
        if cfg_kw.get("inter_patterns", True) and nprocs > 1:
            require(n_fit >= 1, f"evaluation {what}: no fit_columns launch "
                    f"in a job with rank-linear groups to fit")
        want_dz = nprocs if cfg_kw.get("timestamps", True) else 0
        require(launches.get("delta_zigzag", 0) == want_dz,
                f"evaluation {what}: delta_zigzag launched "
                f"{launches.get('delta_zigzag', 0)} times, want {want_dz}")
        if tree:
            got_tree = self.finalize(recs, BACKEND, "tree")
            require(got_tree == got, f"evaluation {what}: tree sizes "
                    f"{got_tree} != flat sizes {got}")
            self.tree_jobs += 1
        self.jobs += 1
        self.fit_jobs += n_fit > 0
        self.launches.update(launches)
        for shape in cuda_fits:
            self.max_fit = max(self.max_fit, shape, key=lambda s: s[::-1])
        got["launches"] = launches
        return got

    def baselines(self, tool_classes: tuple, nprocs: int, **kw) -> list:
        """Each baseline's bytes over all ranks (Recorder-old's buffer,
        Darshan-like's serialized log), the tools fed together through one
        ``ToolAdapter`` a rank, behind the same wrappers."""
        ev = self.ev
        totals = [0] * len(tool_classes)
        for r in range(nprocs):
            tools = [cls(r) for cls in tool_classes]
            ev.wl.flash_rank(ev.bl.ToolAdapter(Tee(*tools), rank=r), r,
                             nprocs, data_dir=self.data_dir, **kw)
            for i, tool in enumerate(tools):
                totals[i] += (len(tool.serialize())
                              if hasattr(tool, "serialize") else tool.nbytes)
        return totals


def eval_figs45(e: Evaluation) -> dict:
    """Figs 4 and 5 (IOR, timestamps off): the cases and assertions of
    tests/test_scaling_invariants.py:24-58."""
    def ior(nprocs, n_calls, **c):
        return e.job("ior_rank", nprocs, dict(timestamps=False, **c), True,
                     n_calls=n_calls)["pattern_bytes"]
    r = {"intra_32": ior(8, 32), "intra_1024": ior(8, 1024),
         "nointra_32": ior(8, 32, intra_patterns=False),
         "nointra_1024": ior(8, 1024, intra_patterns=False),
         "inter_4": ior(4, 128), "inter_64": ior(64, 128),
         "nointer_4": ior(4, 128, inter_patterns=False),
         "nointer_64": ior(64, 128, inter_patterns=False),
         "base_16": ior(16, 128),
         "nointra_inter_4": ior(4, 128, intra_patterns=False),
         "nointra_inter_64": ior(64, 128, intra_patterns=False)}
    require(abs(r["intra_1024"] - r["intra_32"]) <= 4,
            f"Fig 4: pattern bytes grow with calls: {r}")
    require(r["nointra_1024"] > 8 * r["nointra_32"],
            f"Fig 4: without intra patterns the bytes must grow: {r}")
    require(abs(r["inter_64"] - r["inter_4"]) <= 8,
            f"Fig 5: pattern bytes grow with ranks: {r}")
    require(r["nointer_64"] > 10 * r["nointer_4"],
            f"Fig 5: without inter patterns the bytes must grow: {r}")
    require(abs(r["nointra_inter_64"] - r["nointra_inter_4"])
            <= 0.05 * r["nointra_inter_4"]
            and r["nointra_inter_4"] > r["base_16"],
            f"Fig 5: intra off, inter on must stay constant and larger: {r}")
    log(f"Figs 4-5 (IOR pattern bytes) [{e.smi}]: {json.dumps(r)}")
    return r


def eval_fig6(e: Evaluation) -> dict:
    """Fig 6 (FLASH weak scaling, 60 iterations): Recorder's pattern bytes
    within 16 B of one another from 4 to 512 ranks, Recorder-old's growing;
    then the growing and rolling cases at 8 ranks (:61-79)."""
    rows = []
    log(f"Fig 6 [{e.smi}]: ranks, records, Recorder CFG+CST B, "
        f"Recorder-old B, ratio")
    for n in EVAL_FIG6_RANKS:
        r = e.job("flash_rank", n, {"timestamps": False}, True,
                  iterations=60)
        old, = e.baselines((e.ev.bl.RecorderOld,), n, iterations=60)
        rows.append({"nprocs": n, "n_records": r["n_records"],
                     "pattern_bytes": r["pattern_bytes"], "old_bytes": old,
                     "ratio": old / r["pattern_bytes"],
                     "fit_columns": r["launches"].get("fit_columns", 0)})
        log(f"Fig 6 [{e.smi}]: {n:4d} {r['n_records']:7d} "
            f"{r['pattern_bytes']:6d} B {old:9d} B "
            f"{old / r['pattern_bytes']:8.1f}x")
    pb = [row["pattern_bytes"] for row in rows]
    old = [row["old_bytes"] for row in rows]
    require(max(pb) - min(pb) <= 16,
            f"Fig 6: pattern bytes {pb} spread over 16 B")
    require(all(a < b for a, b in zip(old, old[1:])),
            f"Fig 6: Recorder-old bytes {old} must grow with the ranks")

    def flash8(iterations, rolling):
        return e.job("flash_rank", 8, {"timestamps": False}, True,
                     iterations=iterations, rolling=rolling)["pattern_bytes"]
    grow = (flash8(80, False), flash8(320, False))
    roll = (flash8(80, True), flash8(320, True))
    require(grow[1] > grow[0] + 100 and abs(roll[1] - roll[0]) <= 8,
            f"Fig 6: growing {grow} must grow, rolling {roll} must not")
    log(f"Fig 6 at 8 ranks, 80 / 320 iterations [{e.smi}]: growing "
        f"{grow[0]} / {grow[1]} B, rolling {roll[0]} / {roll[1]} B")
    return {"rows": rows, "growing": grow, "rolling": roll}


def eval_fig7(e: Evaluation) -> dict:
    """Fig 7: collective mode, 64 against 1,024 ranks, 40 iterations,
    stripe 8 (:82-86): no fewer unique grammars at 1,024."""
    small, big = (e.job("flash_rank", n, {"timestamps": False}, False,
                        iterations=40, mode="collective", stripe=8)
                  for n in (64, 1024))
    require(big["n_unique_cfgs"] >= small["n_unique_cfgs"],
            f"Fig 7: {big['n_unique_cfgs']} unique grammars at 1,024 ranks, "
            f"{small['n_unique_cfgs']} at 64")
    r = {n: {k: v for k, v in x.items() if k != "launches"}
         for n, x in ((64, small), (1024, big))}
    log(f"Fig 7 (collective, stripe 8) [{e.smi}]: {json.dumps(r)}")
    return r


def eval_table4(e: Evaluation) -> list:
    """Table 4 (benchmarks/tool_comparison.py:26-62): Recorder's total
    bytes against Recorder-old's and Darshan-like's, 100 iterations,
    independent and collective; Recorder-old over 5x Recorder (:89-103)."""
    rows = []
    log(f"Table 4 [{e.smi}]: mode, ranks, records, Recorder B, "
        f"Recorder-old B, Darshan-like B, old_over_new, new_over_darshan")
    for mode in ("independent", "collective"):
        for n in EVAL_TABLE4_RANKS:
            rec = e.job("flash_rank", n, {}, True, iterations=100, mode=mode)
            old, dar = e.baselines((e.ev.bl.RecorderOld,
                                    e.ev.bl.DarshanLike), n,
                                   iterations=100, mode=mode)
            row = {"mode": mode, "nprocs": n, "n_records": rec["n_records"],
                   "recorder_bytes": rec["total_bytes"],
                   "recorder_pattern_bytes": rec["pattern_bytes"],
                   "recorder_old_bytes": old, "darshan_bytes": dar,
                   "old_over_new": old / rec["total_bytes"],
                   "new_over_darshan": rec["total_bytes"] / dar}
            rows.append(row)
            log(f"Table 4 [{e.smi}]: {mode} {n:4d} {rec['n_records']:7d} "
                f"{rec['total_bytes']:8d} B {old:9d} B {dar:8d} B "
                f"{row['old_over_new']:.2f} {row['new_over_darshan']:.2f}")
            require(old > 5 * rec["total_bytes"],
                    f"Table 4 {mode} at {n} ranks: Recorder-old {old} B is "
                    f"not over 5x Recorder's {rec['total_bytes']} B")
    return rows


def eval_fig10(e: Evaluation) -> list:
    """Fig 10 (benchmarks/overhead.py:29-60): one rank, FLASH iterations
    on tmpfs, best of 3 a tool: per-call microseconds and wall time
    relative to no tool.  Printed only: tmpfs is not Lustre."""
    ev = e.ev
    d = os.path.join(WORK, "eval", "fig10")

    def time_one(make_tool) -> tuple:
        best, n_records = float("inf"), 0
        for _ in range(EVAL_FIG10_REPEATS):
            shutil.rmtree(d, ignore_errors=True)
            tool = make_tool()
            t0 = time.perf_counter()
            ev.wl.flash_rank(tool, 0, 1, iterations=EVAL_FIG10_ITERS,
                             data_dir=d)
            best = min(best, time.perf_counter() - t0)
            n_records = getattr(tool, "n_records", 0) or getattr(
                getattr(tool, "_tool", None), "n_records", 0)
        return best, n_records

    runs = {
        "none": time_one(lambda: None),
        "recorder": time_one(lambda: ev.Recorder(
            0, ev.RecorderConfig(encode_backend=BACKEND))),
        "recorder_old": time_one(
            lambda: ev.bl.ToolAdapter(ev.bl.RecorderOld(0))),
        "darshan": time_one(lambda: ev.bl.ToolAdapter(ev.bl.DarshanLike(0))),
    }
    shutil.rmtree(d, ignore_errors=True)
    base = runs["none"][0]
    nrec = runs["recorder"][1]
    require(nrec > 0 and runs["recorder_old"][1] == nrec
            and runs["darshan"][1] == nrec,
            f"Fig 10: the tools recorded {runs}")
    rows = []
    for name, (secs, n) in runs.items():
        us = (secs - base) * 1e6 / nrec if name != "none" else 0.0
        rows.append({"tool": name, "seconds": secs,
                     "normalized": secs / base, "us_per_call": us,
                     "n_records": n})
        log(f"Fig 10 [{e.smi}]: {name}: {secs:.4f} s for "
            f"{EVAL_FIG10_ITERS} iterations ({nrec} records traced), "
            f"{secs / base:.3f} x no tool, {us:.3f} us a call")
    return rows


def phase_evaluation(ev, smi: str) -> dict:
    """The paper's size evaluation on the port, on the ``cuda`` encode
    backend (Figs 4-7 and Table 4), then Fig 10's record-path cost."""
    e = Evaluation(ev, smi)
    real = ev.eb.fit_classify
    ev.eb.fit_classify = functools.partial(e.fit_shim, _real=real)
    try:
        out = {"fig45": eval_figs45(e), "fig6": eval_fig6(e),
               "fig7": eval_fig7(e), "table4": eval_table4(e)}
    finally:
        ev.eb.fit_classify = real
        shutil.rmtree(os.path.join(WORK, "eval"), ignore_errors=True)
    out["fig10"] = eval_fig10(e)
    out["launches"] = dict(e.launches)
    out["jobs"], out["tree_jobs"] = e.jobs, e.tree_jobs
    out["cuda_s"], out["busy_ms"] = e.cuda_s, e.busy_ms
    out["max_fit_shape"] = list(e.max_fit)
    require(e.fit_jobs > 0 and e.max_fit[1] == 1024,
            f"evaluation: fit_columns at {e.max_fit} in {e.fit_jobs} jobs; "
            f"Fig 7 must fit 1,024 ranks")
    log(f"evaluation [{smi}]: {e.jobs} flat cuda jobs ({e.cuda_s:.2f} s, "
        f"device busy {e.busy_ms:.3f} ms, idle share "
        f"{1 - e.busy_ms / (e.cuda_s * 1e3):.6f}), "
        f"each with cuda bytes equal to numpy's, {e.tree_jobs} with tree "
        f"sizes equal to flat's; launches {dict(e.launches)} (fit_columns in "
        f"{e.fit_jobs} jobs, largest matrix (groups, ranks) {e.max_fit})")
    return out


def cuda_ms(fn, iters: int = 200, warmup: int = 5,
            budget_s: float = 2.0) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after warm-up: over
    ``iters`` calls, or as many as fit ``budget_s`` by the first call's
    time (at least 3), so that a call of seconds is not timed 200 times."""
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = max(time.perf_counter() - t, 1e-9)
    iters = max(3, min(iters, int(budget_s / one)))
    for _ in range(min(warmup, iters) - 1):
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
        # a window of at most about 1,000 launches of each kernel: the
        # profiler drops some of a larger one (the SSD at Q 1 launches
        # each pass once a chunk group)
        recorded, prof_iters = {}, max(2, min(20, 1000 // self.per_call))
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
    qwen3-32b serve run's prefill shape and largest shape (bf16, causal),
    and for the SSD scan at the mamba2-370m serve prefill's shape (bf16),
    with the launch counts of those runs' main paths (``launches``: arch
    -> counts; every run's count is kept in ``launches_by_run``).  Flash
    attention's row also carries hymba-1.5b's windowed shape
    (``other_shape``), llava-next-34b's (``family_shape``: GQA group 7,
    3,904 keys) and seamless-m4t-large-v2's encoder (``encdec_shape``: D
    64, no causal mask); RMSNorm's deepseek-v2-lite-16b's latent norm at D
    512 (``family_shape``).  The SSD scan's row also carries the prime
    prefill's shape (Q 1, in groups) and the memory checks of the kernels
    phase (``ssd_memory``)."""
    import torch.nn.functional as F

    def top(name):
        require(bool(shapes.get(name)), f"{name} saw no main-path call")
        return max(shapes[name], key=lambda s: int(np.prod(s)))

    def seen(name, shape, arch):
        require(tuple(shape) in shapes.get(name, {}),
                f"{name} saw no call at the {arch} serve shape {shape}")

    qcfg = s.get_config(SERVE_ARCH)
    kv_heads = qcfg.n_kv_heads
    B, S, H, D = SERVE_BATCH, SERVE_SPECS[0].prompt, qcfg.n_heads, qcfg.hd
    seen("flash_attention", (B, S, H, D), SERVE_ARCH)
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
    # flash attention at llava-next-34b's prefill (patches and tokens),
    # RMSNorm at deepseek-v2-lite-16b's latent norm in the prefill
    vlm, mla = "llava-next-34b", "deepseek-v2-lite-16b"
    vcfg, mcfg = s.get_config(vlm), s.get_config(mla)
    vS = next(sp for sp in SERVE_SPECS if sp.arch == vlm).prompt \
        + vcfg.n_patches
    vq = randn((SERVE_BATCH, vS, vcfg.n_heads, vcfg.hd), 31, bf)
    vk = randn((SERVE_BATCH, vS, vcfg.n_kv_heads, vcfg.hd), 32, bf)
    vv = randn((SERVE_BATCH, vS, vcfg.n_kv_heads, vcfg.hd), 33, bf)
    seen("flash_attention", vq.shape, vlm)
    mx = randn((SERVE_BATCH, next(sp for sp in SERVE_SPECS if sp.arch == mla)
                .prompt, mcfg.kv_lora_rank), 34, bf)
    mw = torch.rand(mx.shape[-1], generator=torch.Generator(
        device="cuda").manual_seed(36), device="cuda")
    seen("rmsnorm", mx.shape, mla)
    # flash attention at seamless-m4t-large-v2's encoder: D 64, no causal
    # mask, 16 KV heads of 16
    ed = "seamless-m4t-large-v2"
    espec = next(sp for sp in SERVE_SPECS if sp.arch == ed)
    ecfg = s.get_config(ed)
    eq = randn((SERVE_BATCH, espec.frames, ecfg.n_heads, ecfg.hd), 37, bf)
    ek = randn((SERVE_BATCH, espec.frames, ecfg.n_kv_heads, ecfg.hd), 38, bf)
    ev = randn((SERVE_BATCH, espec.frames, ecfg.n_kv_heads, ecfg.hd), 39, bf)
    seen("flash_attention", eq.shape, ed)
    # name: [(arch, call, key in the row)]
    family = {
        "flash_attention": [(vlm, MeasuredCall(
            [list(vq.shape), list(vk.shape)], (vq, vk, vv), {},
            k.fa.flash_attention, k.fa_ref.flash_attention_ref,
            2 * (2 * vq.numel() + vk.numel() + vv.numel()),
            4 * SERVE_BATCH * vcfg.n_heads * vcfg.hd * attention_pairs(
                vS, True, 0), BF16_TENSOR_OPS_PER_S, 20, 1,
            lambda: F.scaled_dot_product_attention(
                vq.transpose(1, 2), vk.transpose(1, 2), vv.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)),
            "family_shape"), (ed, MeasuredCall(
                [list(eq.shape), list(ek.shape)], (eq, ek, ev),
                {"causal": False}, k.fa.flash_attention,
                k.fa_ref.flash_attention_ref,
                2 * (2 * eq.numel() + ek.numel() + ev.numel()),
                4 * SERVE_BATCH * ecfg.n_heads * ecfg.hd * attention_pairs(
                    espec.frames, False, 0), BF16_TENSOR_OPS_PER_S, 20, 1,
                lambda: F.scaled_dot_product_attention(
                    eq.transpose(1, 2), ek.transpose(1, 2),
                    ev.transpose(1, 2)).transpose(1, 2)), "encdec_shape")],
        "rmsnorm": [(mla, MeasuredCall(
            [list(mx.shape)], (mx, mw), {"eps": mcfg.norm_eps}, k.rn.rmsnorm,
            k.rn_ref.rmsnorm_ref, 2 * 2 * mx.numel() + 4 * mw.numel(),
            4 * mx.numel(), CORE_OPS_PER_S, 200, 1,
            lambda: F.rms_norm(mx, (mx.shape[-1],), mw.to(bf),
                               mcfg.norm_eps)), "family_shape")]}
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
        for arch, call, key in family.get(name, ()):
            row[key] = {
                "arch": arch, "launches": launches[arch].get(name, 0),
                **call.measure(kname, f"{name} at the {arch} serve shape")}
            log(f"{name} at the {arch} serve shape bf16: {row[key]}")
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
    from repro_torch.core import faults
    from repro_torch.core import interprocess
    from repro_torch.core.comm import (WorldError, run_process_world,
                                       run_thread_world)
    from repro_torch.core.patterns import IntraPatternTracker
    from repro_torch.core import trace_format
    from repro_torch.core.reader import TraceReader
    from repro_torch.core.sequitur import Sequitur, expand_grammar
    from repro_torch.core.specs import REGISTRY
    from repro_torch.kernels import _build, _grad
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
    from repro_torch.models import layers as model_layers
    from repro_torch.models.convert import flat_params
    from repro_torch.models.lm import prompt_len
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import _seat
    from repro_torch.models import encdec
    from repro_torch.launch.steps import cast_params, make_train_step
    from repro_torch.launch.train import build_data
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.models.convert import tree_map
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.loop import state_nbytes
    from repro_torch import workloads
    from repro_torch.core import baselines
    from repro_torch.configs import all_arch_names
    from repro_torch.distributed.sharding import map_leaves
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.shapes import SHAPES, ShapeSpec, applicable
    from repro_torch.launch.steps import build_cell, build_cell_batch

    k = SimpleNamespace(de=de_ops, de_ref=de_ref, gs=gs_ops, gs_ref=gs_ref,
                        fa=fa_ops, fa_ref=fa_ref, rn=rn_ops, rn_ref=rn_ref,
                        ssd=ssd_ops, ssd_ref=ssd_ref, grad=_grad)
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
                        QUERY_FAMILIES=QUERY_FAMILIES, faults=faults,
                        ip=interprocess, WorldError=WorldError)
    srv = SimpleNamespace(get_config=get_config,
                          get_smoke_config=get_smoke_config,
                          get_model=get_model, ServeEngine=ServeEngine,
                          flat_params=flat_params, build=_build,
                          session=recorder.session,
                          RecorderConfig=recorder.RecorderConfig,
                          TraceReader=TraceReader, Trainer=Trainer,
                          TrainerConfig=TrainerConfig,
                          AdamWConfig=AdamWConfig, adamw_init=adamw_init,
                          make_train_step=make_train_step,
                          cast_params=cast_params, tree_map=tree_map,
                          state_nbytes=state_nbytes, k=k,
                          prompt_len=prompt_len, seat=_seat, encdec=encdec,
                          build_data=build_data,
                          routes=RouteLog(model_layers.top_k),
                          build_cell=build_cell,
                          build_cell_batch=build_cell_batch,
                          ShapeSpec=ShapeSpec, SHAPES=SHAPES,
                          applicable=applicable, map_leaves=map_leaves,
                          make_debug_mesh=make_debug_mesh, dryrun=dryrun,
                          roofline=roofline,
                          all_arch_names=all_arch_names)
    ev = SimpleNamespace(wl=workloads, bl=baselines, eb=eb, recorder=recorder,
                         build=_build, Recorder=recorder.Recorder,
                         RecorderConfig=recorder.RecorderConfig)
    # f32 products in full f32 (PyTorch's default, stated): the f32 checks
    # against plain versions assume it
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    srv.smi = smi
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    require(eb.default_backend() == "cuda", "cuda must be the default")
    shutil.rmtree(WORK, ignore_errors=True)
    t_all = time.monotonic()

    with Phase("build"):
        build_s = phase_build(_build)
    dry_job = start_dryrun(srv)
    serve_calls = serve_kernel_calls(srv)
    with Phase("kernels"):
        ssd_memory = phase_kernels(k, serve_calls)

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
        # the launches of this thread, counted where the kernel launches:
        # ranks (and their pool threads) flush at once in the durability
        # phase
        before = _build.thread_launch_counts().get("delta_zigzag", 0)
        blocks = _real(ticks, block_records, backend=backend)
        after = _build.thread_launch_counts().get("delta_zigzag", 0)
        if len(ticks) and eb.resolve(backend, len(ticks)) == "cuda":
            with lock:
                flushes.append((len(ticks), block_records, len(blocks),
                                after - before))
        return blocks
    for mod, name, fn in ((eb, "pack_uvarints_batch", pack_shim),
                          (eb, "run_starts", starts_shim),
                          (eb, "digram_histogram", digram_shim),
                          (streaming, "compress_timestamps_blocked",
                           flush_shim), (model_layers, "top_k", srv.routes)):
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
        with Phase("durability"):
            durability = phase_durability(p, flushes)
        with Phase("finalize_scaling"):
            scaling = phase_finalize_scaling(p, ev, shapes)
        serves = {}
        with Phase("serve"):
            serves[SERVE_ARCH] = phase_serve(srv, SERVE_SPECS[0])
        with Phase("serve_ssm"):
            for spec in SERVE_SPECS[1:3]:
                serves[spec.arch] = phase_serve(srv, spec)
            prime = prime_prefill(srv, SERVE_SPECS[1])
        with Phase("serve_moe_mla_vlm"):
            for spec in SERVE_SPECS[3:6]:
                serves[spec.arch] = phase_serve(srv, spec)
        with Phase("serve_encdec"):
            for spec in SERVE_SPECS[6:]:
                serves[spec.arch] = phase_serve(srv, spec)
        with Phase("train"):
            train = phase_train(srv)
        with Phase("evaluation"):
            evaluation = phase_evaluation(ev, smi)
        with Phase("sharded"):
            dispatch = operator_dispatch()
            sharded = phase_sharded(srv)
    finally:
        for mod, name, real in originals:
            setattr(mod, name, real)
    serve_counts = {a: r["launches"] for a, r in serves.items()}
    serve_counts[f"{prime['arch']}@{PRIME_PROMPT}"] = prime["launches"]
    serve_counts[f"train {train['arch']}"] = train["launches"]
    for run in ("dense", "moe", "encdec"):
        serve_counts[f"train {train[run]['arch']}"] = train[run]["launches"]
    for arch, r in sharded.items():
        name = arch if arch != "train" else f"train {r['arch']}"
        serve_counts[f"sharded {name}"] = r["launches"]["sharded"]
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
    for name, calls in serve_calls.items():
        for call in calls:
            require(call[0] in shapes[name],
                    f"{name}: the kernels phase checked {call[0]}, which "
                    f"no serve run gave it")
    with Phase("dryrun"):
        dry = phase_dryrun(srv, dry_job)
    with Phase("examples"):
        examples = phase_examples(srv)
    log("serve summary: " + json.dumps(
        {a: {k: v for k, v in r.items() if k != "top_kernels"}
         for a, r in serves.items()}))
    log("prime prefill summary: " + json.dumps(prime))
    log("multiproc summary: " + json.dumps(multiproc))
    log("durability summary: " + json.dumps(durability))
    log("finalize_scaling summary: " + json.dumps(scaling))
    log("evaluation summary: " + json.dumps(evaluation))
    log("examples summary: " + json.dumps(examples))
    log("sharded summary: " + json.dumps(sharded))
    log("operator dispatch: " + json.dumps(dispatch))
    log("dryrun summary (fake 256/512-rank mesh): " + json.dumps(dry))

    with Phase("report"):
        rows = kernel_report(k, p, shapes, launches, read_inputs,
                             run_inputs[0])
        rows += model_kernel_report(k, srv, shapes, serve_counts, ssd_memory)
    for row in rows:
        row["evaluation_launches"] = evaluation["launches"].get(row["name"],
                                                                0)
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
