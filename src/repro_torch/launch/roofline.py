"""Roofline report of the port (the JAX package's ``launch/roofline.py``).

Every stacked layer of a cell is the same step on the same shapes, so a
cell is measured at two stacked depths (1 and 2, ``dryrun.DEPTHS``)
through the function the dry run measures with (``dryrun.depth_runs``:
the sharded step under ``FakeTensorMode`` on the fake 256-rank group of
the single-pod mesh, counted by ``step_analysis.StepCounter``), and its
costs are extrapolated to the full depth with the reference's clamp:

    total = cost(1) + (n_stacked - 1) * max(cost(2) - cost(1), 0)

Terms a chip (``step_analysis.roofline_terms``), with the published
figures of one H100 SXM:

    t_compute    = FLOPs / 989e12         (dense bf16 tensor cores)
    t_memory     = analytic bytes / 3.35e12   (HBM3)
    t_collective = bytes within a node / 450e9 (NVLink, a direction)
                 + bytes across nodes / 50e9   (one 400 Gb/s NIC a GPU)

plus ``model_flops_per_chip`` (6 N D train, 2 N D inference, N the
active parameters), the useful-FLOP ratio and the dominant term.  The
memory term is the reference's napkin traffic model
(``analytic_bytes_per_chip``); ``t_memory_op_s`` beside it divides the
bytes every counted op reads and writes on the local shards
(``StepCounter.bytes_accessed``), which with no fusion is an upper
bound, as the reference's CPU-backend "bytes accessed" is.

The reference's ``_shrink`` has no counterpart here: it unrolls scans and
widens chunks only so that XLA compiles small programs whose cost
analysis counts every layer.  ``dryrun.at_depth`` builds 1 and 2 stacked
layers directly, and the counted FLOPs do not depend on the blocking.

    PYTHONPATH=src python -m repro_torch.launch.roofline     # every cell
    PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen3-32b \\
        --shape train_4k                                    # one, as JSON
    PYTHONPATH=src python -m repro_torch.launch.roofline --arch \\
        mamba2-370m --device cpu --smoke                    # a CPU host
    PYTHONPATH=src python -m repro_torch.launch.roofline --report

Cells land in ``artifacts/roofline_torch/<arch>__<shape>.json``;
``--report`` prints their markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import torch

from ..configs import all_arch_names, get_config, get_smoke_config
from ..models.config import ModelConfig
from . import dryrun, step_analysis
from .mesh import make_production_mesh, production_shape
from .shapes import SHAPES, ShapeSpec, applicable

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "roofline_torch")

BYTES_NOTE = ("bytes: the tensor inputs and outputs of every op on the "
              "local shards, views left out, with no fusion -- an upper "
              "bound of the HBM traffic")

HINTS = {
    "compute": "raise tensor-core utilisation (wgmma tiles, fusion)",
    "memory": "cut HBM traffic (fusion, bf16 end-to-end, remat policy)",
    "collective": "overlap/shrink collectives on NVLink and the network "
                  "(sharding, bf16 reduce)",
}


def _cell_costs(run: Dict[str, Any]) -> Dict[str, float]:
    """A depth's costs a chip: FLOPs, bytes accessed, collective bytes
    (and the part of them whose group spans nodes)."""
    coll = run["collectives"]
    return {"flops": float(run["flops"]),
            "bytes": float(run["bytes_accessed"]),
            "coll": float(coll["total_bytes"]),
            "coll_cross_node": float(coll["cross_node_bytes"])}


def extrapolate(c1: Dict[str, float], c2: Dict[str, float],
                n_stacked: int) -> Dict[str, float]:
    """The reference's extrapolation from 1 and 2 stacked layers to
    ``n_stacked``, each per-layer delta clamped at 0."""
    return {k: c1[k] + (n_stacked - 1) * max(c2[k] - c1[k], 0.0)
            for k in c1}


def analytic_bytes_per_chip(cfg: ModelConfig, shape, n_chips: int,
                            tp: int = 16) -> float:
    """Napkin HBM-traffic model a chip a step, the reference's term for
    term:

      train:   3x weight reads (fwd + 2 bwd passes) at bf16/tp
               + optimizer state read+write (3 trees f32, ZeRO over chips)
               + grads write+read at bf16/tp
               + activations: ~36 x d bytes/token/layer (fwd tensors x
                 remat recompute factor 1.5, bf16)
      prefill: 1x weight read + ~24 x d bytes/token/layer activations
      decode:  1x weight read + full KV/state cache read + O(1) acts
    """
    N = cfg.param_counts()["total"]
    L = cfg.n_layers + cfg.n_encoder_layers
    d = cfg.d_model
    toks_chip = shape.global_batch * shape.seq_len / n_chips
    w = 2.0 * N / tp
    if shape.kind == "train":
        opt = 24.0 * N / n_chips * 2          # read + write f32 trees
        grads = 2.0 * 2.0 * N / tp
        acts = 36.0 * d * toks_chip * L * 2.0
        return 3 * w + opt + grads + acts
    if shape.kind == "prefill":
        return w + 24.0 * d * toks_chip * L * 2.0
    # decode: weights + cache
    if cfg.family == "ssm":
        cache = (cfg.n_layers * shape.global_batch * cfg.ssm_heads
                 * cfg.ssm_state * cfg.ssm_head_dim * 4.0) / n_chips
    elif cfg.mla:
        cache = (cfg.n_layers * shape.global_batch * shape.seq_len
                 * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0) / n_chips
    else:
        W = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window \
            else shape.seq_len
        cache = (2.0 * cfg.n_layers * shape.global_batch * W
                 * cfg.n_kv_heads * cfg.hd * 2.0) / n_chips
        if cfg.hybrid:
            cache += (cfg.n_layers * shape.global_batch * cfg.ssm_heads
                      * cfg.ssm_state * cfg.ssm_head_dim * 4.0) / n_chips
        if cfg.n_encoder_layers:  # cross-attention K/V
            cache += (2.0 * cfg.n_layers * shape.global_batch
                      * shape.seq_len * cfg.n_heads * cfg.hd * 2.0) / n_chips
    return w + cache


def analyze_cell(arch: str, shape_name: str, accum: Optional[int] = None,
                 *, device: str = "cuda", smoke: bool = False,
                 cfg: Optional[ModelConfig] = None,
                 shape: Optional[ShapeSpec] = None) -> Dict[str, Any]:
    """One cell on the single-pod mesh: its per-layer delta, the costs at
    one stacked layer, the extrapolated costs and the roofline terms, or
    a ``skip`` with the reason.  ``cfg`` and ``shape`` replace the cell's
    configuration and shape (tests); ``smoke`` takes the reduced
    same-family configuration."""
    cfg = cfg or (get_smoke_config(arch) if smoke else get_config(arch))
    shape = shape or SHAPES[shape_name]
    ok, reason = applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": reason}
    dims, names = production_shape(False)
    n_chips = dims[0] * dims[1]
    dryrun.fake_world(n_chips)
    mesh = make_production_mesh(device_type=device)
    if accum is None:
        accum = dryrun.accum_steps(cfg, shape)
    n_stacked = dryrun.stacked_depth(cfg)
    meta, runs = dryrun.depth_runs(cfg, shape, mesh, n_chips, dryrun.DEPTHS,
                                   accum)
    c1, c2 = (_cell_costs(r) for r in runs)
    full = extrapolate(c1, c2, n_stacked)
    mf = dryrun.model_flops_per_chip(cfg, shape, n_chips)
    ab = analytic_bytes_per_chip(cfg, shape, n_chips,
                                 tp=dims[names.index("model")])
    terms = step_analysis.roofline_terms(
        full["flops"], dryrun.hbm_bytes(meta, shape.kind),
        {"total_bytes": full["coll"],
         "cross_node_bytes": full["coll_cross_node"]},
        mf, analytic_bytes_per_chip=ab, op_bytes=full["bytes"])
    return {"arch": arch, "shape": shape_name, "status": "ok",
            "mesh": dict(zip(names, dims)), "device": device,
            "accum_steps": accum, "stacked_depth": n_stacked,
            "per_layer_delta": {k: c2[k] - c1[k] for k in c1},
            "base_costs": c1, "extrapolated": full, "roofline": terms,
            "bytes_note": BYTES_NOTE}


def save(r: Dict[str, Any], art: Optional[str] = None) -> str:
    """Write one cell's JSON under ``art`` (``ART`` by default); returns
    its path."""
    art = art or ART
    os.makedirs(art, exist_ok=True)
    fn = os.path.join(art, f"{r['arch']}__{r['shape']}.json")
    with open(fn, "w") as f:
        json.dump(r, f, indent=1, default=str)
    return fn


def format_line(r: Dict[str, Any]) -> str:
    """The reference's line for a cell."""
    if r["status"] != "ok":
        return f"{r['arch']:24s} {r['shape']:12s} SKIP"
    t = r["roofline"]
    return (f"{r['arch']:24s} {r['shape']:12s} "
            f"comp={t['t_compute_s']*1e3:9.3f}ms "
            f"mem={t['t_memory_s']*1e3:9.3f}ms "
            f"coll={t['t_collective_s']*1e3:9.3f}ms "
            f"dom={t['bottleneck']:10s} "
            f"useful={t.get('useful_flop_ratio', 0):.2f} "
            f"frac={t.get('roofline_fraction', 0):.3f}")


def run_one(cell) -> Dict[str, Any]:
    """``analyze_cell`` of an (arch, shape, device) tuple: the worker
    function of ``dryrun.run_cells``."""
    arch, shape_name, device = cell
    return analyze_cell(arch, shape_name, device=device)


def run_all(device: str = "cuda", smoke: bool = False,
            art: Optional[str] = None) -> None:
    """Every (architecture x shape) cell: its JSON under ``art`` and its
    line on stdout."""
    for arch in all_arch_names():
        for shape_name in SHAPES:
            r = analyze_cell(arch, shape_name, device=device, smoke=smoke)
            save(r, art)
            print(format_line(r), flush=True)


def report(art: Optional[str] = None) -> str:
    """Markdown table of the cells saved under ``art`` (``ART`` by
    default)."""
    art = art or ART
    rows = []
    for arch in all_arch_names():
        for shape_name in SHAPES:
            fn = os.path.join(art, f"{arch}__{shape_name}.json")
            if not os.path.exists(fn):
                continue
            with open(fn) as f:
                r = json.load(f)
            if r["status"] != "ok":
                rows.append(f"| {arch} | {shape_name} | — | — | — | skip |"
                            f" — | — | {r['reason'][:60]} |")
                continue
            t = r["roofline"]
            rows.append(
                f"| {arch} | {shape_name} "
                f"| {t['t_compute_s']*1e3:.2f} | {t['t_memory_s']*1e3:.2f} "
                f"| {t['t_collective_s']*1e3:.2f} | {t['bottleneck']} "
                f"| {t.get('useful_flop_ratio', 0):.2f} "
                f"| {t.get('roofline_fraction', 0):.3f} "
                f"| {HINTS[t['bottleneck']]} |")
    head = ("| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) "
            "| bottleneck | useful FLOP ratio | roofline frac | next lever |\n"
            "|---|---|---|---|---|---|---|---|---|")
    return head + "\n" + "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.roofline")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device type of the fake mesh (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family configurations")
    args = ap.parse_args(argv)
    if args.report:
        print(report())
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the "
                         "roofline on this host")
    if args.arch:
        r = analyze_cell(args.arch, args.shape or "train_4k",
                         device=args.device, smoke=args.smoke)
        print(json.dumps(r, indent=1, default=str))
        return 0
    run_all(args.device, args.smoke)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
