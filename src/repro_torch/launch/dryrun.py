"""Multi-pod dry run of the port (the JAX package's ``launch/dryrun.py``).

For every (architecture x input shape) cell, build the sharded step on a
production mesh (256 or 512 ranks, ``launch/mesh.py``) and run it once
under ``FakeTensorMode`` on a fake process group -- every rank's shard has
its real shape and no storage, every collective its real size and no
data -- recording per-chip memory, FLOPs, collectives and H100 roofline
terms (``launch/step_analysis.py``).  The layers of a stack are the same
step on the same shapes, so a cell runs at 1 and 2 stacked layers and
its FLOPs, collective bytes and peak estimate are extrapolated along that
line to the full depth (``--full-depth`` runs every layer); its argument
bytes come from the full-depth build:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape train_4k --mesh single             # one cell, on the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m \\
        --smoke --device cpu                        # a CPU host

The process is rank 0 of the fake group, so it needs one device of the
type asked (``cuda`` by default; ``--device cpu`` on a host without a
card).  Fake tensors are never allocated and no kernel launches: the
kernels' operators run their fake (shape) versions.  The kernels run, and
the numbers of a real sharded step are measured, by ``chip_smoke.py``'s
``sharded`` phase.  Artifacts land in
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import all_arch_names, get_config, get_smoke_config
from ..models.config import ModelConfig
from . import step_analysis
from .mesh import make_production_mesh, production_shape
from .shapes import SHAPES, ShapeSpec, applicable
from .steps import build_cell

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")


def model_flops_per_chip(cfg: ModelConfig, shape, n_chips: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N per token (decode),
    with N = active params (MoE uses activated experts only)."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks / n_chips
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks / n_chips
    toks = shape.global_batch  # one token per sequence
    return 2.0 * n_active * toks / n_chips


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a fake process group of
    ``world_size`` ranks (``torch.testing``'s ``fake`` backend: collectives
    return at once and move nothing), replacing any group it had."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def accum_steps(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Memory policy: wide models microbatch the 1M-token train step."""
    return 4 if (shape.kind == "train" and cfg.d_model >= 5120) else 1


def hbm_bytes(meta: Dict[str, Any], kind: str) -> float:
    """Bytes a step must move through HBM at least: its arguments read
    once, and a train step's state written back."""
    if kind == "train":
        return 2.0 * meta["state_bytes"] + meta["batch_bytes"]
    return float(meta["arg_bytes"])


def stacked_depth(cfg: ModelConfig) -> int:
    """The number of identical stacked layers (an encoder-decoder's
    encoder and decoder layers count together: they have as many)."""
    if cfg.n_encoder_layers:
        return cfg.n_layers
    return cfg.n_layers - (cfg.first_k_dense if cfg.is_moe else 0)


def at_depth(cfg: ModelConfig, d: int) -> ModelConfig:
    """``cfg`` with ``d`` stacked layers (the first dense layers kept)."""
    if cfg.n_encoder_layers:
        return cfg.replace(n_layers=d, n_encoder_layers=d)
    return cfg.replace(n_layers=cfg.n_layers - stacked_depth(cfg) + d)


#: the stacked depths the dry run runs; the full depth is extrapolated
DEPTHS = (1, 2)


def _extrapolate(a: float, b: float, depth: int) -> float:
    """The line through (DEPTHS[0], a) and (DEPTHS[1], b) at ``depth``."""
    d0, d1 = DEPTHS
    return a + (b - a) * (depth - d0) / (d1 - d0)


def layout_departures(cfg: ModelConfig, shape: ShapeSpec, mesh
                      ) -> Dict[str, str]:
    """The gathers of the port's own layout that a cell's numbers include
    and the reference's sharding does not make (or leaves to XLA), by
    name: read such a cell's FLOPs, collectives and peak as the cost of
    the port's layout, not of the reference's."""
    names = mesh.mesh_dim_names
    tp = mesh.size(names.index("model")) if "model" in names else 1
    out: Dict[str, str] = {}
    full_seq = shape.kind in ("train", "prefill")
    if full_seq and tp > 1 and cfg.n_heads and cfg.n_heads % tp:
        out["attention_gathers_sequence"] = (
            f"{cfg.n_heads} heads do not divide the {tp} model ranks: every "
            "model rank gathers the sequence and computes its batch "
            "shard's whole attention (the reference shards the sequence; "
            "the flash kernel has no query offset)")
    if cfg.is_moe and tp > 1 and not (shape.seq_len % tp == 0 and full_seq
                                       and cfg.n_routed_experts % tp == 0):
        out["moe_gathers_tokens"] = (
            "no expert parallelism: every rank routes all tokens, gathered "
            "over the data axes, and runs its share of the experts on "
            "them (the reference leaves this dispatch to XLA)")
    return out


def depth_runs(cfg: ModelConfig, shape: ShapeSpec, mesh, n_chips: int,
               depths, accum: int) -> Tuple[Dict[str, Any], list]:
    """Under ``FakeTensorMode``: build the cell at full depth (its
    ``build_cell`` meta: the per-chip argument, state and batch bytes) and
    run it at each stacked depth of ``depths`` inside a ``StepCounter``
    (``step_analysis.analyze``).  The dry run and the roofline report
    both measure a cell through this function."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mf = model_flops_per_chip(cfg, shape, n_chips)
    with FakeTensorMode():
        _, _, meta = build_cell(cfg, shape, mesh, accum_steps=accum)
        runs = []
        for d in depths:
            step, args, m = build_cell(at_depth(cfg, d), shape, mesh,
                                       accum_steps=accum)
            runs.append(step_analysis.analyze(step, args, m, mf,
                                              hbm_bytes(m, shape.kind)))
    return meta, runs


def analyze_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, n_chips: int,
                 full_depth: bool = False) -> Dict[str, Any]:
    """Build the cell at full depth (its arguments and their per-chip
    bytes) and run it: at full depth when ``full_depth``, else at the
    stacked depths ``DEPTHS``, with FLOPs, bytes accessed, collective
    bytes and the peak estimate extrapolated along the line the two give
    (every stacked layer is the same step on the same shapes, so FLOPs
    and collectives grow by the same amount a layer; the peak is an
    estimate)."""
    accum = accum_steps(cfg, shape)
    mf = model_flops_per_chip(cfg, shape, n_chips)
    depth = stacked_depth(cfg)
    meta, runs = depth_runs(cfg, shape, mesh, n_chips,
                            (depth,) if full_depth else DEPTHS, accum)
    if full_depth:
        an = runs[0]
    else:
        a, b = runs
        an = {"flops": _extrapolate(a["flops"], b["flops"], depth),
              "bytes_accessed": _extrapolate(a["bytes_accessed"],
                                             b["bytes_accessed"], depth),
              "memory": {"peak_bytes_estimate": _extrapolate(
                  a["memory"]["peak_bytes_estimate"],
                  b["memory"]["peak_bytes_estimate"], depth)},
              "collectives": {}}
        for k, v in a["collectives"].items():
            w = b["collectives"][k]
            an["collectives"][k] = (
                {f: _extrapolate(v[f], w[f], depth) for f in v}
                if isinstance(v, dict) else _extrapolate(v, w, depth))
    an["memory"]["argument_bytes"] = int(meta["arg_bytes"])
    an["roofline"] = step_analysis.roofline_terms(
        an["flops"], hbm_bytes(meta, shape.kind), an["collectives"], mf,
        op_bytes=an["bytes_accessed"])
    an.update(accum_steps=accum, model_flops_per_chip=mf,
              depths=[depth] if full_depth else list(DEPTHS),
              stacked_depth=depth)
    return an


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             device: str = "cuda", smoke: bool = False,
             shape: Optional[ShapeSpec] = None, full_depth: bool = False,
             save: bool = True, cfg: Optional[ModelConfig] = None
             ) -> Dict[str, Any]:
    """One cell: ``ok`` with its analysis, ``skip`` with the reason, or
    ``fail`` with the error (a failing cell is a bug report).  ``shape``
    and ``cfg`` replace the cell's shape and configuration (tests)."""
    cfg = cfg or (get_smoke_config(arch) if smoke else get_config(arch))
    shape = shape or SHAPES[shape_name]
    ok, reason = applicable(cfg, shape_name)
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_kind, "device": device}
    if not ok:
        result["status"] = "skip"
        result["reason"] = reason
        return result
    dims, _ = production_shape(mesh_kind == "multi")
    n_chips = 1
    for d in dims:
        n_chips *= d
    t0 = time.time()
    try:
        fake_world(n_chips)
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device_type=device)
        an = analyze_cell(cfg, shape, mesh, n_chips, full_depth)
        result.update({
            "status": "ok", "n_chips": n_chips,
            "run_s": round(time.time() - t0, 1),
            "accum_steps": an["accum_steps"], "depths": an["depths"],
            "stacked_depth": an["stacked_depth"],
            "memory": an["memory"], "collectives": an["collectives"],
            "flops_per_chip": an["flops"],
            "model_flops_per_chip": an["model_flops_per_chip"],
            "roofline": an["roofline"],
            "fits_80gb": an["memory"]["peak_bytes_estimate"] <= 80e9,
            "departures": layout_departures(cfg, shape, mesh),
        })
    except Exception as e:  # deliberate: a failing cell is a bug report
        result["status"] = "fail"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-3000:]
    if save:
        os.makedirs(ARTIFACTS, exist_ok=True)
        fn = os.path.join(ARTIFACTS,
                          f"{arch}__{shape_name}__{mesh_kind}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1, default=str)
    return result


def format_result(r: Dict[str, Any]) -> str:
    """The reference's OK / SKIP / FAIL line (and, for OK, a second line
    of per-chip numbers)."""
    head = f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:6s}"
    if r["status"] == "skip":
        return f"SKIP {head} {r['reason']}"
    if r["status"] != "ok":
        return f"FAIL {head} {r['error']}"
    rt, mem, coll = r["roofline"], r["memory"], r["collectives"]
    by_kind = " ".join(f"{k}={coll[k]['bytes'] / 2**30:.3f}GiB"
                       for k in step_analysis.KINDS)
    departs = "".join(f" [port layout: {k}]" for k in r["departures"])
    return (f"OK   {head} run={r['run_s']:7.1f}s "
            f"bottleneck={rt['bottleneck']:10s} "
            f"frac={rt.get('roofline_fraction', 0):.3f}{departs}\n"
            f"     per chip (fake {r['n_chips']}-rank mesh): "
            f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
            f"peak_est={mem['peak_bytes_estimate'] / 2**30:.2f}GiB "
            f"fits_80GB={r['fits_80gb']} "
            f"flops={r['flops_per_chip']:.4g} "
            f"model_flops={r['model_flops_per_chip']:.4g}\n"
            f"     coll {by_kind} cross_node="
            f"{coll['cross_node_bytes'] / 2**30:.3f}GiB  "
            f"t_compute={rt['t_compute_s']:.4g}s "
            f"t_memory={rt['t_memory_s']:.4g}s "
            f"t_collective={rt['t_collective_s']:.4g}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device type of the fake mesh (default cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family configurations")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--full-depth", action="store_true",
                    help="run every layer instead of extrapolating from "
                         "runs at 1 and 2 stacked layers")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run the dry "
                         "run on this host")

    archs = all_arch_names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, sh, mk, args.device, args.smoke, args.full_depth)
             for a in archs for sh in shapes for mk in meshes]

    failures = 0
    for r in run_cells(cells, args.jobs):
        failures += r["status"] == "fail"
        print(format_result(r), flush=True)
    return 1 if failures else 0


def _run_one(cell) -> Dict[str, Any]:
    arch, shape, mesh, device, smoke, full_depth = cell
    return run_cell(arch, shape, mesh, device=device, smoke=smoke,
                    full_depth=full_depth)


def run_cells(cells, jobs: int = 1, fn=_run_one):
    """``fn`` over ``cells``, in order (by default ``run_cell`` over
    (arch, shape, mesh, device, smoke, full_depth) tuples); with ``jobs``
    > 1 in that many worker processes, each rank 0 of a fake group of its
    own (``fn`` must then be a module-level function)."""
    if jobs <= 1:
        for c in cells:
            yield fn(c)
        return
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(jobs) as pool:
        yield from pool.imap(fn, cells)


if __name__ == "__main__":
    raise SystemExit(main())
