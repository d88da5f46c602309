"""Rank bodies of ``tests/test_torch_sharded_steps.py``: a 2 x 2 gloo world
(``("data", "model")``) that runs the port's sharded steps, built by
``launch.steps.build_cell`` from full parameters, on the cases the test
process wrote, and writes rank 0's results back.

Each case carries the JAX package's smoke parameters (numpy, its stacked
layout), a train batch, its micro-batch count and, but for the
accumulation cases, a prompt batch.  A rank converts them
(``params_from_numpy``), runs one sharded train step, a sharded prefill,
seats the gathered prefill caches into a ``MAX_SEQ`` cache and runs
``STEPS`` sharded decode steps on it, and, last, ``compressed_psum_tree``
over the world on a tree that depends on its rank.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import is_dtensor, map_leaves
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import build_cell
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig
from repro_torch.optim.compress import compressed_psum_tree
from repro_torch.serve.engine import _seat

MAX_SEQ, STEPS = 64, 8
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=4)


def full(t):
    """The whole tensor of a DTensor (a collective: every rank calls it)."""
    return t.full_tensor() if is_dtensor(t) else t


def compress_input(rank: int):
    """The tree rank ``rank`` feeds ``compressed_psum_tree``."""
    rs = np.random.RandomState(10 + rank)
    return {"w": rs.randn(6, 3).astype(np.float32) * 1e-3 * (rank + 1),
            "b": rs.randn(5).astype(np.float32)}, \
        {"w": rs.randn(6, 3).astype(np.float32) * 1e-6,
         "b": np.zeros(5, np.float32)}


class DispatchLog:
    """Stands in for ``models.layers._dispatch_combine``: counts the
    expert-parallel calls."""

    def __init__(self):
        self.inner = L._dispatch_combine
        self.ep_calls = 0

    def __call__(self, p, cfg, x_flat, ep=1, group=None):
        if group is not None and ep > 1:
            self.ep_calls += 1
        return self.inner(p, cfg, x_flat, ep, group)


def run_case(case: dict, mesh) -> dict:
    cfg = get_smoke_config(case["arch"]).replace(**case["replace"])
    params = params_from_numpy(cfg, case["tree"], "cpu")
    out = {}

    tb = {k: torch.as_tensor(v) for k, v in case["train_batch"].items()}
    B, S = tb["tokens"].shape
    step, args, meta = build_cell(
        cfg, ShapeSpec("t", S, B, "train"), mesh, case["accum"],
        ocfg=AdamWConfig(**OCFG), params=params, inputs={"batch": tb})
    log = DispatchLog()
    L._dispatch_combine = log
    try:
        new_state, metrics = step(*args)
    finally:
        L._dispatch_combine = log.inner
    out["ep_calls"] = log.ep_calls
    out["loss"] = float(full(metrics["loss"]))
    out["nll"] = float(full(metrics["nll"]))
    out["aux"] = float(full(metrics["aux"]))
    out["grad_norm"] = float(full(metrics["grad_norm"]))
    master = map_leaves(lambda _, t: full(t), new_state["master"])
    out["master"] = params_to_numpy(master)
    if "prompt_batch" not in case:
        return out

    pb = {k: torch.as_tensor(v) for k, v in case["prompt_batch"].items()}
    B, S = pb["tokens"].shape
    step, args, _ = build_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh,
                               params=params, inputs={"batch": pb})
    logits, pf_cache = step(*args)
    out["pf_logits"] = full(logits).numpy()
    pf_cache = map_leaves(lambda _, t: full(t), pf_cache)

    model = get_model(cfg, "cpu")
    cache = _seat(model.init_cache(B, MAX_SEQ), pf_cache)
    nxt = torch.argmax(full(logits)[:, :cfg.vocab_size], dim=-1
                       ).to(torch.int32)[:, None]
    step, args, _ = build_cell(cfg, ShapeSpec("d", MAX_SEQ, B, "decode"),
                               mesh, params=params,
                               inputs={"cache": cache, "tokens": nxt})
    p_args, cache_d, tok = args
    toks = []
    for _ in range(STEPS):
        tok, cache_d = step(p_args, cache_d, tok)
        toks.append(full(tok).numpy())
    out["steps"] = np.concatenate(toks, axis=1)
    return out


def sharded_rank(rank: int, world: int, init_file: str, cases_path: str,
                 out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        with open(cases_path, "rb") as f:
            cases = pickle.load(f)
        results = {c["key"]: run_case(c, mesh) for c in cases}
        g, e = compress_input(rank)
        tg = {k: torch.as_tensor(v) for k, v in g.items()}
        te = {k: torch.as_tensor(v) for k, v in e.items()}
        avg, new_err = compressed_psum_tree(tg, te, dist.group.WORLD)
        results["__compress__"] = {
            "avg": {k: v.numpy() for k, v in avg.items()},
            "err": {k: v.numpy() for k, v in new_err.items()}}
        if rank == 0:
            with open(out_path + ".tmp", "wb") as f:
                pickle.dump(results, f)
            os.replace(out_path + ".tmp", out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()
