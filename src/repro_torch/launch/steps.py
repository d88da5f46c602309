"""Step builders + sharding specs for train / prefill / decode (the JAX
package's ``launch/steps.py``).

The sharding contract of the port: every sharded entry point gets DTensor
inputs whose placements are derived here.  Conventions:

  params        TP-sharded over "model" (distributed.param_sharding_rules)
  opt state     ZeRO-1: params' spec + the largest divisible free dim
                sharded over "data" (zero1_spec)
  activations   batch over ("pod","data"); constraints inside the model
  kv caches     batch over ("pod","data"), heads or sequence over "model"

Trees are the port's (per-layer lists); every spec here is per layer, the
JAX package's stacked spec through ``distributed.sharding.unstack_spec``.
One departure on purpose: ZeRO-1 applies the reference's rule ("the
largest free dim divisible by the data extent") to a per-layer leaf's own
dims, so where the reference puts "data" on the stacked layer dim (a few
small leaves of mamba2-370m and hymba-1.5b) the port shards a dim of the
layer or none (``ROADMAP.md`` lists them).

Without a mesh every builder is the single-device step it was; with one,
the same model code runs on DTensors (``build_cell`` makes them: over
fake storage under a fake process group for the dry run, or over real
tensors).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import spans
from ..distributed.sharding import (P, is_dtensor, map_leaves, mesh_context,
                                    mesh_shape, to_placements,
                                    tree_param_specs)
from ..models import get_model
from ..models.config import ModelConfig
from ..models.convert import flat_params, reference_ndim, tree_map
from ..models.layers import torch_dtype
from ..optim import AdamWConfig, adamw_init, adamw_update
from .shapes import ShapeSpec, batch_specs, decode_specs


# ---------------------------------------------------------------------------
# spec derivation
# ---------------------------------------------------------------------------


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _dp_axes(mesh, n: int) -> Optional[Tuple[str, ...]]:
    """Largest prefix of ("pod","data") whose product divides n."""
    shape = mesh_shape(mesh)
    axes = [a for a in ("pod", "data") if a in shape]
    best: Tuple[str, ...] = ()
    prod = 1
    for i, a in enumerate(axes):
        prod *= shape[a]
        if _div(n, prod):
            best = tuple(axes[: i + 1])
    return best or None


def zero1_spec(pspec, shape: Tuple[int, ...], mesh) -> P:
    """Add ZeRO-1 sharding: put ("data",) (and "pod" if present) on the
    largest dim not already sharded, if divisible."""
    sizes = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    cand = [(shape[i], i) for i in range(len(shape))
            if parts[i] is None and _div(shape[i], dp_size)]
    if not cand:
        return P(*parts)
    _, i = max(cand)
    parts[i] = dp
    return P(*parts)


def train_state_specs(state_shapes, param_specs, mesh) -> Dict[str, Any]:
    """Sharding tree for {master, mu, nu, step}."""
    def z(tree_shapes):
        return tree_map(lambda t, ps, _: zero1_spec(ps, tuple(t.shape), mesh),
                        tree_shapes, param_specs)

    return {"master": z(state_shapes["master"]), "mu": z(state_shapes["mu"]),
            "nu": z(state_shapes["nu"]), "step": P()}


def batch_pspecs(cfg: ModelConfig, specs: Dict[str, Any], mesh
                 ) -> Dict[str, P]:
    return {k: P(_dp_axes(mesh, v.shape[0]), *([None] * (v.dim() - 1)))
            for k, v in specs.items()}


def cache_pspecs(cfg: ModelConfig, cache_shapes, mesh):
    """Sharding for decode caches, by leaf name + rank (per layer: the
    port's cache leaves have no layer dim).

    KV heads over "model" when they divide it (the per-token update and
    the attention stay local), else the sequence (flash-decoding layout:
    qwen3/llava kv=8, chatglm kv=2 on tp=16); the MLA latent over the
    sequence, else its feature dim; the SSM state over heads, the conv
    tail over channels."""
    tp = mesh_shape(mesh).get("model", 1)

    def leaf_spec(path, t):
        leaf = path[-1]
        shape = tuple(t.shape)
        if leaf in ("pos", "xlen"):
            return P()
        parts: List[Any] = [None] * len(shape)
        parts[0] = _dp_axes(mesh, shape[0])
        if leaf in ("k", "v", "xk", "xv"):
            if _div(shape[2], tp):
                parts[2] = "model"
            elif _div(shape[1], tp):
                parts[1] = "model"
        elif leaf in ("c", "kr"):
            if _div(shape[1], tp):
                parts[1] = "model"
            elif _div(shape[-1], tp):
                parts[-1] = "model"
        elif leaf == "h":        # (B, nh, ns, hd)
            if _div(shape[1], tp):
                parts[1] = "model"
        elif leaf == "conv":     # (B, W-1, C)
            if _div(shape[-1], tp):
                parts[-1] = "model"
        return P(*parts)

    return map_leaves(leaf_spec, cache_shapes)


def sanitize_spec(spec_, shape: Tuple[int, ...], mesh) -> P:
    """Drop sharded axes whose extent does not divide the dim (hymba's
    in_proj width 6482, seamless' padded-but-odd tails, ...)."""
    sizes = mesh_shape(mesh)
    parts = list(spec_) + [None] * (len(shape) - len(spec_))
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        keep = []
        prod = 1
        for a in (part if isinstance(part, tuple) else (part,)):
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep
                                                      else None))
    return P(*out)


def sanitize_tree(shapes_tree, spec_tree, mesh):
    return tree_map(lambda t, s, _: sanitize_spec(s, tuple(t.shape), mesh),
                    shapes_tree, spec_tree)


def local_shape(shape: Tuple[int, ...], spec_, mesh) -> Tuple[int, ...]:
    """The shape rank 0 holds of a ``shape`` tensor laid out by
    ``spec_`` (each split rounds up, as DTensor's first shard does)."""
    sizes = mesh_shape(mesh)
    out = []
    for d, n in enumerate(shape):
        part = spec_[d] if d < len(spec_) else None
        for a in (() if part is None else
                  (part if isinstance(part, tuple) else (part,))):
            n = -(-n // sizes[a])
        out.append(n)
    return tuple(out)


def spec_bytes(t: torch.Tensor, spec_, mesh) -> int:
    """Bytes rank 0 holds of ``t`` (any device, meta included) under
    ``spec_``."""
    n = 1
    for s in local_shape(tuple(t.shape), spec_, mesh):
        n *= s
    return n * t.element_size()


def tree_bytes(shapes_tree, spec_tree, mesh) -> int:
    """Per-chip bytes of a tree of tensors laid out by a tree of specs."""
    total = [0]

    def add(t, s, _):
        total[0] += spec_bytes(t, s, mesh)
    tree_map(add, shapes_tree, spec_tree)
    return total[0]


# ---------------------------------------------------------------------------
# DTensors of a tree
# ---------------------------------------------------------------------------


def distribute(t: torch.Tensor, spec_, mesh):
    """A DTensor of ``t`` laid out by ``spec_``.  A real tensor is cut up
    locally (every rank holds the same ``t``, so nothing moves); a meta
    tensor becomes an empty local shard on the mesh's device (fake
    storage under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(tuple(spec_) + (None,) * (t.dim() - len(spec_)),
                               mesh)
    if t.device.type != "meta":
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    loc = torch.empty(local_shape(tuple(t.shape), spec_, mesh), dtype=t.dtype,
                      device=mesh.device_type)
    return DTensor.from_local(loc, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, spec_tree, mesh):
    return tree_map(lambda t, s, _: distribute(t, s, mesh), tree, spec_tree)


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of DTensors (plain tensors count
    whole)."""
    n = 0
    for t in flat_params(tree).values():
        loc = t.to_local() if is_dtensor(t) else t
        n += loc.numel() * loc.element_size()
    return n


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def cast_params(master, dtype: torch.dtype):
    """f32 master -> compute params, fresh leaves that require grad.

    The JAX package casts the leaves of rank >= 2 in its stacked layout
    (``steps.py:175``): every per-layer leaf (norm scales, ``A_log``,
    ``dt_bias``, ``D`` and biases included) and the embedding and head go
    to ``dtype``; only the top-level 1-d leaves (``final_norm``) stay
    f32."""
    def one(p, in_layers):
        if reference_ndim(p, in_layers) >= 2:
            p = p.to(dtype)
        return p.detach().requires_grad_(True)   # master itself stays as is
    return tree_map(one, master)


def _micro_batch(batch: Dict, i: int, n: int) -> Dict:
    """Rows [i B/n, (i+1) B/n) of every batch entry (the JAX package's
    ``reshape((n, B // n) + ...)[i]``); a DTensor's rows are the global
    ones, laid out again as the entry was (the rows move between ranks),
    so that every micro-batch's loss is normalised over the tokens the
    reference's is."""
    def rows(x):
        m = x.shape[0] // n
        part = x[i * m:(i + 1) * m]
        if is_dtensor(x):
            part = part.redistribute(x.device_mesh, x.placements)
        return part
    return {k: rows(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    accum_steps: int = 1, device="cuda", *,
                    param_specs=None, grad_specs=None, mesh=None
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``train_step(state, batch) -> (new_state, metrics)``.

    Compute params are ``cast_params(state["master"])``; their gradients
    come back in the compute dtype and ``adamw_update`` widens them.  With
    ``accum_steps > 1`` the batch is cut into that many micro-batches; their
    gradients are summed in the compute dtype and divided by
    ``accum_steps``, and the loss and metrics are their means, as the JAX
    package's scan over micro-batches does.  The state given is left as it
    was (the update is functional), so a step that raises can be retried.

    With ``mesh`` (the state and batch DTensors, ``param_specs`` the TP
    specs and ``grad_specs`` the ZeRO-1 specs of the master), the ZeRO-1
    mechanics of the JAX package are explicit:
      * each f32 master leaf is cast to bf16 at its ZeRO placement, then
        redistributed to its TP placement -- the ZeRO-1 all-gather moves
        bf16, not f32;
      * the gradients (w.r.t. the bf16 compute params) are redistributed
        to the ZeRO placement before AdamW -- the reduce-scatter -- so the
        optimizer runs on the ZeRO shards only."""
    model = get_model(cfg, device)
    dtype = torch_dtype(cfg.param_dtype)
    sharded = mesh is not None and param_specs is not None

    def cast_and_gather(master):
        if not sharded:
            return cast_params(master, dtype)

        def one(p, pspec, in_layers):
            if reference_ndim(p, in_layers) >= 2:
                p = p.to(dtype)              # at the ZeRO placement
            p = p.redistribute(mesh, to_placements(
                tuple(pspec) + (None,) * (p.dim() - len(pspec)), mesh))
            return p.detach().requires_grad_(True)
        return tree_map(one, master, param_specs)

    def grads_of(params, batch) -> Tuple[torch.Tensor, Dict, List]:
        leaves = list(flat_params(params).values())
        with spans.span("train.forward"):
            loss, metrics = model.loss_fn(params, batch)
        with spans.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def to_zero(grads: List) -> List:
        if not sharded or grad_specs is None:
            return grads
        return [g.redistribute(mesh, to_placements(
            tuple(s) + (None,) * (g.dim() - len(s)), mesh))
            for g, s in zip(grads, _flat_specs(grad_specs))]

    def train_step(state: Dict[str, Any], batch: Dict
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        with mesh_context(mesh if sharded else None):
            with spans.span("train.cast"):
                params = cast_and_gather(state["master"])
            if accum_steps == 1:
                loss, metrics, grads = grads_of(params, batch)
            else:
                acc = [torch.zeros_like(p)
                       for p in flat_params(params).values()]
                ls, ms = [], []
                for i in range(accum_steps):
                    l, m, g = grads_of(params, _micro_batch(batch, i,
                                                            accum_steps))
                    acc = [a + b for a, b in zip(acc, g)]
                    ls.append(l)
                    ms.append(m)
                grads = [g / accum_steps for g in acc]
                loss = torch.stack(ls).mean()
                metrics = {k: torch.stack([m[k] for m in ms]).mean()
                           for k in ms[0]}
            with spans.span("train.optimizer"):
                grads = to_zero(grads)
                it = iter(grads)
                grad_tree = tree_map(lambda p, _: next(it), params)
                new_state, om = adamw_update(ocfg, state, grad_tree)
        return new_state, dict(metrics, loss=loss, **om)

    return train_step


def _flat_specs(spec_tree) -> List:
    """The specs of a tree in ``flat_params`` order (a spec is a tuple, so
    it is walked as a leaf)."""
    out: List = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(spec_tree)
    return out


def make_prefill_step(cfg: ModelConfig, device="cuda", mesh=None):
    model = get_model(cfg, device)

    def prefill_step(params, batch):
        with mesh_context(mesh), torch.no_grad():
            return model.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda", mesh=None,
                     **host: int):
    """``decode_step(params, cache, tokens)``; ``host`` (``pos0``, and an
    encoder-decoder's ``xlen``) gives the positions that the step would
    otherwise read from the cache on the host (the dry run passes them:
    fake tensors hold no values)."""
    model = get_model(cfg, device)

    def decode_step(params, cache, tokens):
        with mesh_context(mesh), torch.no_grad():
            return model.decode_step(params, cache, tokens, **host)

    return decode_step


# ---------------------------------------------------------------------------
# one (arch x shape x mesh) cell
# ---------------------------------------------------------------------------


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is the meta device: the model's
    initializers draw on ``gen.device``, and on meta they draw nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The model's parameters as meta tensors (no storage): the JAX
    package's ``jax.eval_shape(model.init_params)``."""
    from ..models import encdec, lm
    m = encdec if cfg.n_encoder_layers else lm
    return m.init_params(cfg, _MetaGenerator(device="cpu"))


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               accum_steps: int = 1, ocfg: Optional[AdamWConfig] = None, *,
               params: Optional[Dict[str, Any]] = None,
               inputs: Optional[Dict[str, Any]] = None, pos0=None):
    """The step of one cell and its sharded inputs: ``(step, args, meta)``,
    ``step(*args)`` runs it (the JAX package's ``lower_cell``).

    Without ``params`` the inputs are laid out from meta tensors as empty
    local shards, which are fake under ``FakeTensorMode`` (the dry run);
    with ``params`` (the port's full parameter tree, the same on every
    rank) and ``inputs`` (``batch``, or ``cache`` and ``tokens``) they are
    cut up from those real tensors.  ``meta`` carries the specs and the
    per-chip argument bytes."""
    dev = mesh.device_type
    shapes = param_shapes(cfg)
    pspecs = sanitize_tree(shapes, tree_param_specs(shapes), mesh)
    meta: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                            "mesh": mesh_shape(mesh), "param_specs": pspecs}
    src = params if params is not None else shapes
    inputs = inputs or {}

    if shape.kind == "train":
        ocfg = ocfg or AdamWConfig()
        state = adamw_init(src) if params is not None else {
            "master": tree_map(lambda t, _: torch.empty(
                t.shape, dtype=torch.float32, device="meta"), shapes)}
        if params is None:
            state["mu"], state["nu"] = state["master"], state["master"]
            state["step"] = torch.zeros((), dtype=torch.int32,
                                        device="meta")
        st_specs = train_state_specs(state, pspecs, mesh)
        bspecs = inputs.get("batch") or batch_specs(cfg, shape)
        b_pspecs = batch_pspecs(cfg, bspecs, mesh)
        args = ({k: distribute_tree(state[k], st_specs[k], mesh)
                 for k in ("master", "mu", "nu")},
                {k: distribute(v, b_pspecs[k], mesh)
                 for k, v in bspecs.items()})
        args[0]["step"] = _replicated(state["step"], dev)
        step = make_train_step(cfg, ocfg, accum_steps, dev,
                               param_specs=pspecs,
                               grad_specs=st_specs["master"], mesh=mesh)
        meta.update(state_specs=st_specs, batch_specs=b_pspecs,
                    state_bytes=local_bytes(args[0]),
                    batch_bytes=local_bytes(args[1]),
                    arg_bytes=local_bytes(args[0]) + local_bytes(args[1]))
        return step, args, meta

    p_args = distribute_tree(src, pspecs, mesh)
    if shape.kind == "prefill":
        bspecs = inputs.get("batch") or batch_specs(cfg, shape)
        b_pspecs = batch_pspecs(cfg, bspecs, mesh)
        batch = {k: distribute(v, b_pspecs[k], mesh)
                 for k, v in bspecs.items()}
        meta.update(batch_specs=b_pspecs,
                    arg_bytes=local_bytes(p_args) + local_bytes(batch))
        return make_prefill_step(cfg, dev, mesh), (p_args, batch), meta

    if "cache" in inputs:
        cache, tokens = inputs["cache"], inputs["tokens"]
    else:
        dspecs = decode_specs(cfg, shape)
        cache, tokens = dspecs["cache"], dspecs["tokens"]
    c_specs = cache_pspecs(cfg, cache, mesh)
    cache_d = map_leaves(lambda path, t: _cache_leaf(t, _at(c_specs, path),
                                                     mesh), cache)
    tok_spec = P(_dp_axes(mesh, tokens.shape[0]), None)
    tok = distribute(tokens, tok_spec, mesh)
    host: Dict[str, int] = {}
    if pos0 is not None or params is None:
        host["pos0"] = shape.seq_len - 1 if pos0 is None else int(pos0)
        if cfg.n_encoder_layers:
            host["xlen"] = int(cache["layers"][0]["xk"].shape[1])
    meta.update(cache_specs=c_specs, host=host,
                arg_bytes=local_bytes(p_args) + local_bytes(cache_d)
                + local_bytes({"t": tok}))
    return make_decode_step(cfg, dev, mesh, **host), (p_args, cache_d,
                                                      tok), meta


def build_cell_batch(batch: Dict[str, Any], meta: Dict[str, Any], mesh
                     ) -> Dict[str, Any]:
    """Another batch for a built train or prefill cell, laid out by the
    cell's batch specs."""
    return {k: distribute(v, meta["batch_specs"][k], mesh)
            for k, v in batch.items()}


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def _replicated(t: torch.Tensor, dev) -> torch.Tensor:
    """A small replicated leaf (``pos``, ``step``) stays a plain tensor on
    the mesh's device (plain tensors count as replicated in a mesh)."""
    if t.device.type == "meta":
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)
    return t.to(dev)


def _cache_leaf(t: torch.Tensor, spec_, mesh):
    if len(spec_) == 0:
        return _replicated(t, mesh.device_type)
    return distribute(t, spec_, mesh)
