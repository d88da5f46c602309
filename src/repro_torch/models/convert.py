"""Carry the JAX package's model parameters across to the port.

``params_from_numpy`` takes the JAX package's parameter tree with numpy
leaves -- ``jax.tree.map(np.asarray, ModelAPI.init_params(key))`` -- and
returns the port's parameters: the same nested dicts, except that the
stacked per-layer leaves under ``"layers"`` (an encoder-decoder's
``"enc_layers"`` and ``"dec_layers"``; leading axis = layer) become a list
of per-layer dicts.  So ``tree["layers"]["attn"]["wq"][3]`` is the port's
``params["layers"][3]["attn"]["wq"]``, named ``layers.3.attn.wq`` by
:func:`flat_params`.  Dense weights keep their ``(d_in, d_out)`` layout,
expert weights their ``(E, d_in, d_out)``.  A MoE model's first dense
layers (``first_0``, ...) are not stacked there and stay as they are; the
stack holds the other layers.

bfloat16 leaves arrive as numpy arrays of ``ml_dtypes.bfloat16``; they
are recognised by dtype name and carried bit for bit through a uint16
view, so neither ``ml_dtypes`` nor ``jax`` is imported here.

The train state -- ``{"master", "mu", "nu", "step"}``, three parameter
trees and an int32 step -- goes the same way and back:
``state_to_numpy`` stacks the per-layer lists into the JAX package's
layout (host copies; what ``jax.tree.map(np.asarray, state)`` gives
there), which the checkpoint engine writes, and ``state_from_numpy``
splits a tree of that layout (a restored checkpoint, the JAX package's
state) into the port's on a device.  A bfloat16 leaf on the host is a CPU
torch tensor, since numpy has no such dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .lm import layer_kinds

# the keys whose per-layer leaves the JAX package stacks
STACKED = ("layers", "enc_layers", "dec_layers")


def stacked_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Stacked key -> number of layers it holds, for ``cfg``'s family."""
    if cfg.n_encoder_layers:
        return {"enc_layers": cfg.n_encoder_layers,
                "dec_layers": cfg.n_layers}
    return {"layers": layer_kinds(cfg)[2]}


def tensor_from_numpy(a, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """One numpy leaf (or host tensor) -> tensor on ``device`` (bf16 bit
    for bit); cast to ``dtype`` when it is given and the leaf is floating
    point."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to(device, copy=True)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    a = np.array(a, order="C")        # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return tensor_from_numpy(tree, device, dtype)


def _split_layers(stacked, n: int):
    """Stacked leaves (leading axis n) -> list of n trees of slices."""
    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]
    return [pick(stacked, i) for i in range(n)]


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """JAX-package parameters as numpy leaves -> the port's parameters on
    ``device``; ``dtype`` (optional) casts every floating leaf."""
    out = {k: _convert(v, device, dtype) for k, v in tree.items()
           if k not in STACKED}
    for key, n in stacked_counts(cfg).items():
        if key in tree:
            out[key] = [_convert(lp, device, dtype)
                        for lp in _split_layers(tree[key], n)]
    return out


def _host(t: torch.Tensor):
    """A host copy of ``t``: numpy, or a CPU tensor for bfloat16."""
    t = t.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def tree_map(fn: Callable, *trees, in_layers: bool = False):
    """``fn(*leaves, in_layers)`` over trees of one structure (dicts and
    lists; a tuple is a leaf); ``in_layers`` tells whether the leaf lies
    under a stacked key (``STACKED``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees),
                            in_layers=in_layers or k in STACKED)
                for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *(t[i] for t in trees), in_layers=in_layers)
                for i in range(len(first))]
    return fn(*trees, in_layers)


def reference_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of a tree in the JAX package's layout, in the
    order and with the names of ``jax.tree_util.tree_flatten_with_path``:
    dict keys sorted, list items by index, the path joined by ``/``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out += reference_leaves(v, f"{prefix}/{k}" if prefix else k)
    return out


def reference_ndim(t: torch.Tensor, in_layers: bool) -> int:
    """The leaf's rank in the JAX package's stacked layout."""
    return t.dim() + int(in_layers)


def _stack_layers(layers: List[Dict], stack: Callable) -> Dict:
    """Per-layer dicts -> one dict whose leaves ``stack`` the layers."""
    return {k: _stack_layers([lp[k] for lp in layers], stack)
            if isinstance(v, dict) else stack([lp[k] for lp in layers])
            for k, v in layers[0].items()}


def _reference_layout(params: Dict[str, Any], leaf: Callable,
                      stack: Callable) -> Dict[str, Any]:
    return {k: _stack_layers(v, stack) if k in STACKED
            else tree_map(lambda x, _: leaf(x), v)
            for k, v in params.items()}


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters (or gradients) -> host copies in the JAX
    package's layout, the inverse of :func:`params_from_numpy`."""
    return _reference_layout(params, _host,
                             lambda ts: _host(torch.stack(ts)))


def _meta(t: torch.Tensor, lead=()) -> torch.Tensor:
    return torch.empty(tuple(lead) + tuple(t.shape), dtype=t.dtype,
                       device="meta")


_STATE_TREES = ("master", "mu", "nu")


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """Train state -> host copies in the JAX package's layout."""
    out = {k: params_to_numpy(state[k]) for k in _STATE_TREES}
    out["step"] = _host(state["step"])
    return out


def state_shapes(state: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's layout of ``state`` as meta tensors (shapes and
    dtypes, no data): what a checkpoint restore reads into."""
    out = {k: _reference_layout(state[k], _meta,
                                lambda ts: _meta(ts[0], (len(ts),)))
           for k in _STATE_TREES}
    out["step"] = _meta(state["step"])
    return out


def state_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device
                     ) -> Dict[str, Any]:
    """A train state in the JAX package's layout (numpy leaves, or CPU
    tensors for bfloat16) -> the port's on ``device``."""
    out = {k: params_from_numpy(cfg, tree[k], device) for k in _STATE_TREES}
    out["step"] = tensor_from_numpy(tree["step"], device)
    return out


def flat_params(params: Dict[str, Any], prefix: str = ""
                ) -> Dict[str, torch.Tensor]:
    """Dotted name -> tensor, e.g. ``layers.3.attn.wq``."""
    flat: Dict[str, torch.Tensor] = {}
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            flat.update(flat_params(v, name + "."))
        else:
            flat[name] = v
    return flat
