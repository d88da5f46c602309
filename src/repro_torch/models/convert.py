"""Carry the JAX package's model parameters across to the port.

``params_from_numpy`` takes the JAX package's parameter tree with numpy
leaves -- ``jax.tree.map(np.asarray, ModelAPI.init_params(key))`` -- and
returns the port's parameters: the same nested dicts, except that the
stacked per-layer leaves under ``"layers"`` (leading axis = layer) become
a list of per-layer dicts.  So ``tree["layers"]["attn"]["wq"][3]`` is the
port's ``params["layers"][3]["attn"]["wq"]``, named ``layers.3.attn.wq``
by :func:`flat_params`.  Dense weights keep their ``(d_in, d_out)``
layout.

bfloat16 leaves arrive as numpy arrays of ``ml_dtypes.bfloat16``; they
are recognised by dtype name and carried bit for bit through a uint16
view, so neither ``ml_dtypes`` nor ``jax`` is imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import ModelConfig


def tensor_from_numpy(a, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """One numpy leaf -> tensor on ``device`` (bf16 bit for bit); cast to
    ``dtype`` when it is given and the leaf is floating point."""
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
           if k != "layers"}
    if "layers" in tree:
        layers = _split_layers(tree["layers"], cfg.n_layers)
        out["layers"] = [_convert(lp, device, dtype) for lp in layers]
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
