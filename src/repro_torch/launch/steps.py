"""The mixed-precision train step of the port (the JAX package's
``launch/steps.py``: ``cast_params`` and ``make_train_step``).

On one device the JAX package's sharding constraints are identities, so
none is taken here; the specs, ZeRO-1 and ``lower_cell`` wait for the
sharding slice of the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from ..models import get_model
from ..models.config import ModelConfig
from ..models.convert import flat_params, reference_ndim, tree_map
from ..models.layers import torch_dtype
from ..optim import AdamWConfig, adamw_update


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
    ``reshape((n, B // n) + ...)[i]``)."""
    def rows(x):
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]
    return {k: rows(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    accum_steps: int = 1, device="cuda"
                    ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``train_step(state, batch) -> (new_state, metrics)``.

    Compute params are ``cast_params(state["master"])``; their gradients
    come back in the compute dtype and ``adamw_update`` widens them.  With
    ``accum_steps > 1`` the batch is cut into that many micro-batches; their
    gradients are summed in the compute dtype and divided by
    ``accum_steps``, and the loss and metrics are their means, as the JAX
    package's scan over micro-batches does.  The state given is left as it
    was (the update is functional), so a step that raises can be retried."""
    model = get_model(cfg, device)
    dtype = torch_dtype(cfg.param_dtype)

    def grads_of(params, batch) -> Tuple[torch.Tensor, Dict, List]:
        leaves = list(flat_params(params).values())
        loss, metrics = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state: Dict[str, Any], batch: Dict
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        params = cast_params(state["master"], dtype)
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
        it = iter(grads)
        grad_tree = tree_map(lambda p, _: next(it), params)
        new_state, om = adamw_update(ocfg, state, grad_tree)
        return new_state, dict(metrics, loss=loss, **om)

    return train_step
