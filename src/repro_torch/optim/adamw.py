"""AdamW with f32 master weights, in PyTorch (the JAX package's
``optim/adamw.py``).

The train state holds f32 master weights and f32 first and second
moments; compute params are ``launch.steps.cast_params(master)``, made
anew every step, and their gradients arrive in the compute dtype and are
widened to f32 here.  The arithmetic is the JAX package's, in f32 tensors
on the state's device: ``step`` is counted in int32 and widened to f32 for
the schedule and the bias corrections.

Parameter trees are the port's (``models/convert.py``): the per-layer
leaves sit in lists under ``"layers"`` (an encoder-decoder's
``"enc_layers"`` and ``"dec_layers"``), where the JAX package stacks them
along a leading layer axis.  Weight decay follows the JAX package's rule,
``ndim >= 2`` in its stacked layout (``adamw.py:81``): a per-layer leaf
counts one dimension more than it has here, so every per-layer leaf is
decayed -- norm scales, ``A_log``, ``dt_bias`` and ``D`` included -- and
only the top-level 1-d leaves (``final_norm``, ``enc_norm``) are not.

``adamw_update`` is functional: it builds new tensors and leaves the state
it was given as it was, also when it raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.convert import flat_params, reference_ndim, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr`` (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac
                    + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> Dict[str, Any]:
    """The optimizer state from (possibly low-precision) params."""
    master = tree_map(lambda p, _: p.detach().to(torch.float32).clone(),
                      params)

    def zeros():
        return tree_map(lambda p, _: torch.zeros_like(p), master)
    dev = next(iter(flat_params(master).values())).device
    return {"master": master, "mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(l.to(torch.float32)))
                          for l in flat_params(tree).values()))


def adamw_update(cfg: AdamWConfig, state: Dict[str, Any], grads
                 ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new state, {"lr", "grad_norm"})."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip \
        else torch.ones((), dtype=torch.float32, device=gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    bc2 = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

    def upd(m, mu, nu, g, in_layers):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu / bc1
        nhat = nu / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        # no decay on norms: ndim counted in the stacked layout
        decay = cfg.weight_decay if reference_ndim(m, in_layers) >= 2 \
            else 0.0
        return m - lr * (delta + decay * m), mu, nu

    outs = tree_map(upd, state["master"], state["mu"], state["nu"], grads)
    new = {k: tree_map(lambda o, _, i=i: o[i], outs)
           for i, k in enumerate(("master", "mu", "nu"))}
    new["step"] = step
    return new, {"lr": lr, "grad_norm": gnorm}
