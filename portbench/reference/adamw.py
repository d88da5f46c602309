"""AdamW with global-norm clipping, a linear warm-up and a cosine decay, on a
flat dict of f32 leaves (Loshchilov and Hutter, arXiv:1711.05101).  Every
leaf is decayed except the 1-d leaves outside the layers (the final
norm's scale), as the training job the benchmark drives states."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def learning_rate(opt: Dict[str, float], step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr"] * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"])
                        * 0.5 * (1 + math.cos(math.pi * t)))


def decayed(name: str, leaf: torch.Tensor) -> bool:
    return name.startswith("layers.") or leaf.dim() >= 2


class AdamW:
    def __init__(self, opt: Dict[str, float], params: Dict[str, torch.Tensor]):
        self.opt = opt
        self.step = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> Tuple[float, float]:
        """One step in place; returns (the gradients' global norm, the
        clip factor applied)."""
        o = self.opt
        self.step += 1
        lr = learning_rate(o, self.step)
        gnorm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads.values()))
        scale = min(o["grad_clip"] / max(gnorm, 1e-12), 1.0) \
            if o["grad_clip"] else 1.0
        bc1 = 1 - o["b1"] ** self.step
        bc2 = 1 - o["b2"] ** self.step
        for k, p in params.items():
            g = grads[k] * scale
            self.mu[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
            self.nu[k].mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
            delta = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                          + o["eps"])
            wd = o["weight_decay"] if decayed(k, p) else 0.0
            p.sub_(lr * (delta + wd * p))
        return gnorm, scale
