"""Model API of the port: the dense, SSM and hybrid decoder families, on
the card by default.

``get_model(cfg)`` returns a :class:`ModelAPI` bound to one device; its
entry points take and return tensors on that device.  Without a CUDA card
it raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import ModelConfig
from . import lm

# the ROADMAP slices that bring the other families
_NOT_PORTED = (
    (lambda c: c.n_encoder_layers > 0, "encoder-decoder (seamless)"),
    (lambda c: c.family == "vlm", "the VLM backbone (llava-next)"),
    (lambda c: c.mla, "MLA (deepseek-v2-lite)"),
    (lambda c: c.is_moe, "MoE (deepseek-moe)"),
)


def model_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when no card
    is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is "
                           "False); pass device='cpu' to run on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device must be cpu or cuda, got {dev}")
    return dev


class ModelAPI:
    """init / forward / prefill / decode of the dense, SSM and hybrid
    families on one device."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        for refused, family in _NOT_PORTED:
            if refused(cfg):
                raise NotImplementedError(
                    f"{cfg.name}: {family} is not ported to repro_torch yet "
                    f"(ROADMAP queue 1, item 5)")
        self.cfg = cfg
        self.device = model_device(device)

    def init_params(self, gen: torch.Generator) -> Dict:
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return lm.init_params(self.cfg, gen)

    def train_forward(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        return lm.train_forward(self.cfg, params, batch)

    def prefill(self, params, batch):
        return lm.prefill(self.cfg, params, batch)

    def init_cache(self, batch: int, seq: int) -> Dict:
        return lm.init_cache(self.cfg, batch, seq, self.device)

    def decode_step(self, params, cache, tokens):
        return lm.decode_step(self.cfg, params, cache, tokens)


def get_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    return ModelAPI(cfg, device)


__all__ = ["ModelConfig", "ModelAPI", "get_model", "model_device"]
