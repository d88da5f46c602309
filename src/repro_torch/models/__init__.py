"""Model API of the port: the decoder-only families (dense, MoE, MLA, SSM,
hybrid, VLM) and the encoder-decoder (seamless), on the card by default.

``get_model(cfg)`` returns a :class:`ModelAPI` bound to one device; its
entry points take and return tensors on that device.  Without a CUDA card
it raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import ModelConfig
from . import encdec, lm


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
    """init / forward / loss / prefill / decode of one model family on one
    device: ``encdec`` when ``cfg.n_encoder_layers`` is set, else ``lm``
    (the JAX package's ``models/__init__.py:18``)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = model_device(device)
        self._m = encdec if cfg.n_encoder_layers else lm

    def init_params(self, gen: torch.Generator) -> Dict:
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return self._m.init_params(self.cfg, gen)

    def train_forward(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        return self._m.train_forward(self.cfg, params, batch)

    def loss_fn(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        return self._m.loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch):
        return self._m.prefill(self.cfg, params, batch)

    def init_cache(self, batch: int, seq: int) -> Dict:
        """Decode caches for ``seq`` positions; an encoder-decoder's cross
        K/V get room for ``seq`` encoder positions too, as in the JAX
        package."""
        if self.cfg.n_encoder_layers:
            return encdec.init_cache(self.cfg, batch, seq, seq, self.device)
        return lm.init_cache(self.cfg, batch, seq, self.device)

    def decode_step(self, params, cache, tokens, **host):
        """``host``: ``pos0`` (and an encoder-decoder's ``xlen``), the
        cache positions known on the host, so that none is read from the
        device."""
        return self._m.decode_step(self.cfg, params, cache, tokens, **host)


def get_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    return ModelAPI(cfg, device)


__all__ = ["ModelConfig", "ModelAPI", "get_model", "model_device"]
