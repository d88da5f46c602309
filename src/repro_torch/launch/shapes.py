"""Assigned input shapes x applicability, and meta-tensor input specs (the
JAX package's ``launch/shapes.py``).

Four shapes per LM architecture (40 cells total):

  train_4k      seq 4096,   global_batch 256   -> train_step
  prefill_32k   seq 32768,  global_batch 32    -> prefill
  decode_32k    seq 32768,  global_batch 128   -> decode_step (1 new token)
  long_500k     seq 524288, global_batch 1     -> decode_step

``long_500k`` requires sub-quadratic attention: only the SSM (mamba2) and
hybrid-SWA (hymba) architectures run it; pure full-attention archs record a
SKIP.  Every cell is well-defined: the specs are tensors on the ``meta``
device (shape and dtype, no storage), as ``jax.eval_shape`` gives
``ShapeDtypeStruct``s; nothing is allocated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models import encdec, lm
from ..models.config import ModelConfig
from ..models.layers import torch_dtype


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape == "long_500k":
        if cfg.family == "ssm" or (cfg.hybrid and cfg.sliding_window):
            return True, ""
        return False, ("full O(S^2) attention at 524k tokens: skipped per "
                       "assignment rule (sub-quadratic archs only)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _i32(*shape) -> torch.Tensor:
    return _meta(shape, torch.int32)


def _act(cfg: ModelConfig, *shape) -> torch.Tensor:
    return _meta(shape, torch_dtype(cfg.dtype))


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta tensors for the data batch of a train/prefill step."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        st = S - cfg.n_patches
        out = {"tokens": _i32(B, st),
               "patches": _act(cfg, B, cfg.n_patches, cfg.d_model)}
    elif cfg.family == "encdec":
        out = {"tokens": _i32(B, S), "frames": _act(cfg, B, S, cfg.d_model)}
    else:
        out = {"tokens": _i32(B, S)}
    if shape.kind == "train":
        out["labels"] = _i32(*out["tokens"].shape)
    return out


def init_cache_on(cfg: ModelConfig, batch: int, seq: int, device
                  ) -> Dict[str, Any]:
    """The model's zero decode caches for ``seq`` positions on ``device``
    (an encoder-decoder's cross K/V for ``seq`` encoder positions too, as
    ``ModelAPI.init_cache``)."""
    if cfg.n_encoder_layers:
        return encdec.init_cache(cfg, batch, seq, seq, device)
    return lm.init_cache(cfg, batch, seq, device)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Specs for one decode step: current tokens + full KV/state cache,
    built by ``init_cache`` on the meta device."""
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _i32(B, 1), "cache": init_cache_on(cfg, B, S, "meta")}
