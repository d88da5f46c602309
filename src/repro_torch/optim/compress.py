"""Error-feedback int8 gradient compression (the JAX package's
``optim/compress.py``).

``ef_int8_compress(g, err)`` quantizes ``g + err`` to int8 and returns
(q, scale, new_err) with new_err = input - dequant(q); the quantization
noise is fed back into the next step, so it is unbiased over steps.
Plain functions: the collective that sums ``q`` across pods
(``compressed_psum_tree``) waits for the sharding slice of the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ef_int8_compress(g: torch.Tensor, err: torch.Tensor,
                     scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (g + err) to int8 on a scale of max|x| / 127, or on
    ``scale`` when it is given (ranks that sum their payloads share one
    scale).  Returns (q_int8, scale, new_err)."""
    x = g.to(torch.float32) + err
    if scale is None:
        amax = torch.max(torch.abs(x))
        scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, x - deq


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
