"""Plain PyTorch version of the flash-attention kernel: softmax attention
over the whole (Sq, Skv) score matrix, the math of the JAX package's
``attention_ref`` in the (B, S, H, D) layout.

The wrapper in ``ops.py`` runs it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""

from __future__ import annotations

import math

import torch


def attention_mask(sq: int, skv: int, causal: bool, window: int,
                   device) -> torch.Tensor:
    """(sq, skv) bool: True where query i may attend to key j (causal:
    j <= i; window w > 0: j > i - w)."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= kp > qp - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D), H % KVH == 0 ->
    (B, Sq, H, D) in q's dtype.  Scores, softmax and p @ v in f32; a row
    with no visible key gives 0."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    qf = q.float().reshape(B, Sq, KVH, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * (1.0 / math.sqrt(D))
    mask = attention_mask(Sq, Skv, causal, window, q.device)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
