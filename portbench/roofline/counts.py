"""Operations and bytes from shapes.

Kernel counts take each input byte read once and each output byte written
once; operations are 2 a multiply-add, and only the products the masks
keep (the causal triangle of a chunk, the keys inside the window).  Model
counts are the forward pass's products as the published shapes define
them; a training step counts three forward passes (the backward twice the
forward) and no recompute, so removing a recompute cannot raise a share.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> Dict[str, Any]:
    """The card's published peaks, by the name the card gives."""
    with open(PEAKS) as f:
        table = json.load(f)
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in {PEAKS.name}")
    return table[kind]


def min_time(flops: float, nbytes: float, pk: Dict[str, Any],
             precision: str = "bf16") -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / pk[f"{precision}_flops"],
               nbytes / pk["hbm_bytes_per_s"])


def ssd_scan(B: int, nc: int, Q: int, nh: int, hd: int, ns: int,
             elem: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one chunk scan: x (B, nc, Q, nh, hd) and b, c
    (B, nc, Q, ns) of ``elem`` bytes, dt and da f32 (B, nc, Q, nh) in; y
    like x and the f32 final state (B, nh, ns, hd) out."""
    tri = Q * (Q + 1) // 2
    per_chunk = 2 * tri * ns + nh * (2 * tri * hd + 2 * Q * ns * hd
                                     + 2 * Q * ns * hd + 2 * ns * hd)
    flops = float(B * nc * per_chunk)
    T = B * nc * Q
    nbytes = float(2 * T * nh * hd * elem + 2 * T * ns * elem
                   + 2 * T * nh * 4 + B * nh * ns * hd * 4)
    return flops, nbytes


def attention_pairs(S: int, window: int, causal: bool = True) -> int:
    """(query, key) pairs the masks keep over one sequence of S."""
    if not causal:
        return S * (S if not window else min(S, window))
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_attention(B: int, S: int, H: int, KV: int, hd: int, window: int,
                    causal: bool = True, elem: int = 2
                    ) -> Tuple[float, float]:
    """(operations, bytes) of one attention call: q and the output (B, S,
    H, hd), k and v (B, S, KV, hd)."""
    flops = float(4 * B * H * hd * attention_pairs(S, window, causal))
    nbytes = float(2 * B * S * H * hd * elem + 2 * B * S * KV * hd * elem)
    return flops, nbytes


def _ssd_block_flops(model: Dict[str, Any], S: int) -> float:
    """Forward operations of one SSD block over one sequence of S, the
    projections included."""
    d = model["d_model"]
    di = model["ssm_expand"] * d
    ns, shd = model["ssm_state"], model["ssm_head_dim"]
    nh = di // shd
    Q = min(model["ssm_chunk"], S)
    while S % Q:
        Q -= 1
    proj = 2 * S * (d * (2 * di + 2 * ns + nh) + di * d)
    conv = 2 * S * model["conv_width"] * (di + 2 * ns)
    scan, _ = ssd_scan(1, S // Q, Q, nh, shd, ns)
    return proj + conv + scan


def forward_flops(model: Dict[str, Any], S: int, head_positions: int
                  ) -> float:
    """Forward operations of the model over one sequence of S tokens, the
    head taken at ``head_positions`` of them (S in training, 1 in a
    prefill)."""
    d, L = model["d_model"], model["n_layers"]
    per_layer = _ssd_block_flops(model, S)
    if model["family"] == "hybrid":
        H, KV, hd, ff = (model["n_heads"], model["n_kv_heads"],
                         model["head_dim"], model["d_ff"])
        per_layer += 2 * S * (d * H * hd * 2 + d * KV * hd * 2)
        per_layer += 4 * H * hd * attention_pairs(S, model["sliding_window"])
        per_layer += 2 * S * 3 * d * ff
    elif model["family"] != "ssm":
        raise ValueError(f"family {model['family']!r} is not counted")
    head = 2 * head_positions * d * model["vocab_size"]
    return float(L * per_layer + head)


def train_step_flops(model: Dict[str, Any], batch: int, S: int) -> float:
    return 3.0 * batch * forward_flops(model, S, S)


def prefill_flops(model: Dict[str, Any], batch: int, S: int) -> float:
    return float(batch) * forward_flops(model, S, 1)
