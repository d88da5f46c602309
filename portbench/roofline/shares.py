"""Shares of the card's peaks, from what a traced run left: the window's
model operations over the window (MFU), a kernel's least time from shapes
over its device time in the profiled sub-window (roofline), and the
sub-window's idle share."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..profiler import kernel_seconds
from ..reference.model import chunk_len
from . import counts

# profiler names of each kernel's launches; the port counts one call of
# ``ssd_scan`` for its three bf16 passes (or its one f32 kernel)
KERNELS = {"ssd_scan": ("ssd_chunk_state", "ssd_state_pass",
                        "ssd_chunk_out", "ssd_scan_kernel"),
           "flash_attention": ("flash_attention_wgmma",
                               "flash_attention_kernel")}


def card_peaks(ctx: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if not ctx["run"].cuda:
        return None
    try:
        return counts.peaks(torch.cuda.get_device_name(0))
    except KeyError:
        return None


def kernel_counts(ctx: Dict[str, Any], kernel: str) -> Tuple[float, float]:
    """(operations, bytes) of one call of ``kernel`` at the cell's shapes."""
    m, mix = ctx["cell"]["model"], ctx["cell"]["mix"]
    B = mix["batch"]
    S = mix.get("seq_len") or mix["prompt_len"]
    if kernel == "ssd_scan":
        Q = chunk_len(S, m["ssm_chunk"])
        di = m["ssm_expand"] * m["d_model"]
        return counts.ssd_scan(B, S // Q, Q, di // m["ssm_head_dim"],
                               m["ssm_head_dim"], m["ssm_state"])
    if kernel == "flash_attention":
        return counts.flash_attention(B, S, m["n_heads"], m["n_kv_heads"],
                                      m["head_dim"], m["sliding_window"])
    raise KeyError(kernel)


def roofline(ctx: Dict[str, Any], kernel: str) -> Optional[float]:
    prof, pk = ctx["profile"], card_peaks(ctx)
    if not prof or pk is None:
        return None
    calls = prof["launches"].get(kernel, 0)
    secs = kernel_seconds(prof, KERNELS[kernel])
    if not calls or secs <= 0:
        return None
    flops, nbytes = kernel_counts(ctx, kernel)
    return 100.0 * calls * counts.min_time(flops, nbytes, pk) / secs


def mfu(ctx: Dict[str, Any]) -> Optional[float]:
    pk, c = card_peaks(ctx), ctx["counters"]
    if pk is None or not c.get("model_flops"):
        return None
    return 100.0 * c["model_flops"] / (c["window_s"] * pk["bf16_flops"])


def idle(ctx: Dict[str, Any]) -> Optional[float]:
    prof = ctx["profile"]
    if not prof or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def span_ms(ctx: Dict[str, Any], name: str) -> Optional[float]:
    spans = ctx["spans"].get(name)
    return 1e3 * sum(spans) if spans else None
