"""Mamba-2 (SSD, state-space duality) blocks in PyTorch -- arXiv:2405.21060.

The counterpart of the JAX package's ``models/ssm.py``.  Train/prefill
uses the chunked SSD algorithm: within a chunk of length Q the output is a
masked, decay-weighted attention-like contraction, and the (ns, hd) state
of every head is passed from chunk to chunk in order.  Q is chosen as the
JAX package chooses it (``ssm.py:85-87``): the largest divisor of the
sequence length up to ``cfg.ssm_chunk``.

Two chunk-scan paths, selected by ``cfg.ssm_impl`` as ``attn_impl``
selects the attention:

  "cuda"   the hand-written SSD chunk-scan kernel (``kernels.ssd_scan``,
           with ``return_state``); on CPU tensors its plain version
  "torch"  the kernel's plain version (``kernels/ssd_scan/ref.py``),
           which computes the JAX package's ``chunk_step`` loop
           (``ssm.py:110-137``) in plain PyTorch

When a gradient is needed, both go through
``kernels.ssd_scan.ops.ssd_scan_with_grad``: the forward pass runs with
autograd off and saves only the scan's inputs, and the backward pass is
the hand-written f32 backward kernel on CUDA tensors (the plain version's
autograd, recomputed, on CPU tensors).

The JAX model runs only the second (its Pallas kernel is tested but never
called by the model).  The gated head norm goes through the RMSNorm op
(``layers.rms_norm_head``).  Decode is the O(1) recurrence
``h = exp(dt*A) h + dt * B outer x`` in plain PyTorch, as the JAX package
runs it in XLA.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate

from ..distributed.sharding import (batch_placements, is_dtensor,
                                    local_run, placements_of, shard)
from ..kernels.ssd_scan import ops as ssd_ops
from ..kernels.ssd_scan.ref import ssd_scan_chunked_ref
from .config import ModelConfig
from .layers import dense_init, merge_heads, rms_norm_head, torch_dtype

Params = Dict[str, Any]


def ssd_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """The JAX package's shapes, scales and dtypes (``ssm.py:34-54``)."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv_ch = di + 2 * ns
    in_proj = dense_init(gen, d, 2 * di + 2 * ns + nh, dt)
    conv_w = torch.randn((cfg.conv_width, conv_ch), generator=gen, **f32)
    # dt bias initialized so softplus(dt_bias) spans [1e-3, 1e-1]
    u = torch.rand((nh,), generator=gen, **f32)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt_init = torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo)))
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w / math.sqrt(cfg.conv_width)).to(dt),
        "conv_b": torch.zeros((conv_ch,), **f32),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": dt_init,
        "gate_norm": torch.ones((cfg.ssm_head_dim,), **f32),
        "out_proj": dense_init(gen, di, d, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, S, C); w: (W, C).  Shifted slices
    added in ``x.dtype`` one after another, as the JAX package sums them
    (``ssm.py:57-66``), so bf16 rounds at the same places.  On a DTensor
    it runs on every rank's batch shard (sequence and channels whole)."""
    if is_dtensor(x):
        mesh = x.device_mesh
        pl = batch_placements(x, mesh)
        rep = [Replicate() for _ in pl]
        return local_run(_causal_conv, (x, w, b), (pl, rep, rep), pl, mesh)
    W = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, ns = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:di + di + 2 * ns]
    dt_raw = proj[..., di + di + 2 * ns:]
    return z, xbc, dt_raw


def ssd_chunk_scan(cfg: ModelConfig, x, b, c, dt, da
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk scan on the path ``cfg.ssm_impl`` selects: (y, final
    state); on DTensors, on every rank's batch shard."""
    if is_dtensor(x):
        mesh = x.device_mesh
        dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        pls = [placements_of((dp or None,), t.dim(), mesh)
               for t in (x, b, c, dt, da)]
        return local_run(lambda *a: ssd_chunk_scan(cfg, *a),
                         (x, b, c, dt, da), pls, (pls[0], pls[0]), mesh)
    forward = {"cuda": ssd_ops.ssd_scan_op,
               "torch": ssd_scan_chunked_ref}.get(cfg.ssm_impl)
    if forward is None:
        raise ValueError(f"ssm_impl must be 'cuda' or 'torch', got "
                         f"{cfg.ssm_impl!r}")
    return ssd_ops.ssd_scan_with_grad(forward, x, b, c, dt, da)


def ssd_apply(p: Params, cfg: ModelConfig, x_in: torch.Tensor,
              with_cache: bool = False):
    """Full-sequence SSD. x_in: (B, S, d_model) -> (B, S, d_model).

    ``with_cache=True`` additionally returns the decode cache (final state +
    conv tail) for prefill."""
    Bsz, S, _ = x_in.shape
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    proj = x_in @ p["in_proj"].to(x_in.dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :di].reshape(Bsz, S, nh, hd)
    Bm = xbc[..., di:di + ns]                       # (B, S, ns), group=1
    Cm = xbc[..., di + ns:]                         # (B, S, ns)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, S, nh)
    A = -torch.exp(p["A_log"])                      # (nh,)
    dA = dt * A                                     # (B, S, nh)
    xs = shard(xs, "batch", None, None, None)

    # chunked views (x, b and c stay column slices: the kernel takes strides)
    y, h_fin = ssd_chunk_scan(cfg, xs.reshape(Bsz, nc, Q, nh, hd),
                              Bm.reshape(Bsz, nc, Q, ns),
                              Cm.reshape(Bsz, nc, Q, ns),
                              dt.reshape(Bsz, nc, Q, nh),
                              dA.reshape(Bsz, nc, Q, nh))
    y = y.reshape(Bsz, S, nh, hd)
    y = y + xs * p["D"].to(x_in.dtype)[None, None, :, None]
    # gated head norm, then out-projection
    zs = z.reshape(Bsz, S, nh, hd)
    y = rms_norm_head(y * F.silu(zs), p["gate_norm"], cfg.norm_eps)
    out = shard(merge_heads(y) @ p["out_proj"].to(x_in.dtype),
                "batch", None, None)
    if with_cache:
        # raw (pre-conv) xbc tail feeds the decode-side conv window; a
        # prompt shorter than conv_width - 1 gives a shorter tail (the
        # negative start slices from the end, as in the JAX package)
        raw_xbc = proj[..., di:di + di + 2 * ns]
        cache = {"h": h_fin,
                 "conv": raw_xbc[:, S - (cfg.conv_width - 1):, :].clone()}
        return out, cache
    return out


# ---------------------------------------------------------------------------
# decode (O(1) recurrence)
# ---------------------------------------------------------------------------


def ssd_cache_init(cfg: ModelConfig, batch: int, dtype, device) -> Dict:
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "h": torch.zeros((batch, nh, ns, hd), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di + 2 * ns),
                            dtype=dtype, device=device),
    }


def ssd_decode(p: Params, cfg: ModelConfig, x_in: torch.Tensor, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token SSD step. x_in: (B, 1, d_model).  Returns the output and
    a new cache (the old one is left as it was)."""
    Bsz = x_in.shape[0]
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x_in[:, 0] @ p["in_proj"].to(x_in.dtype)
    z, xbc, dt_raw = _split_proj(cfg, proj)
    # conv over (cached W-1 inputs, current)
    hist = torch.cat([cache["conv"],
                      xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(x_in.dtype)
    conv_out = torch.einsum("bwc,wc->bc", hist.to(x_in.dtype), w) \
        + p["conv_b"].to(x_in.dtype)
    xbc = F.silu(conv_out)
    xs = xbc[:, :di].reshape(Bsz, nh, hd)
    Bm = xbc[:, di:di + ns]
    Cm = xbc[:, di + ns:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])                 # (B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                      # (B, nh)
    h = cache["h"] * decay[:, :, None, None] + torch.einsum(
        "bs,bh,bhd->bhsd", Bm.float(), dt, xs.float())
    y = torch.einsum("bs,bhsd->bhd", Cm.float(), h)
    y = y.to(x_in.dtype) + xs * p["D"].to(x_in.dtype)[None, :, None]
    zs = z.reshape(Bsz, nh, hd)
    y = rms_norm_head(y * F.silu(zs), p["gate_norm"], cfg.norm_eps)
    out = y.reshape(Bsz, 1, di) @ p["out_proj"].to(x_in.dtype)
    return out, {"h": h, "conv": hist[:, 1:]}
