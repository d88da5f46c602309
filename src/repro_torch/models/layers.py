"""Transformer building blocks of the decoder families, in PyTorch.

The counterpart of the JAX package's ``models/layers.py``: GQA attention,
MLA (DeepSeek-V2's latent attention), norms, RoPE, the MLP and the MoE
layer (top-k routing, capacity dispatch, batched expert FFNs; the local
``ep=1`` path, as the JAX package runs it without a mesh).  Parameters
are plain dictionaries of tensors with the JAX package's names and
layouts: a dense weight is ``(d_in, d_out)`` and is applied as ``x @ w``;
expert weights are ``(E, d_in, d_out)``.

Two attention paths, selected by ``cfg.attn_impl`` as ``layers.py:348``
does in the JAX package:

  "cuda"   the hand-written flash-attention kernel
           (``kernels.flash_attention``); on CPU tensors its plain version;
           when a gradient is needed, the backward pass recomputes the
           plain version (``kernels/_grad.py``)
  "torch"  :func:`flash_attention_torch`, the chunked online-softmax
           attention of ``flash_attention_xla`` in plain PyTorch

The two differ by bf16 rounding: the kernel keeps p in f32 for p @ v, the
chunked path rounds p to the value dtype first, as the XLA path does.
QK-norm and MLA's latent norm (``rms_norm_head``) always go through the
RMSNorm op (``kernels.rmsnorm``).  MLA's prefill attention (q/k head dim
``qk_nope_dim + qk_rope_dim``, v head dim ``v_head_dim``) always takes
:func:`flash_attention_torch`, as the JAX package routes it through
``flash_attention_xla`` whatever ``attn_impl`` says (``layers.py:435``).
Decode attention and the MoE products stay plain PyTorch, as the JAX
package runs them in XLA.  There is no mesh: sharding constraints are
identities on one device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import _grad
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_attention.ref import flash_attention_ref
from ..kernels.rmsnorm import ops as rmsnorm_ops
from ..kernels.rmsnorm.ref import rmsnorm_ref
from .config import ModelConfig

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` and so on."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# initializers / norms
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(d_in, d_out) weight, normal with std 1/sqrt(d_in), drawn in f32 on
    the generator's device and cast to ``dtype``."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def norm_init(d: int, cfg: ModelConfig, device, bias: bool = False
              ) -> Params:
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layer" or bias:
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def apply_norm(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm or LayerNorm with the JAX package's rounding: statistics
    summed in f32, the product taken in ``x.dtype``."""
    d = x.shape[-1]
    if cfg.norm == "layer":
        mu = x.sum(dim=-1, keepdim=True, dtype=torch.float32) / d
        xc = x - mu.to(x.dtype)
    else:
        xc = x
    var = xc.square().sum(dim=-1, keepdim=True, dtype=torch.float32) / d
    nf = torch.rsqrt(var + cfg.norm_eps)
    y = xc * nf.to(x.dtype) * p["scale"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def rms_norm_head(x: torch.Tensor, scale: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """Per-head RMS norm over the last dim (qwen3 qk_norm): the RMSNorm
    kernel's function, f32 statistics and one cast at the end.  A training
    step may hand over a bf16 ``scale`` (``launch.steps.cast_params``); it
    is widened to f32, as the JAX package's f32 product widens it."""
    return _grad.apply(rmsnorm_ops.rmsnorm, rmsnorm_ref, x.contiguous(),
                       scale.float(), eps=eps)


# ---------------------------------------------------------------------------
# rotary embeddings (full / partial fraction)
# ---------------------------------------------------------------------------


def rope_rotate(x: torch.Tensor, positions: torch.Tensor, theta: float,
                fraction: float = 1.0) -> torch.Tensor:
    """Apply RoPE to the first ``fraction`` of the head dim.

    x: (B, S, H, hd); positions: (B, S).
    """
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., :, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


# ---------------------------------------------------------------------------
# chunked (flash-style) attention -- the plain "torch" path
# ---------------------------------------------------------------------------


def _pick_chunk(s: int, target: int) -> int:
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def _mm_f32(a: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``einsum(a, x, y)`` accumulated and returned in f32, as the JAX
    package's ``preferred_element_type=f32`` (products of bf16 values are
    exact in f32)."""
    return torch.einsum(a, x.float(), y.float())


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, window: int = 0,
                          q_chunk: int = 512, kv_chunk: int = 1024
                          ) -> torch.Tensor:
    """Online-softmax attention without materializing (S, S) scores.

    q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd).  GQA via head grouping.
    ``window`` > 0: sliding-window attention (keys in [pos-window+1, pos]).
    kv chunks that the masks empty for the whole q chunk are skipped: they
    would add exactly nothing.  Returns (B, Sq, H, hd) in q's dtype.
    """
    B, Sq, H, Dq = q.shape
    _, Skv, KVH, _ = k.shape
    Dv = v.shape[-1]
    G = H // KVH
    qc = _pick_chunk(Sq, q_chunk)
    kc = _pick_chunk(Skv, kv_chunk)
    scale = 1.0 / math.sqrt(Dq)
    qr = q.reshape(B, Sq, KVH, G, Dq)
    out = torch.empty(B, Sq, KVH, G, Dv, dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, qc):
        qb = qr[:, q0:q0 + qc]                       # (B, qc, KVH, G, Dq)
        q_pos = torch.arange(q0, q0 + qc, device=q.device)
        m = torch.full((B, KVH, G, qc), float("-inf"), device=q.device)
        l = torch.zeros((B, KVH, G, qc), device=q.device)
        acc = torch.zeros((B, KVH, G, qc, Dv), device=q.device)
        for k0 in range(0, Skv, kc):
            if causal and k0 > q0 + qc - 1:
                break
            if window and k0 + kc - 1 <= q0 - window:
                continue
            kb, vb = k[:, k0:k0 + kc], v[:, k0:k0 + kc]
            k_pos = torch.arange(k0, k0 + kc, device=q.device)
            s = _mm_f32("bqhgd,bkhd->bhgqk", qb, kb) * scale
            mask = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _mm_f32(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, q0:q0 + qc] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(B, Sq, H, Dv)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: int, *,
                     kv_chunk: int = 2048) -> torch.Tensor:
    """Single-token attention over a (possibly ring) KV cache.

    q: (B, 1, H, Dq); caches: (B, S, KVH, D*); cur_len: count of valid
    entries (ring caches pass W once full).  Chunked online-softmax over
    the sequence, as the JAX package's ``decode_attention``.
    """
    B, _, H, Dq = q.shape
    _, S, KVH, Dv = v_cache.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(Dq)
    qr = q.reshape(B, KVH, G, Dq)
    kc = _pick_chunk(S, kv_chunk)
    m = torch.full((B, KVH, G), float("-inf"), device=q.device)
    l = torch.zeros((B, KVH, G), device=q.device)
    acc = torch.zeros((B, KVH, G, Dv), device=q.device)
    for k0 in range(0, S, kc):
        kb, vb = k_cache[:, k0:k0 + kc], v_cache[:, k0:k0 + kc]
        s = _mm_f32("bhgd,bkhd->bhgk", qr, kb) * scale
        valid = torch.arange(k0, k0 + kc, device=q.device) < cur_len
        s = torch.where(valid, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + _mm_f32("bhgk,bkhd->bhgd",
                                              p.to(vb.dtype), vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, 1, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer (init / prefill / decode)
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.hd
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device
    p: Params = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros(n * hd, dtype=torch.float32, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones(hd, dtype=torch.float32, device=dev)
    return p


def qkv_project(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_head(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_head(k, p["k_norm"], cfg.norm_eps)
    q = rope_rotate(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope_rotate(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention on the path ``cfg.attn_impl`` selects."""
    if cfg.attn_impl == "cuda":
        return _grad.apply(flash_ops.flash_attention, flash_attention_ref,
                           q, k, v, causal=cfg.causal,
                           window=int(cfg.sliding_window))
    if cfg.attn_impl == "torch":
        return flash_attention_torch(q, k, v, causal=cfg.causal,
                                     window=cfg.sliding_window,
                                     q_chunk=cfg.attn_q_chunk,
                                     kv_chunk=cfg.attn_kv_chunk)
    raise ValueError(f"attn_impl must be 'cuda' or 'torch', got "
                     f"{cfg.attn_impl!r}")


def attn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor,
               kv: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Full-sequence (train / prefill) attention.  When ``kv`` is a dict,
    the projected k and v are left in it, so that a prefill fills its
    cache from this one projection (the JAX package projects twice; the
    values are the same)."""
    B, S, _ = x.shape
    q, k, v = qkv_project(p, cfg, x, positions)
    if kv is not None:
        kv["k"], kv["v"] = k, v
    out = attention(cfg, q, k, v).reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x.dtype)


def attn_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                pos: torch.Tensor, pos0: int) -> Tuple[torch.Tensor, Dict]:
    """One-token decode with KV cache (ring buffer when SWA).  ``pos0`` is
    ``int(pos[0])``, the slot every sequence of the static batch writes.
    The cache is updated in place (the JAX package returns new arrays and
    donates the old ones)."""
    B = x.shape[0]
    q, k, v = qkv_project(p, cfg, x, pos[:, None])
    W = cache["k"].shape[1]
    slot = pos0 % W if cfg.sliding_window else pos0
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cur = min(pos0 + 1, W)
    out = decode_attention(q, cache["k"], cache["v"], cur,
                           kv_chunk=cfg.decode_kv_chunk)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x.dtype), cache


def kv_cache_init(cfg: ModelConfig, batch: int, seq: int, dtype, device
                  ) -> Dict:
    W = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    shape = (batch, W, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    r = cfg.kv_lora_rank
    dt = torch_dtype(cfg.param_dtype)
    return {
        "w_q": dense_init(gen, d, H * (dn + dr), dt),
        "w_dkv": dense_init(gen, d, r + dr, dt),    # latent + shared rope key
        "w_uk": dense_init(gen, r, H * dn, dt),     # latent -> k_nope
        "w_uv": dense_init(gen, r, H * dv, dt),     # latent -> v
        "kv_norm": torch.ones(r, dtype=torch.float32, device=gen.device),
        "wo": dense_init(gen, H * dv, d, dt),
    }


def _mla_qc(p: Params, cfg: ModelConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """(q_nope, q_rope, c, k_rope): the queries split at ``qk_nope_dim``,
    the normed latent c (B, S, kv_lora_rank) and the shared rope key
    (B, S, qk_rope_dim)."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    r = cfg.kv_lora_rank
    q = (x @ p["w_q"].to(x.dtype)).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope_rotate(q_rope, positions, cfg.rope_theta)
    ckv = x @ p["w_dkv"].to(x.dtype)
    c, k_rope = ckv[..., :r], ckv[..., r:]
    c = rms_norm_head(c, p["kv_norm"], cfg.norm_eps)
    k_rope = rope_rotate(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c, k_rope[:, :, 0, :]


def mla_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor,
              lat: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Training/prefill MLA: expand the latent to per-head K/V, chunked
    attention.  When ``lat`` is a dict, the latent ``c`` and rope key
    ``kr`` are left in it, so that a prefill fills its cache from this one
    projection (the JAX package projects twice; the values are the
    same)."""
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    q_nope, q_rope, c, k_rope = _mla_qc(p, cfg, x, positions)
    if lat is not None:
        lat["c"], lat["kr"] = c, k_rope
    k_nope = (c @ p["w_uk"].to(x.dtype)).reshape(B, S, H, dn)
    v = (c @ p["w_uv"].to(x.dtype)).reshape(B, S, H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    out = flash_attention_torch(q, k, v, causal=cfg.causal,
                                q_chunk=cfg.attn_q_chunk,
                                kv_chunk=cfg.attn_kv_chunk)
    return out.reshape(B, S, H * dv) @ p["wo"].to(x.dtype)


def mla_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor, pos0: int) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-matmul latent decode: the cache stores (c, k_rope) only.
    Scores in f32 over the whole cache, positions past ``pos0`` masked.
    The cache is updated in place at slot ``pos0``."""
    B = x.shape[0]
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    r = cfg.kv_lora_rank
    q_nope, q_rope, c_new, kr_new = _mla_qc(p, cfg, x, pos[:, None])
    c_cache, kr_cache = cache["c"], cache["kr"]
    S = c_cache.shape[1]
    c_cache[:, pos0] = c_new[:, 0].to(c_cache.dtype)
    kr_cache[:, pos0] = kr_new[:, 0].to(kr_cache.dtype)
    w_uk = p["w_uk"].to(x.dtype).reshape(r, H, dn)
    # absorb: q_lat[b,h,r] = q_nope[b,h,dn] . w_uk[r,h,dn]
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    cf = c_cache.float()
    s = torch.einsum("bhr,bsr->bhs", q_lat.float(), cf)
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                         kr_cache.float())
    s = s * (1.0 / math.sqrt(dn + dr))
    valid = torch.arange(S, device=x.device) <= pos0
    s = torch.where(valid, s, float("-inf"))
    pr = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", pr, cf)
    w_uv = p["w_uv"].to(x.dtype).reshape(r, H, dv)
    out = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), w_uv)
    y = out.reshape(B, 1, H * dv) @ p["wo"].to(x.dtype)
    return y, {"c": c_cache, "kr": kr_cache}


def mla_cache_init(cfg: ModelConfig, batch: int, seq: int, dtype, device
                   ) -> Dict:
    return {"c": torch.zeros((batch, seq, cfg.kv_lora_rank), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, seq, cfg.qk_rope_dim), dtype=dtype,
                              device=device)}


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU / plain GELU)
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    p = {"w_up": dense_init(gen, d, ff, dt),
         "w_down": dense_init(gen, ff, d, dt)}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, d, ff, dt)
    return p


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"].to(x.dtype)
    if cfg.mlp_gated:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (fine-grained, shared + routed, top-k)
# ---------------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, fe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_routed_experts
    dt = torch_dtype(cfg.param_dtype)
    dev = gen.device

    def experts(din: int, dout: int) -> torch.Tensor:
        w = torch.randn((E, din, dout), generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * (1.0 / math.sqrt(din))).to(dt)

    router = torch.randn((d, E), generator=gen, device=dev,
                         dtype=torch.float32) * (1.0 / math.sqrt(d))
    p: Params = {"router": router,                 # f32, as the reference
                 "w_gate_e": experts(d, fe), "w_up_e": experts(d, fe),
                 "w_down_e": experts(fe, d)}
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=fe * cfg.n_shared_experts)
    return p


def top_k(probs: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis, in descending order, and
    their indices; equal values go to the lower index first, as
    ``lax.top_k`` (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, cfg: ModelConfig, x_flat: torch.Tensor):
    """Top-k routing with normalized weights + aux load-balance loss, in
    f32 (a bf16 router of a training step is widened, as the JAX
    package's f32 product widens it)."""
    logits = x_flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = top_k(probs, cfg.moe_top_k)                  # (T, k)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    E = cfg.n_routed_experts
    # aux: E * sum_e f_e * P_e  (Switch-style)
    f = F.one_hot(idx, E).sum(dim=1).float().mean(dim=0)
    pm = probs.mean(dim=0)
    aux = E * torch.sum(f * pm) * cfg.router_aux_coef
    return w.to(x_flat.dtype), idx, aux


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` routed tokens."""
    return max(1, int(math.ceil(n_tokens * cfg.moe_top_k
                                / cfg.n_routed_experts
                                * cfg.moe_capacity_factor)))


def dispatch_slots(idx: torch.Tensor, E: int, C: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, keep) of every (token, k) pair of ``idx`` (T, k), flattened
    token-major: a pair keeps slot ``e * C + n`` when it is the n-th pair
    (n < C) routed to expert e in that order; the others overflow to row
    ``E * C`` and are dropped."""
    flat_e = idx.reshape(-1)                                    # (T*k,)
    oh = F.one_hot(flat_e, E)                                   # (T*k, E)
    # position of each (token, k) within its expert's capacity buffer
    pos_in_e = torch.gather(torch.cumsum(oh, dim=0) - 1, 1,
                            flat_e[:, None])[:, 0]
    keep = pos_in_e < C
    slot = torch.where(keep, flat_e * C + pos_in_e,
                       torch.full_like(flat_e, E * C))          # overflow row
    return slot, keep


def _expert_ffn(recv: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """(E, C, d) -> (E, C, d) batched expert matmuls."""
    dt = recv.dtype
    h = F.silu(torch.bmm(recv, wg.to(dt))) * torch.bmm(recv, wu.to(dt))
    return torch.bmm(h, wd.to(dt))


def _dispatch_combine(p: Params, cfg: ModelConfig, x_flat: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based dispatch -> expert FFN -> combine, on one device
    (the JAX package's ``ep=1`` path)."""
    T, d = x_flat.shape
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    C = moe_capacity(cfg, T)
    w, idx, aux = _route(p, cfg, x_flat)
    slot, keep = dispatch_slots(idx, E, C)
    x_rep = torch.repeat_interleave(x_flat, k, dim=0)           # (T*k, d)
    send = x_flat.new_zeros((E * C + 1, d)).index_put((slot,), x_rep)
    out = _expert_ffn(send[:-1].reshape(E, C, d), p["w_gate_e"],
                      p["w_up_e"], p["w_down_e"])
    got = torch.cat([out.reshape(E * C, d), x_flat.new_zeros((1, d))])
    y = got[slot] * keep[:, None].to(x_flat.dtype)              # (T*k, d)
    y = (y.reshape(T, k, d) * w[..., None]).sum(dim=1)
    return y, aux


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed + shared experts: (y, aux)."""
    B, S, d = x.shape
    y, aux = _dispatch_combine(p, cfg, x.reshape(-1, d))
    y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], cfg, x)
    return y, aux
