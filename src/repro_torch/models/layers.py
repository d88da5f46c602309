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
package runs them in XLA.

Sharding is expressed through logical constraints (``distributed.shard``),
at the JAX package's places:
  batch  -> ("pod","data")    activations' leading batch dim
  heads  -> "model"           when n_heads % tp == 0 (TP attention)
  seq    -> "model"           otherwise (sequence/context parallelism)
  ff/kv  -> "model"           MLP hidden, KV-cache heads
Outside a mesh (and on plain tensors) every constraint is an identity and
the code above runs as it did.  Under a mesh the tensors are DTensors, and
each kernel (flash attention, RMSNorm, the SSD scan) runs on every rank's
shard through ``local_map``: attention per local head group, which is
exact.  Where the heads do not divide the model axis (llava 56 heads,
hymba 25) the reference shards the queries' sequence; the kernel has no
query offset, so the port gathers the queries and every model rank
computes the whole attention of its batch shard (the output is then cut
to the rank's sequence shard by the next constraint).  MoE layers run
expert parallel (two all-to-alls over "model") when the sequence divides
the model axis, else every rank gathers the tokens, routes them all and
runs its share of the experts, which stay sharded over "model", on their
slots; the parts are summed over "model" (decode).  The dry run names
the cells whose numbers include either gather
(``launch.dryrun.layout_departures``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (axis_size, batch_placements,
                                    current_mesh_axes, is_dtensor,
                                    local_run, placements_of, replicated,
                                    shard)
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
    summed in f32, the product taken in ``x.dtype``.  On a DTensor the norm
    runs on the rank's (batch, sequence) shard and its output gathers the
    sequence (Megatron-SP: the gather precedes the tensor-parallel
    projections, which then see whole rows)."""
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
    return shard(y, "batch", None, None) if is_dtensor(y) else y


def rms_norm_head(x: torch.Tensor, scale: torch.Tensor, eps: float
                  ) -> torch.Tensor:
    """Per-head RMS norm over the last dim (qwen3 qk_norm): the RMSNorm
    kernel's function, f32 statistics and one cast at the end.  A training
    step may hand over a bf16 ``scale`` (``launch.steps.cast_params``); it
    is widened to f32, as the JAX package's f32 product widens it.  On a
    DTensor the kernel runs on every rank's rows (the normed dim whole)."""
    def norm(xl, sl):
        return _grad.apply(rmsnorm_ops.rmsnorm_op, rmsnorm_ref,
                           xl.contiguous(), sl.float(), eps=eps)
    if is_dtensor(x):
        pl = kernel_placements(x, keep=(x.dim() - 1,))
        return local_run(norm, (x, scale), (pl, replicated(x.device_mesh)),
                         pl, x.device_mesh)
    return norm(x, scale)


def kernel_placements(x, keep=(), replicate_axes=()) -> list:
    """Placements under which a kernel can run on ``x``'s local shards:
    its own, with a partial sum reduced, the dims in ``keep`` whole, and
    the mesh dims named in ``replicate_axes`` replicated."""
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names
    out = []
    for name, p in zip(names, x.placements):
        if p.is_partial() or name in replicate_axes or (
                isinstance(p, Shard) and p.dim % x.dim() in keep):
            p = Replicate()
        out.append(p)
    return out


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


@torch.library.custom_op("repro_torch::chunked_attention", mutates_args=())
def chunked_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int, q_chunk: int,
                         kv_chunk: int) -> torch.Tensor:
    """:func:`flash_attention_torch` as one operator, the model's path to
    it: a sharded model calls it on each rank's heads, and under
    ``FakeTensorMode`` (the dry run) its fake version gives the shape
    without walking the chunks."""
    return flash_attention_torch(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)


@chunked_attention_op.register_fake
def _(q, k, v, causal, window, q_chunk, kv_chunk):
    return q.new_empty(q.shape[:3] + v.shape[3:])


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """:func:`flash_attention_torch` through its operator (the gradient
    recomputes the plain function)."""
    return _grad.apply(chunked_attention_op, flash_attention_torch, q, k, v,
                       causal=causal, window=int(window), q_chunk=q_chunk,
                       kv_chunk=kv_chunk)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len: int, *,
                     kv_chunk: int = 2048) -> torch.Tensor:
    """Single-token attention over a (possibly ring) KV cache.

    q: (B, 1, H, Dq); caches: (B, S, KVH, D*); cur_len: count of valid
    entries (ring caches pass W once full).  Chunked online-softmax over
    the sequence, as the JAX package's ``decode_attention``.  On DTensor
    caches every rank attends over its shard: a head-sharded cache with
    its heads' queries, a sequence-sharded one with all queries and the
    partial softmax statistics combined across the shards
    (flash-decoding)."""
    if is_dtensor(k_cache):
        return _sharded_decode_attention(q, k_cache, v_cache, cur_len,
                                         kv_chunk)
    B, _, H, _ = q.shape
    m, l, acc = _decode_partial(q, k_cache, v_cache, cur_len, kv_chunk)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def _decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cur_len: int, kv_chunk: int):
    """The online-softmax state (m, l, acc) of ``q`` over the first
    ``cur_len`` entries of the caches."""
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
    return m, l, acc


def seq_shard_offset(t, dim: int = 1) -> Tuple[Optional[str], int]:
    """(the mesh axis that shards dim ``dim`` of DTensor ``t`` or None,
    the global index of this rank's first entry along it)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    n, lo, axis = t.shape[dim], 0, None
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n = -(-n // mesh.size(i))
            lo = lo * mesh.size(i) + mesh.get_local_rank(names[i])
            axis = names[i]
    return axis, lo * n


def _sharded_decode_attention(q, k_cache, v_cache, cur_len: int,
                              kv_chunk: int):
    from torch.distributed.tensor import Replicate, Shard
    from ..distributed.sharding import all_reduce
    mesh = k_cache.device_mesh
    axis, lo = seq_shard_offset(k_cache)
    c_pl = kernel_placements(k_cache, keep=(3,))
    q_pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
            for p in c_pl]
    Dv = v_cache.shape[-1]

    def local(ql, kl, vl):
        m, l, acc = _decode_partial(ql, kl, vl, cur_len - lo, kv_chunk)
        if axis is not None:
            group = mesh.get_group(axis)
            mg = all_reduce(m, "max", group)
            mg = torch.where(torch.isfinite(mg), mg, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - mg), 0.0)
            l = all_reduce(l * corr, "sum", group)
            acc = all_reduce(acc * corr[..., None], "sum", group)
        out = acc / torch.clamp(l[..., None], min=1e-30)
        return out.reshape(ql.shape[0], 1, ql.shape[2], Dv).to(ql.dtype)

    return local_run(local, (q, k_cache, v_cache), (q_pl, c_pl, c_pl),
                     q_pl, mesh)


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
    q = split_heads(q, cfg.n_heads, hd)
    k = split_heads(k, cfg.n_kv_heads, hd)
    v = split_heads(v, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_head(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_head(k, p["k_norm"], cfg.norm_eps)
    q = rope_rotate(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope_rotate(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def split_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd).  A DTensor whose feature
    dim is sharded over more ranks than divide ``heads`` gathers it first
    (a view cannot split a head across ranks)."""
    B, S = t.shape[:2]
    if is_dtensor(t):
        from torch.distributed.tensor import Shard
        n = 1
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == 2:
                n *= t.device_mesh.size(i)
        if heads % n:
            t = shard(t, "batch", None, None)
    return t.reshape(B, S, heads, hd)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd).  On a DTensor the merge runs on the
    local shards, so that the gradient, which a following row-parallel
    product hands back sharded on the merged dim, is laid out as ``t``
    before it is split into heads again."""
    if is_dtensor(t):
        pl = kernel_placements(t)
        return local_run(lambda x: x.flatten(2), (t,), (pl,), pl,
                         t.device_mesh)
    return t.reshape(*t.shape[:2], -1)


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention on the path ``cfg.attn_impl`` selects; on
    DTensors, on every rank's local heads (:func:`sharded_attention`)."""
    if is_dtensor(q):
        return sharded_attention(
            lambda ql, kl, vl: _attention_local(cfg, ql, kl, vl), q, k, v)
    return _attention_local(cfg, q, k, v)


def sharded_attention(fn, q, k, v):
    """``fn(q, k, v)`` (B, S, H, hd) on the local shards: batch and heads
    stay as the constraints left them, the sequence whole (the queries of
    a sequence-sharded layout are gathered; see the module docstring)."""
    mesh = q.device_mesh
    pl = kernel_placements(q, keep=(1, 3))
    kv_pl = kernel_placements(k, keep=(1, 3))
    return local_run(fn, (q, k, v), (pl, kv_pl, kv_pl), pl, mesh)


def _attention_local(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """:func:`attention` on plain tensors (inside a mesh, a rank's
    shard)."""
    if cfg.attn_impl == "cuda":
        return _grad.apply(flash_ops.flash_attention_op, flash_attention_ref,
                           q, k, v, causal=cfg.causal,
                           window=int(cfg.sliding_window))
    if cfg.attn_impl == "torch":
        return chunked_attention(q, k, v, causal=cfg.causal,
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
    q, k, v = _shard_qkv(cfg, q, k, v)
    out = merge_heads(attention(cfg, q, k, v))
    return shard(out @ p["wo"].to(x.dtype), "batch", None, None)


def _tp_heads(cfg: ModelConfig) -> bool:
    """Shard attention by heads when divisible by the tp extent; otherwise
    fall back to sequence sharding (llava 56H, hymba 25H)."""
    tp = axis_size("tp")
    return tp > 1 and cfg.n_heads % tp == 0


def _shard_qkv(cfg: ModelConfig, q, k, v):
    """Pick an attention sharding that divides cleanly (the JAX package's
    ``layers.py:289-316``).

    * heads divisible by tp and kv-heads divisible -> classic TP attention;
    * heads divisible but kv-heads NOT (qwen3 kv=8, chatglm kv=2 on tp=16):
      broadcast KV to full heads first, so each rank holds whole groups;
    * heads not divisible (llava 56H, hymba 25H) -> sequence sharding.
    Outside a mesh every branch is an identity."""
    if not current_mesh_axes():
        return q, k, v
    tp = axis_size("tp")
    kvh = k.shape[2]
    if _tp_heads(cfg):
        q = shard(q, "batch", None, "tp", None)
        if kvh % tp != 0 and q.shape[2] % kvh == 0:
            g = q.shape[2] // kvh
            k = torch.repeat_interleave(k, g, dim=2)
            v = torch.repeat_interleave(v, g, dim=2)
        k = shard(k, "batch", None, "tp", None)
        v = shard(v, "batch", None, "tp", None)
    else:     # sequence sharding over the model axis
        q = shard(q, "batch", "seq", None, None)
        k = shard(k, "batch", None, None, None)
        v = shard(v, "batch", None, None, None)
    return q, k, v


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
    write_slot(cache["k"], k, slot)
    write_slot(cache["v"], v, slot)
    cur = min(pos0 + 1, W)
    out = decode_attention(q, cache["k"], cache["v"], cur,
                           kv_chunk=cfg.decode_kv_chunk)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x.dtype), cache


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache[:, slot] = new[:, 0]`` in place.  On a DTensor cache the
    rank whose sequence shard holds ``slot`` writes it into its local
    shard (the new entry laid out as the cache, its length-1 sequence dim
    replicated)."""
    if not is_dtensor(cache):
        cache[:, slot] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in cache.placements]
    new = new.to(cache.dtype)
    if not is_dtensor(new):
        from torch.distributed.tensor import DTensor
        new = DTensor.from_local(new, mesh, replicated(mesh),
                                 run_check=False)
    new = new.redistribute(mesh, pl).to_local()
    loc = cache.to_local()
    _, lo = seq_shard_offset(cache)
    if lo <= slot < lo + loc.shape[1]:
        loc[:, slot - lo] = new[:, 0]


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
    q = split_heads(x @ p["w_q"].to(x.dtype), H, dn + dr)
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
    k_nope = split_heads(c @ p["w_uk"].to(x.dtype), H, dn)
    v = split_heads(c @ p["w_uv"].to(x.dtype), H, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    q = shard(q, "batch", None, "tp", None)
    k = shard(k, "batch", None, "tp", None)
    v = shard(v, "batch", None, "tp", None)

    def attend(qq, kk, vv):
        return chunked_attention(qq, kk, vv, causal=cfg.causal,
                                 q_chunk=cfg.attn_q_chunk,
                                 kv_chunk=cfg.attn_kv_chunk)
    out = sharded_attention(attend, q, k, v) if is_dtensor(q) \
        else attend(q, k, v)
    return shard(merge_heads(out) @ p["wo"].to(x.dtype), "batch", None,
                 None)


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
    write_slot(c_cache, c_new, pos0)
    write_slot(kr_cache, kr_new, pos0)
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
    up = shard(x @ p["w_up"].to(x.dtype), "batch", None, "tp")
    if cfg.mlp_gated:
        gate = shard(x @ p["w_gate"].to(x.dtype), "batch", None, "tp")
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return shard(h @ p["w_down"].to(x.dtype), "batch", None, None)


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


def _dispatch_combine(p: Params, cfg: ModelConfig, x_flat: torch.Tensor,
                      ep: int = 1, group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route, then :func:`_expert_combine`: (y, aux)."""
    w, idx, aux = _route(p, cfg, x_flat)
    return _expert_combine(p, cfg, x_flat, w, idx, ep, group), aux


def _expert_combine(p: Params, cfg: ModelConfig, x_flat: torch.Tensor,
                    w: torch.Tensor, idx: torch.Tensor, ep: int = 1,
                    group=None, first: int = 0) -> torch.Tensor:
    """Capacity-based dispatch -> expert FFN -> combine of routed tokens:
    on one device (the JAX package's ``ep=1`` path), or, with ``group``
    (the model axis of ``ep`` ranks, each holding E/ep experts), expert
    parallel on each rank's tokens: an all-to-all sends every expert's
    slots to the rank that holds it and another brings the outputs back
    (the JAX package's two ``lax.all_to_all`` calls,
    ``layers.py:580,587``).  Without ``group``, ``p``'s experts are
    experts [first, first + E_loc) of the E: a rank of a mesh without
    expert parallelism runs its own on every token's slots, and y is its
    part of the sum over experts."""
    T, d = x_flat.shape
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    C = moe_capacity(cfg, T)
    slot, keep = dispatch_slots(idx, E, C)
    x_rep = torch.repeat_interleave(x_flat, k, dim=0)           # (T*k, d)
    send = x_flat.new_zeros((E * C + 1, d)).index_put((slot,), x_rep)
    send = send[:-1].reshape(E, C, d)
    El = p["w_gate_e"].shape[0]
    if group is not None and ep > 1:
        from torch.distributed._functional_collectives import \
            all_to_all_single_autograd as a2a
        recv = a2a(send.contiguous(), None, None, group)  # (ep, El, C, d)
        recv = recv.reshape(ep, El, C, d).transpose(0, 1) \
            .reshape(El, ep * C, d)
    else:
        recv = send[first:first + El]
    out = _expert_ffn(recv, p["w_gate_e"], p["w_up_e"], p["w_down_e"])
    if group is not None and ep > 1:
        out = out.reshape(El, ep, C, d).transpose(0, 1).contiguous()
        out = a2a(out, None, None, group).reshape(E, C, d)
    elif El < E:
        out = torch.cat([out.new_zeros((first, C, d)), out,
                         out.new_zeros((E - first - El, C, d))])
    got = torch.cat([out.reshape(E * C, d), x_flat.new_zeros((1, d))])
    y = got[slot] * keep[:, None].to(x_flat.dtype)              # (T*k, d)
    return (y.reshape(T, k, d) * w[..., None]).sum(dim=1)


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed + shared experts: (y, aux).  Under a mesh with a model axis
    of ep > 1 ranks that divides S and the experts, expert parallel on
    each rank's block of (batch shard, sequence shard) tokens, aux
    averaged over the blocks as the JAX package's ``pmean`` does (a
    nonlinear function of the per-block routing statistics, so it differs
    from the global aux); otherwise the local dispatch (same math), under
    a mesh on all tokens with the experts kept sharded over the model
    axis."""
    B, S, d = x.shape
    if is_dtensor(x):
        y, aux = _moe_sharded(p, cfg, x)
    else:
        y, aux = _dispatch_combine(p, cfg, x.reshape(-1, d))
        y = y.reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], cfg, x)
    return shard(y, "batch", None, None), aux


def _moe_sharded(p: Params, cfg: ModelConfig, x
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    B, S, d = x.shape
    ep = axis_size("tp")
    keys = ("router", "w_gate_e", "w_up_e", "w_down_e")
    rep = replicated(mesh)
    if "model" in names and ep > 1 and S % ep == 0 \
            and cfg.n_routed_experts % ep == 0:
        # blocks of tokens: the batch as x has it, the sequence over model
        x_pl = [Shard(1) if n == "model" else p for n, p in
                zip(names, batch_placements(x, mesh))]
        e_pl = placements_of(("model", None, None), 3, mesh)
        blocks = [p if p == Replicate() else Shard(0) for p in x_pl]
        group = mesh.get_group("model")

        def blk(xb, router, wg, wu, wd):
            pb = dict(zip(keys, (router, wg, wu, wd)))
            y, aux = _dispatch_combine(pb, cfg, xb.reshape(-1, d), ep,
                                       group)
            return y.reshape(xb.shape), aux.reshape(1)

        y, aux = local_run(blk, (x,) + tuple(p[k] for k in keys),
                           (x_pl, rep, e_pl, e_pl, e_pl), (x_pl, blocks),
                           mesh)
        return y, aux.mean()

    # all tokens routed on every rank; each runs its experts on their
    # slots, and y is the sum of the ranks' parts over the model axis
    x = x.redistribute(mesh, rep)
    w, idx, aux = local_run(
        lambda xl, router: _route({"router": router}, cfg,
                                  xl.reshape(-1, d)),
        (x, p["router"]), (rep, rep), (rep, rep, rep), mesh)
    e_pl = placements_of(("model", None, None), 3, mesh)
    first = 0
    if "model" in names:
        E = cfg.n_routed_experts
        first = min(mesh.get_local_rank("model") * -(-E // ep), E)

    def part(xl, wl, il, wg, wu, wd):
        pb = {"w_gate_e": wg, "w_up_e": wu, "w_down_e": wd}
        return _expert_combine(pb, cfg, xl.reshape(-1, d), wl, il,
                               first=first).reshape(xl.shape)

    y_pl = [Partial() if n == "model" else Replicate() for n in names]
    return local_run(part, (x, w, idx) + tuple(p[k] for k in keys[1:]),
                     (rep, rep, rep, e_pl, e_pl, e_pl), y_pl, mesh), aux
