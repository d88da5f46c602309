"""Plain reference of the two model families the benchmark runs, in f32.

``ssm`` is Mamba-2 (arXiv:2405.21060): per layer an RMSNorm, the input
projection to (z, x, B, C, dt), a causal depthwise convolution and SiLU
over (x, B, C), the SSD over chunks of Q tokens, the skip D x, the gated
per-head RMSNorm and the output projection, added to the residual.
``hybrid`` is Hymba (arXiv:2411.13676) as the port runs it: per layer
sliding-window GQA attention with RoPE and the same SSD side by side on
one normed input, averaged, then a SwiGLU MLP.  The head covers the
vocabulary padded to 256 rows, as the weights the benchmark hands over do.

Everything is f32 with TF32 off (:func:`strict_f32`).  ``fp8=True`` is the
control, the precision below the configuration's bf16: every activation
that the program keeps in bf16 between operations is rounded to float8
instead (e4m3, its gradient e5m2, one scale a tensor), and so are every
parameter and the operands of every linear layer's product.  Nothing
here imports the port.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, Any]


@contextlib.contextmanager
def strict_f32() -> Iterator[None]:
    """f32 products stay f32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to the format's largest, back in f32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8Round(torch.autograd.Function):
    """An activation stored in float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def act(t: torch.Tensor, fp8: bool) -> torch.Tensor:
    """An activation as the precision keeps it between operations: f32 as
    is, or rounded to float8 (the control)."""
    return _Fp8Round.apply(t) if fp8 else t


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return gq @ wq.t(), xq.t() @ gq


def linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """``x @ w`` over the last dim of x; w is (d_in, d_out).  In float8 the
    operands and the product are rounded (e4m3, gradients e5m2)."""
    w = w.float()
    if not fp8:
        return x @ w
    y = _Fp8Matmul.apply(x.reshape(-1, x.shape[-1]), w)
    return act(y.reshape(*x.shape[:-1], w.shape[1]), fp8)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def ssd(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dt: torch.Tensor,
        da: torch.Tensor, Q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state-space recurrence h_t = exp(da_t) h_{t-1} + dt_t b_t x_t,
    y_t = c_t . h_t, computed over chunks of Q: x (B, S, nh, hd); b, c
    (B, S, ns); dt, da (B, S, nh).  Returns y and the last state (B, nh,
    ns, hd)."""
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    nc = S // Q
    x = x.reshape(B, nc, Q, nh, hd)
    b = b.reshape(B, nc, Q, ns)
    c = c.reshape(B, nc, Q, ns)
    dt = dt.reshape(B, nc, Q, nh)
    cs = torch.cumsum(da.reshape(B, nc, Q, nh), dim=2)
    tot = cs[:, :, -1]                                      # (B, nc, nh)
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # q, p
    decay = torch.exp(torch.where(causal, seg, float("-inf")))
    w = (c @ b.transpose(-1, -2))[..., None] * decay * dt[:, :, None]
    y = torch.einsum("bcqph,bcphd->bcqhd", w, x)
    xs = (dt * torch.exp(tot[:, :, None] - cs))[..., None] * x
    states = torch.einsum("bcqs,bcqhd->bchsd", b, xs)
    h = torch.zeros(B, nh, ns, hd, dtype=x.dtype, device=x.device)
    entering = []
    for ci in range(nc):
        entering.append(h)
        h = torch.exp(tot[:, ci])[..., None, None] * h + states[:, ci]
    y = y + torch.einsum("bcqs,bchsd->bcqhd", c, torch.stack(entering, 1)) \
        * torch.exp(cs)[..., None]
    return y.reshape(B, S, nh, hd), h


def chunk_len(S: int, chunk: int) -> int:
    """The largest divisor of S up to ``chunk`` (any chunking gives the
    same function; this one keeps the reference's chunks whole)."""
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    return Q


def ssm_mixer(p: Params, m: Dict[str, Any], h: torch.Tensor, fp8: bool
              ) -> torch.Tensor:
    B, S, _ = h.shape
    di = m["ssm_expand"] * m["d_model"]
    ns, hd, W = m["ssm_state"], m["ssm_head_dim"], m["conv_width"]
    nh = di // hd
    proj = linear(h, p["in_proj"], fp8)
    z, xbc, dt_raw = (proj[..., :di], proj[..., di:2 * di + 2 * ns],
                      proj[..., 2 * di + 2 * ns:])
    conv_w = p["conv_w"].float()
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (W - 1, 0)),
                   conv_w.t()[:, None, :], p["conv_b"].float(),
                   groups=xbc.shape[-1]).transpose(1, 2)
    xbc = act(F.silu(xbc), fp8)
    xs = xbc[..., :di].reshape(B, S, nh, hd)
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    da = dt * -torch.exp(p["A_log"].float())
    y, _ = ssd(xs, xbc[..., di:di + ns], xbc[..., di + ns:], dt, da,
               chunk_len(S, m["ssm_chunk"]))
    y = act(y, fp8) + xs * p["D"].float()[:, None]
    y = act(rms_norm(y * F.silu(z.reshape(B, S, nh, hd)), p["gate_norm"],
                     m["norm_eps"]), fp8)
    return linear(y.reshape(B, S, di), p["out_proj"], fp8)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the whole head dim, halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** -(torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int, block: int = 512) -> torch.Tensor:
    """Causal softmax attention over the last ``window`` keys (0: all),
    queries in blocks: q (B, S, H, hd), k and v (B, S, KV, hd)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    pos = torch.arange(S, device=q.device)
    out = []
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        k0 = max(0, q0 - window + 1) if window else 0
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, k0:q1]) \
            / math.sqrt(hd)
        qp, kp = pos[q0:q1, None], pos[None, k0:q1]
        keep = kp <= qp
        if window:
            keep = keep & (kp > qp - window)
        s = s.masked_fill(~keep, float("-inf"))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                v[:, k0:q1]))
    return torch.cat(out, dim=1)


def attention_mixer(p: Params, m: Dict[str, Any], h: torch.Tensor,
                    fp8: bool) -> torch.Tensor:
    B, S, _ = h.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope(linear(h, p["wq"], fp8).reshape(B, S, H, hd), m["rope_theta"])
    k = rope(linear(h, p["wk"], fp8).reshape(B, S, KV, hd), m["rope_theta"])
    v = linear(h, p["wv"], fp8).reshape(B, S, KV, hd)
    o = act(window_attention(q, k, v, m.get("sliding_window", 0)), fp8)
    return linear(o.reshape(B, S, H * hd), p["wo"], fp8)


def block(p: Params, m: Dict[str, Any], x: torch.Tensor, fp8: bool
          ) -> torch.Tensor:
    h = act(rms_norm(x, p["ln1"]["scale"], m["norm_eps"]), fp8)
    if m["family"] == "ssm":
        return act(x + ssm_mixer(p["ssm"], m, h, fp8), fp8)
    x = act(x + 0.5 * (attention_mixer(p["attn"], m, h, fp8)
                       + ssm_mixer(p["ssm"], m, h, fp8)), fp8)
    h = act(rms_norm(x, p["ln2"]["scale"], m["norm_eps"]), fp8)
    mp = p["mlp"]
    up = linear(h, mp["w_up"], fp8)
    gate = linear(h, mp["w_gate"], fp8)
    return act(x + linear(act(F.silu(gate) * up, fp8), mp["w_down"], fp8),
               fp8)


def _rounded(tree: Any) -> Any:
    """Every parameter as the control holds it: in float8, one scale a
    leaf (the gradient passes to the f32 leaf, rounded to e5m2)."""
    if isinstance(tree, dict):
        return {k: _rounded(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rounded(v) for v in tree]
    return _Fp8Round.apply(tree.float())


def hidden(params: Params, m: Dict[str, Any], tokens: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, S, d).  With autograd on, every
    layer is recomputed in the backward pass (only its input is kept)."""
    x = act(params["embed"][tokens].float(), fp8)
    remat = torch.is_grad_enabled()
    for lp in params["layers"]:
        x = checkpoint(block, lp, m, x, fp8, use_reentrant=False) if remat \
            else block(lp, m, x, fp8)
    return rms_norm(x, params["final_norm"]["scale"], m["norm_eps"])


def _nll(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
         fp8: bool) -> torch.Tensor:
    logits = linear(x, head.t(), fp8)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None])[..., 0]).sum()


def loss(params: Params, m: Dict[str, Any], tokens: torch.Tensor,
         labels: torch.Tensor, fp8: bool = False, chunk: int = 1024
         ) -> torch.Tensor:
    """Mean next-token cross-entropy over the padded vocabulary."""
    if fp8:
        params = _rounded(params)
    x = hidden(params, m, tokens, fp8)
    nll = torch.zeros((), device=x.device)
    for s0 in range(0, x.shape[1], chunk):
        nll = nll + checkpoint(_nll, x[:, s0:s0 + chunk], params["lm_head"],
                               labels[:, s0:s0 + chunk], fp8,
                               use_reentrant=False)
    return nll / labels.numel()


@torch.no_grad()
def last_logits(params: Params, m: Dict[str, Any], tokens: torch.Tensor,
                fp8: bool = False) -> torch.Tensor:
    """Logits (B, padded vocab) after the last prompt token."""
    if fp8:
        params = _rounded(params)
    x = hidden(params, m, tokens, fp8)[:, -1]
    return linear(x, params["lm_head"].t(), fp8)
