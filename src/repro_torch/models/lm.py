"""Decoder-only language models of the dense, SSM and hybrid families, in
PyTorch.

The counterpart of the JAX package's ``models/lm.py`` for the block kinds
``"dense"``, ``"ssm"`` (mamba2: a norm and the SSD, no MLP) and
``"hybrid"`` (hymba: attention and the SSD side by side on the same
normed input, averaged, then the MLP).  The layer stack is a Python loop
over a list of per-layer parameter dicts (the JAX package scans stacked
leaves); ``layers[i]`` holds what ``layers[...][i]`` holds there.

Entry points:

  train_forward  -> logits + aux  (full sequence, causal)
  loss_fn        -> mean token cross-entropy + metrics (differentiable)
  prefill        -> last-position logits + per-layer decode caches
  decode_step    -> next-token ids + updated caches (one token)

With ``cfg.remat == "block"`` and autograd on, every block runs under
``torch.utils.checkpoint`` (the JAX package checkpoints its scan body), so
a backward pass recomputes each block's forward, kernels included.

MoE, MLA, encoder-decoder and VLM configurations are not ported yet
(``models.get_model`` refuses them).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from . import layers as L
from . import ssm as S

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    """kind: dense | ssm | hybrid."""
    dev = gen.device
    p: Params = {"ln1": L.norm_init(cfg.d_model, cfg, dev)}
    if kind != "ssm":
        p["attn"] = L.attn_init(gen, cfg)
        p["ln2"] = L.norm_init(cfg.d_model, cfg, dev)
        p["mlp"] = L.mlp_init(gen, cfg)
    if kind != "dense":
        p["ssm"] = S.ssd_init(gen, cfg)
    return p


def _mix(p: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, kind: str) -> torch.Tensor:
    """The token-mixing half of a block (attention / SSD / both)."""
    h = L.apply_norm(x, p["ln1"], cfg)
    if kind == "ssm":
        return S.ssd_apply(p["ssm"], cfg, h)
    out = L.attn_apply(p["attn"], cfg, h, positions)
    if kind == "hybrid":
        out = 0.5 * (out + S.ssd_apply(p["ssm"], cfg, h))
    return out


def block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, kind: str) -> torch.Tensor:
    x = x + _mix(p, cfg, x, positions, kind)
    if kind == "ssm":
        return x
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg))


def block_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kind: str
                  ) -> Tuple[torch.Tensor, Dict]:
    """Forward + this layer's decode cache.  k and v come from the one
    projection the attention makes (the JAX package projects a second time
    for the cache; the values are the same)."""
    h = L.apply_norm(x, p["ln1"], cfg)
    cache: Dict = {}
    if kind == "ssm":
        out, cache["ssm"] = S.ssd_apply(p["ssm"], cfg, h, with_cache=True)
        return x + out, cache
    Sq = h.shape[1]
    kv: Dict[str, torch.Tensor] = {}
    out = L.attn_apply(p["attn"], cfg, h, positions, kv=kv)
    k, v = kv["k"], kv["v"]
    W = min(Sq, cfg.sliding_window) if cfg.sliding_window else Sq
    if W < Sq:  # ring layout consistent with decode's slot = pos % W
        idx = (Sq - W + torch.arange(W, device=k.device)) % W
        cache["k"] = torch.zeros_like(k[:, Sq - W:])
        cache["v"] = torch.zeros_like(v[:, Sq - W:])
        cache["k"][:, idx] = k[:, Sq - W:]
        cache["v"][:, idx] = v[:, Sq - W:]
    else:
        cache["k"], cache["v"] = k, v
    if kind == "hybrid":
        s_out, cache["ssm"] = S.ssd_apply(p["ssm"], cfg, h, with_cache=True)
        out = 0.5 * (out + s_out)
    x = x + out
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg)), \
        cache


def block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                 pos: torch.Tensor, pos0: int, kind: str
                 ) -> Tuple[torch.Tensor, Dict]:
    h = L.apply_norm(x, p["ln1"], cfg)
    if kind == "ssm":
        out, ssm_cache = S.ssd_decode(p["ssm"], cfg, h, cache["ssm"])
        return x + out, {"ssm": ssm_cache}
    out, kv = L.attn_decode(p["attn"], cfg, h, cache, pos, pos0)
    new_cache = {"k": kv["k"], "v": kv["v"]}
    if kind == "hybrid":
        s_out, new_cache["ssm"] = S.ssd_decode(p["ssm"], cfg, h,
                                               cache["ssm"])
        out = 0.5 * (out + s_out)
    x = x + out
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg)), \
        new_cache


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def layer_kind(cfg: ModelConfig) -> str:
    """The block kind of every layer: ``"ssm"``, ``"hybrid"`` or
    ``"dense"`` (the JAX package's ``_layer_kinds``, ``lm.py:158``, without
    MoE's first dense layers)."""
    if cfg.family == "ssm":
        return "ssm"
    if cfg.hybrid:
        return "hybrid"
    return "dense"


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Parameters on ``gen.device`` with the JAX package's shapes, scales
    and dtypes (``lm.py:169-186``, ``ssm.py:34-54``); the random numbers
    differ."""
    dt = L.torch_dtype(cfg.param_dtype)
    V, d = cfg.padded_vocab, cfg.d_model
    dev = gen.device
    embed = torch.randn((V, d), generator=gen, device=dev,
                        dtype=torch.float32)
    p: Params = {"embed": (embed * 0.02).to(dt)}
    del embed
    p["final_norm"] = L.norm_init(d, cfg, dev)
    head = torch.randn((V, d), generator=gen, device=dev, dtype=torch.float32)
    p["lm_head"] = (head * (1.0 / d ** 0.5)).to(dt)
    del head
    kind = layer_kind(cfg)
    p["layers"] = [block_init(gen, cfg, kind) for _ in range(cfg.n_layers)]
    return p


def _tokens(device, tokens) -> torch.Tensor:
    """Token ids or labels (numpy array or tensor) as int64 on ``device``."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.as_tensor(tokens, dtype=torch.int64, device=device)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings and positions."""
    tok = _tokens(params["embed"].device, batch["tokens"])
    x = params["embed"][tok].to(L.torch_dtype(cfg.dtype))
    B, S = tok.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    return x, positions


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    kind = layer_kind(cfg)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x = checkpoint(block_apply, lp, cfg, x, positions, kind,
                           use_reentrant=False)
        else:
            x = block_apply(lp, cfg, x, positions, kind)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_f32(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,vd->bsv", x, lm_head)`` with the head in x's dtype
    and the result in f32, as the JAX package's
    ``preferred_element_type=f32``.  On the card a bf16 product writes f32
    directly (``torch.mm(..., out_dtype=)``) when no gradient is needed;
    otherwise, and on the CPU, both operands are upcast, which gives the
    same products (exact in f32)."""
    head = lm_head.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ head.t()
    # the out_dtype product is taken only where no gradient is needed
    if x.is_cuda and not (torch.is_grad_enabled()
                          and (x.requires_grad or head.requires_grad)):
        out = torch.mm(x.reshape(-1, x.shape[-1]), head.t(),
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], head.shape[0])
    return x.float() @ head.float().t()


def train_forward(cfg: ModelConfig, params: Params, batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. Returns (logits_f32, aux_loss)."""
    x, positions = _embed_inputs(cfg, params, batch)
    x, aux = _run_stack(cfg, params, x, positions)
    x = L.apply_norm(x, params["final_norm"], cfg)
    return logits_f32(x, params["lm_head"]), aux


def chunked_ce(cfg: ModelConfig, x: torch.Tensor, lm_head: torch.Tensor,
               labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing full-sequence logits (the JAX
    package's ``chunked_ce``, ``lm.py:242``).

    When ``cfg.loss_chunk`` divides a longer sequence, the chunks of
    ``loss_chunk`` positions are taken one after another, each under
    ``torch.utils.checkpoint``, so only one chunk's (B, C, V) f32 logits
    live at a time in backward too; otherwise the whole sequence is one
    chunk.  Positions whose label is negative are masked out.  Returns
    (nll_sum, token_count), both f32."""
    labels = _tokens(x.device, labels)
    S = x.shape[1]
    mask = labels >= 0
    labels = torch.clamp(labels, min=0)
    C = cfg.loss_chunk
    head = lm_head.to(x.dtype)
    maskf = mask.to(torch.float32)
    ntok = mask.sum().to(torch.float32)
    if not C or S <= C or S % C:
        return _ce(x, head, labels, maskf), ntok
    remat = torch.is_grad_enabled()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, C):
        args = (x[:, s0:s0 + C], head, labels[:, s0:s0 + C],
                maskf[:, s0:s0 + C])
        nll = nll + (checkpoint(_ce, *args, use_reentrant=False) if remat
                     else _ce(*args))
    return nll, ntok


def _ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
        maskf: torch.Tensor) -> torch.Tensor:
    """sum over positions of (logsumexp - gold logit) * mask, in f32."""
    logits = logits_f32(x, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((lse - gold) * maskf)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy over the unmasked labels (+ aux, 0 for the
    ported families); metrics ``nll``, ``aux`` and ``ntok``."""
    x, positions = _embed_inputs(cfg, params, batch)
    x, aux = _run_stack(cfg, params, x, positions)
    x = L.apply_norm(x, params["final_norm"], cfg)
    nll_sum, ntok = chunked_ce(cfg, x, params["lm_head"], batch["labels"])
    denom = torch.clamp(ntok, min=1.0)
    loss = nll_sum / denom + aux
    return loss, {"nll": nll_sum / denom, "aux": aux, "ntok": ntok}


# -- serving ----------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the full prompt; return last-position logits + caches."""
    x, positions = _embed_inputs(cfg, params, batch)
    kind = layer_kind(cfg)
    caches: List[Dict] = []
    for lp in params["layers"]:
        x, c = block_prefill(lp, cfg, x, positions, kind)
        caches.append(c)
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg)
    logits = logits_f32(x, params["lm_head"])
    B, S = positions.shape
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits[:, 0], {"layers": caches, "first": [], "pos": pos}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> Dict:
    """Zero decode caches for a max context of ``seq`` tokens."""
    dt = L.torch_dtype(cfg.dtype)
    kind = layer_kind(cfg)

    def one() -> Dict:
        if kind == "ssm":
            return {"ssm": S.ssd_cache_init(cfg, batch, dt, device)}
        c = L.kv_cache_init(cfg, batch, seq, dt, device)
        if kind == "hybrid":
            c["ssm"] = S.ssd_cache_init(cfg, batch, dt, device)
        return c

    return {"layers": [one() for _ in range(cfg.n_layers)],
            "first": [],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict, tokens
                ) -> Tuple[torch.Tensor, Dict]:
    """One greedy decode step. tokens: (B, 1) -> (next (B, 1) int32, cache).
    The KV caches are updated in place, the SSM caches are replaced; the
    caches are returned with ``pos`` advanced."""
    pos = cache["pos"]
    pos0 = int(pos[0])
    x = params["embed"][_tokens(params["embed"].device, tokens)].to(
        L.torch_dtype(cfg.dtype))
    kind = layer_kind(cfg)
    new_caches = []
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, c = block_decode(lp, cfg, x, lc, pos, pos0, kind)
        new_caches.append(c)
    x = L.apply_norm(x, params["final_norm"], cfg)
    logits = logits_f32(x, params["lm_head"])
    # mask vocab padding, then greedy
    logits[..., cfg.vocab_size:] = float("-inf")
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_tok, {"layers": new_caches, "first": [], "pos": pos + 1}
