"""Decoder-only language models of the dense family, in PyTorch.

The counterpart of the JAX package's ``models/lm.py`` for ``kind ==
"dense"``.  The layer stack is a Python loop over a list of per-layer
parameter dicts (the JAX package scans stacked leaves); ``layers[i]``
holds what ``layers[...][i]`` holds there.

Entry points:

  train_forward  -> logits + aux  (full sequence, causal; forward only)
  prefill        -> last-position logits + per-layer decode caches
  decode_step    -> next-token ids + updated caches (one token)

MoE, MLA, SSM, hybrid, encoder-decoder and VLM configurations are not
ported yet (``models.get_model`` refuses them).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from .config import ModelConfig
from . import layers as L

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {"ln1": L.norm_init(cfg.d_model, cfg, dev),
            "attn": L.attn_init(gen, cfg),
            "ln2": L.norm_init(cfg.d_model, cfg, dev),
            "mlp": L.mlp_init(gen, cfg)}


def block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    x = x + L.attn_apply(p["attn"], cfg, L.apply_norm(x, p["ln1"], cfg),
                         positions)
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg))


def block_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Forward + this layer's decode cache.  k and v come from the one
    projection the attention makes (the JAX package projects a second time
    for the cache; the values are the same)."""
    h = L.apply_norm(x, p["ln1"], cfg)
    Sq = h.shape[1]
    kv: Dict[str, torch.Tensor] = {}
    out = L.attn_apply(p["attn"], cfg, h, positions, kv=kv)
    k, v = kv["k"], kv["v"]
    W = min(Sq, cfg.sliding_window) if cfg.sliding_window else Sq
    if W < Sq:  # ring layout consistent with decode's slot = pos % W
        idx = (Sq - W + torch.arange(W, device=k.device)) % W
        cache = {"k": torch.zeros_like(k[:, Sq - W:]),
                 "v": torch.zeros_like(v[:, Sq - W:])}
        cache["k"][:, idx] = k[:, Sq - W:]
        cache["v"][:, idx] = v[:, Sq - W:]
    else:
        cache = {"k": k, "v": v}
    x = x + out
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg)), \
        cache


def block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                 pos: torch.Tensor, pos0: int) -> Tuple[torch.Tensor, Dict]:
    h = L.apply_norm(x, p["ln1"], cfg)
    out, cache = L.attn_decode(p["attn"], cfg, h, cache, pos, pos0)
    x = x + out
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg)), \
        cache


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Parameters on ``gen.device`` with the JAX package's shapes, scales
    and dtypes (``lm.py:169-186``); the random numbers differ."""
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
    p["layers"] = [block_init(gen, cfg) for _ in range(cfg.n_layers)]
    return p


def _tokens(params: Params, tokens) -> torch.Tensor:
    """Token ids (numpy array or tensor) as int64 on the params' device."""
    dev = params["embed"].device
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=dev, dtype=torch.int64)
    return torch.as_tensor(tokens, dtype=torch.int64, device=dev)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token embeddings and positions."""
    tok = _tokens(params, batch["tokens"])
    x = params["embed"][tok].to(L.torch_dtype(cfg.dtype))
    B, S = tok.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    return x, positions


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    for lp in params["layers"]:
        x = block_apply(lp, cfg, x, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def logits_f32(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,vd->bsv", x, lm_head)`` with the head in x's dtype
    and the result in f32, as the JAX package's
    ``preferred_element_type=f32``.  On the card a bf16 product writes f32
    directly (``torch.mm(..., out_dtype=)``); on the CPU both operands are
    upcast, which gives the same products (exact in f32)."""
    head = lm_head.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ head.t()
    if x.is_cuda:
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


# -- serving ----------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the full prompt; return last-position logits + caches."""
    x, positions = _embed_inputs(cfg, params, batch)
    caches: List[Dict] = []
    for lp in params["layers"]:
        x, c = block_prefill(lp, cfg, x, positions)
        caches.append(c)
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg)
    logits = logits_f32(x, params["lm_head"])
    B, S = positions.shape
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits[:, 0], {"layers": caches, "first": [], "pos": pos}


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> Dict:
    """Zero decode caches for a max context of ``seq`` tokens."""
    dt = L.torch_dtype(cfg.dtype)
    return {"layers": [L.kv_cache_init(cfg, batch, seq, dt, device)
                       for _ in range(cfg.n_layers)],
            "first": [],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict, tokens
                ) -> Tuple[torch.Tensor, Dict]:
    """One greedy decode step. tokens: (B, 1) -> (next (B, 1) int32, cache).
    The caches are updated in place and returned with ``pos`` advanced."""
    pos = cache["pos"]
    pos0 = int(pos[0])
    x = params["embed"][_tokens(params, tokens)].to(L.torch_dtype(cfg.dtype))
    new_caches = []
    for lp, lc in zip(params["layers"], cache["layers"]):
        x, c = block_decode(lp, cfg, x, lc, pos, pos0)
        new_caches.append(c)
    x = L.apply_norm(x, params["final_norm"], cfg)
    logits = logits_f32(x, params["lm_head"])
    # mask vocab padding, then greedy
    logits[..., cfg.vocab_size:] = float("-inf")
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return next_tok, {"layers": new_caches, "first": [], "pos": pos + 1}
