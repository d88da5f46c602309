"""Encoder-decoder backbone (seamless-m4t-large-v2) in PyTorch.

The counterpart of the JAX package's ``models/encdec.py``.  The speech
frontend (fbank + conv subsampling) is a stub, as there: ``frames`` enter
as precomputed (B, S_enc, d_model) embeddings.  The encoder is a
bidirectional transformer; the decoder adds causal self-attention plus
cross-attention over the encoder output.

Parameters are per-layer lists, ``params["enc_layers"][i]`` and
``params["dec_layers"][i]``, where the JAX package stacks the leaves along
a leading layer axis (``models.convert`` carries one layout to the other).

Both self-attentions take the path ``cfg.attn_impl`` selects
(``layers.attention``): on ``"cuda"`` the encoder runs the flash kernel
without a causal mask, the decoder with one.  Cross attention always takes
the plain ``flash_attention_torch``, as the JAX package calls
``flash_attention_xla`` there whatever ``attn_impl`` says
(``encdec.py:52``).

Decode caches: per-layer self-attention KV (not a ring) plus the
cross-attention K/V computed once from the encoder output at prefill, and
``xlen``, the encoder length, (B,) int32.  A decode step attends to the
first ``xlen`` cross positions only.  The JAX package passes the cache's
whole length (``encdec.py:106-108``), which its serving engine sizes at
``max_seq``, so where the encoder is shorter its decode also weighs the
zero keys behind the encoder's; the two agree where ``S_enc == max_seq``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import shard
from .config import ModelConfig
from . import layers as L
from .lm import chunked_ce, embed, logits_f32, mask_padding

Params = Dict[str, Any]


# -- cross attention ---------------------------------------------------------


def cross_attn_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.hd
    dt = L.torch_dtype(cfg.param_dtype)
    return {"wq": L.dense_init(gen, d, cfg.n_heads * hd, dt),
            "wk": L.dense_init(gen, d, cfg.n_heads * hd, dt),
            "wv": L.dense_init(gen, d, cfg.n_heads * hd, dt),
            "wo": L.dense_init(gen, cfg.n_heads * hd, d, dt)}


def cross_kv(p: Params, cfg: ModelConfig, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, Se, _ = enc_out.shape
    k = L.split_heads(enc_out @ p["wk"].to(enc_out.dtype), cfg.n_heads,
                      cfg.hd)
    v = L.split_heads(enc_out @ p["wv"].to(enc_out.dtype), cfg.n_heads,
                      cfg.hd)
    return k, v


def cross_attn_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, Sq, _ = x.shape
    q = L.split_heads(x @ p["wq"].to(x.dtype), cfg.n_heads, cfg.hd)
    q, k, v = L._shard_qkv(cfg, q, k, v)

    def attend(qq, kk, vv):
        return L.chunked_attention(qq, kk, vv, causal=False,
                                   q_chunk=cfg.attn_q_chunk,
                                   kv_chunk=cfg.attn_kv_chunk)
    out = L.sharded_attention(attend, q, k, v) if L.is_dtensor(q) \
        else attend(q, k, v)
    return shard(L.merge_heads(out) @ p["wo"].to(x.dtype), "batch", None,
                 None)


# -- blocks -------------------------------------------------------------------


def enc_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {"ln1": L.norm_init(cfg.d_model, cfg, dev),
            "attn": L.attn_init(gen, cfg),
            "ln2": L.norm_init(cfg.d_model, cfg, dev),
            "mlp": L.mlp_init(gen, cfg)}


def dec_block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {"ln1": L.norm_init(cfg.d_model, cfg, dev),
            "attn": L.attn_init(gen, cfg),
            "lnx": L.norm_init(cfg.d_model, cfg, dev),
            "xattn": cross_attn_init(gen, cfg),
            "ln2": L.norm_init(cfg.d_model, cfg, dev),
            "mlp": L.mlp_init(gen, cfg)}


def enc_block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    bicfg = cfg.replace(causal=False)
    x = x + L.attn_apply(p["attn"], bicfg, L.apply_norm(x, p["ln1"], cfg),
                         positions)
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg))


def dec_block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, enc_out: torch.Tensor,
                    proj: Optional[Dict[str, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """One decoder block over the full target sequence.  When ``proj`` is
    a dict, the self-attention's k and v and the cross K/V are left in it
    (a prefill's cache, projected once; the JAX package projects each a
    second time for the cache, ``encdec.py:202-205``)."""
    x = x + L.attn_apply(p["attn"], cfg, L.apply_norm(x, p["ln1"], cfg),
                         positions, kv=proj)
    k, v = cross_kv(p["xattn"], cfg, enc_out)
    if proj is not None:
        proj["xk"], proj["xv"] = k, v
    x = x + cross_attn_apply(p["xattn"], cfg,
                             L.apply_norm(x, p["lnx"], cfg), k, v)
    return x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg))


def dec_block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     cache: Dict, pos: torch.Tensor, pos0: int, xlen: int
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decoder block: self-attention over the KV cache (written
    in place at ``pos0``), then cross attention over the first ``xlen``
    positions of the cross K/V."""
    h = L.apply_norm(x, p["ln1"], cfg)
    out, cache = L.attn_decode(p["attn"], cfg, h, cache, pos, pos0)
    x = x + out
    h = L.apply_norm(x, p["lnx"], cfg)
    B = x.shape[0]
    q = L.split_heads(h @ p["xattn"]["wq"].to(x.dtype), cfg.n_heads, cfg.hd)
    xo = L.decode_attention(q, cache["xk"][:, :xlen], cache["xv"][:, :xlen],
                            xlen, kv_chunk=cfg.decode_kv_chunk)
    x = x + xo.reshape(B, 1, -1) @ p["xattn"]["wo"].to(x.dtype)
    x = x + L.mlp_apply(p["mlp"], cfg, L.apply_norm(x, p["ln2"], cfg))
    return x, cache


# -- model --------------------------------------------------------------------


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Parameters on ``gen.device`` with the JAX package's shapes, scales
    and dtypes (``encdec.py:119-134``); the random numbers differ."""
    dt = L.torch_dtype(cfg.param_dtype)
    V, d = cfg.padded_vocab, cfg.d_model
    dev = gen.device
    embed = torch.randn((V, d), generator=gen, device=dev,
                        dtype=torch.float32)
    p: Params = {"dec_embed": (embed * 0.02).to(dt)}
    del embed
    p["enc_layers"] = [enc_block_init(gen, cfg)
                       for _ in range(cfg.n_encoder_layers)]
    p["enc_norm"] = L.norm_init(d, cfg, dev)
    p["dec_layers"] = [dec_block_init(gen, cfg) for _ in range(cfg.n_layers)]
    p["final_norm"] = L.norm_init(d, cfg, dev)
    head = torch.randn((V, d), generator=gen, device=dev, dtype=torch.float32)
    p["lm_head"] = (head * (1.0 / d ** 0.5)).to(dt)
    return p


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None, :].expand(B, S)


def encode(cfg: ModelConfig, params: Params, frames) -> torch.Tensor:
    """Frames (numpy or tensor, (B, S_enc, d_model)) -> the normed encoder
    output in ``cfg.dtype``."""
    dev = params["dec_embed"].device
    if not isinstance(frames, torch.Tensor):
        frames = torch.as_tensor(frames, device=dev)
    x = shard(frames.to(dev).to(L.torch_dtype(cfg.dtype)), "batch", None,
              None)
    B, Se, _ = x.shape
    positions = _positions(B, Se, dev)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for lp in params["enc_layers"]:
        if remat:
            x = checkpoint(enc_block_apply, lp, cfg, x, positions,
                           use_reentrant=False)
        else:
            x = enc_block_apply(lp, cfg, x, positions)
    return L.apply_norm(x, params["enc_norm"], cfg)


def _embed(cfg: ModelConfig, params: Params, tokens
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Target-token embeddings and their positions."""
    dev = params["dec_embed"].device
    x = shard(embed(params["dec_embed"], tokens, L.torch_dtype(cfg.dtype)),
              "batch", None, None)
    B, S = x.shape[:2]
    return x, _positions(B, S, dev)


def _decode_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
                  positions: torch.Tensor, enc_out: torch.Tensor
                  ) -> torch.Tensor:
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for lp in params["dec_layers"]:
        if remat:
            x = checkpoint(dec_block_apply, lp, cfg, x, positions, enc_out,
                           use_reentrant=False)
        else:
            x = dec_block_apply(lp, cfg, x, positions, enc_out)
    return x


def _decoder_out(cfg: ModelConfig, params: Params, batch: Dict
                 ) -> torch.Tensor:
    """The final-normed decoder output over the whole target sequence."""
    enc_out = encode(cfg, params, batch["frames"])
    x, positions = _embed(cfg, params, batch["tokens"])
    x = _decode_stack(cfg, params, x, positions, enc_out)
    return L.apply_norm(x, params["final_norm"], cfg)


def train_forward(cfg: ModelConfig, params: Params, batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits over the target tokens (f32) and aux 0."""
    x = _decoder_out(cfg, params, batch)
    return logits_f32(x, params["lm_head"]), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy over the unmasked labels; aux 0
    (``encdec.py:176-190``)."""
    x = _decoder_out(cfg, params, batch)
    nll_sum, ntok = chunked_ce(cfg, x, params["lm_head"], batch["labels"])
    loss = nll_sum / torch.clamp(ntok, min=1.0)
    return loss, {"nll": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=x.device),
                  "ntok": ntok}


# -- serving ----------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Encode the frames, run the decoder over the target prefix; return
    last-position logits and the decode caches (k, v, xk, xv a layer,
    ``pos`` the prefix length, ``xlen`` the encoder length)."""
    enc_out = encode(cfg, params, batch["frames"])
    x, positions = _embed(cfg, params, batch["tokens"])
    caches: List[Dict] = []
    for lp in params["dec_layers"]:
        proj: Dict[str, torch.Tensor] = {}
        x = dec_block_apply(lp, cfg, x, positions, enc_out, proj)
        caches.append(proj)
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg)
    logits = logits_f32(x, params["lm_head"])
    B, Sd = positions.shape
    dev = x.device
    return logits[:, 0], {
        "layers": caches,
        "pos": torch.full((B,), Sd, dtype=torch.int32, device=dev),
        "xlen": torch.full((B,), enc_out.shape[1], dtype=torch.int32,
                           device=dev)}


def init_cache(cfg: ModelConfig, batch: int, seq: int, enc_seq: int,
               device) -> Dict:
    """Zero decode caches: self-attention KV for ``seq`` target positions,
    cross K/V for ``enc_seq`` encoder positions, all of them valid
    (``xlen``), as in the JAX package, until the serving engine seats a
    prefill's cache and its encoder length."""
    dt = L.torch_dtype(cfg.dtype)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def one() -> Dict:
        return {"k": torch.zeros((batch, seq, KVH, hd), dtype=dt,
                                 device=device),
                "v": torch.zeros((batch, seq, KVH, hd), dtype=dt,
                                 device=device),
                "xk": torch.zeros((batch, enc_seq, H, hd), dtype=dt,
                                  device=device),
                "xv": torch.zeros((batch, enc_seq, H, hd), dtype=dt,
                                  device=device)}

    return {"layers": [one() for _ in range(cfg.n_layers)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "xlen": torch.full((batch,), enc_seq, dtype=torch.int32,
                               device=device)}


def step_logits(cfg: ModelConfig, params: Params, cache: Dict, tokens,
                pos0: Optional[int] = None, xlen: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """The f32 logits (B, 1, padded_vocab) of one decode step at
    ``tokens`` (B, 1), and the caches with ``pos`` advanced (the
    self-attention caches are written in place).  ``pos0`` and ``xlen``,
    when given, are ``cache["pos"][0]`` and ``cache["xlen"][0]`` known on
    the host (the dry run's fake tensors hold no values)."""
    pos = cache["pos"]
    if pos0 is None or xlen is None:
        pos0, xlen = torch.stack([pos[0], cache["xlen"][0]]).tolist()
    x, _ = _embed(cfg, params, tokens)
    new_caches = []
    for lp, lc in zip(params["dec_layers"], cache["layers"]):
        x, c = dec_block_decode(lp, cfg, x, lc, pos, pos0, xlen)
        new_caches.append(c)
    x = L.apply_norm(x, params["final_norm"], cfg)
    return logits_f32(x, params["lm_head"]), {
        "layers": new_caches, "pos": pos + 1, "xlen": cache["xlen"]}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict, tokens,
                pos0: Optional[int] = None, xlen: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One greedy decode step. tokens: (B, 1) -> (next (B, 1) int32,
    cache)."""
    logits, cache = step_logits(cfg, params, cache, tokens, pos0, xlen)
    # mask vocab padding, then greedy (encdec.py:244-247)
    logits = mask_padding(logits, cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache
