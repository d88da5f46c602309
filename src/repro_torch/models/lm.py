"""Decoder-only language models in PyTorch: the dense, MoE, MLA, SSM,
hybrid and VLM families.

The counterpart of the JAX package's ``models/lm.py`` for the block kinds
``"dense"``, ``"moe"`` (attention, then routed + shared experts),
``"dense_first"`` (the first ``first_k_dense`` layers of a MoE model, with
a dense FFN of width ``first_dense_ff``), ``"ssm"`` (mamba2: a norm and
the SSD, no MLP) and ``"hybrid"`` (hymba: attention and the SSD side by
side on the same normed input, averaged, then the MLP).  With ``cfg.mla``
every attention is DeepSeek-V2's latent attention and the decode cache
holds the latent ``c`` and rope key ``kr``.  A VLM's ``batch["patches"]``
(B, n_patches, d_model) go before the token embeddings; positions run
over both, and logits cover the text positions only.

The layer stack is a Python loop over a list of per-layer parameter dicts
(the JAX package scans stacked leaves); ``layers[i]`` holds what
``layers[...][i]`` holds there, and the first dense layers are
``params["first_{i}"]`` and ``cache["first"][i]``, as there.

Entry points:

  train_forward  -> logits + aux  (full sequence, causal)
  loss_fn        -> mean token cross-entropy + aux + metrics
                    (differentiable)
  prefill        -> last-position logits + per-layer decode caches
  decode_step    -> next-token ids + updated caches (one token)

With ``cfg.remat == "block"`` and autograd on, every block, the first
dense ones included, runs under ``torch.utils.checkpoint`` (the JAX
package checkpoints its scan body), so a backward pass recomputes each
block's forward, kernels included.

The encoder-decoder family is ``models/encdec.py``.

Under a mesh (``distributed.mesh_context``, DTensor parameters and
inputs) the JAX package's constraints apply at its places: the embedded
input and every layer boundary are (batch x seq)-sharded when the
sequence divides the model axis (Megatron-SP), and the cross-entropy runs
vocabulary-parallel on each rank's shard of the head.  Outside a mesh
they are identities.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (all_reduce, all_reduce_replicated,
                                    axis_size, batch_placements, is_dtensor,
                                    local_run, placements_of, shard)
from .config import ModelConfig
from . import layers as L
from . import ssm as S

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    """kind: dense | dense_first | moe | ssm | hybrid."""
    dev = gen.device
    p: Params = {"ln1": L.norm_init(cfg.d_model, cfg, dev)}
    if kind != "ssm":
        p["attn"] = L.mla_init(gen, cfg) if cfg.mla else L.attn_init(gen, cfg)
        p["ln2"] = L.norm_init(cfg.d_model, cfg, dev)
        if kind == "moe":
            p["moe"] = L.moe_init(gen, cfg)
        elif kind == "dense_first":
            p["mlp"] = L.mlp_init(gen, cfg, d_ff=cfg.first_dense_ff)
        else:
            p["mlp"] = L.mlp_init(gen, cfg)
    if kind in ("ssm", "hybrid"):
        p["ssm"] = S.ssd_init(gen, cfg)
    return p


def _attend(p: Params, cfg: ModelConfig, h: torch.Tensor,
            positions: torch.Tensor,
            proj: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Full-sequence attention, GQA or MLA; with ``proj`` a dict, the
    projections a decode cache holds (k and v, or c and kr) are left in
    it."""
    if cfg.mla:
        return L.mla_apply(p["attn"], cfg, h, positions, lat=proj)
    return L.attn_apply(p["attn"], cfg, h, positions, kv=proj)


def _mix(p: Params, cfg: ModelConfig, x: torch.Tensor,
         positions: torch.Tensor, kind: str) -> torch.Tensor:
    """The token-mixing half of a block (attention / SSD / both)."""
    h = L.apply_norm(x, p["ln1"], cfg)
    if kind == "ssm":
        return S.ssd_apply(p["ssm"], cfg, h)
    out = _attend(p, cfg, h, positions)
    if kind == "hybrid":
        out = 0.5 * (out + S.ssd_apply(p["ssm"], cfg, h))
    return out


def _ffn(p: Params, cfg: ModelConfig, x: torch.Tensor, kind: str
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MLP (or MoE) half of a block: (x + its output, MoE aux or
    None)."""
    h = L.apply_norm(x, p["ln2"], cfg)
    if kind == "moe":
        y, aux = L.moe_apply(p["moe"], cfg, h)
        return x + y, aux
    return x + L.mlp_apply(p["mlp"], cfg, h), None


def block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, kind: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x = x + _mix(p, cfg, x, positions, kind)
    if kind == "ssm":
        return x, None
    return _ffn(p, cfg, x, kind)


def block_prefill(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, kind: str
                  ) -> Tuple[torch.Tensor, Dict]:
    """Forward + this layer's decode cache.  k and v (MLA: c and kr) come
    from the one projection the attention makes (the JAX package projects
    a second time for the cache; the values are the same)."""
    h = L.apply_norm(x, p["ln1"], cfg)
    cache: Dict = {}
    if kind == "ssm":
        out, cache["ssm"] = S.ssd_apply(p["ssm"], cfg, h, with_cache=True)
        return x + out, cache
    Sq = h.shape[1]
    proj: Dict[str, torch.Tensor] = {}
    out = _attend(p, cfg, h, positions, proj)
    W = min(Sq, cfg.sliding_window) if cfg.sliding_window else Sq
    if cfg.mla or W == Sq:
        cache.update(proj)
    elif is_dtensor(proj["k"]):   # the same ring layout, as a roll
        for n in ("k", "v"):
            t = proj[n][:, Sq - W:]
            pl = L.kernel_placements(t, keep=(1,))
            cache[n] = local_run(lambda x: torch.roll(x, (Sq - W) % W, 1),
                                 (t,), (pl,), pl, t.device_mesh)
    else:  # ring layout consistent with decode's slot = pos % W
        k, v = proj["k"], proj["v"]
        idx = (Sq - W + torch.arange(W, device=k.device)) % W
        cache["k"] = torch.zeros_like(k[:, Sq - W:])
        cache["v"] = torch.zeros_like(v[:, Sq - W:])
        cache["k"][:, idx] = k[:, Sq - W:]
        cache["v"][:, idx] = v[:, Sq - W:]
    if kind == "hybrid":
        s_out, cache["ssm"] = S.ssd_apply(p["ssm"], cfg, h, with_cache=True)
        out = 0.5 * (out + s_out)
    return _ffn(p, cfg, x + out, kind)[0], cache


def block_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                 pos: torch.Tensor, pos0: int, kind: str
                 ) -> Tuple[torch.Tensor, Dict]:
    h = L.apply_norm(x, p["ln1"], cfg)
    if kind == "ssm":
        out, ssm_cache = S.ssd_decode(p["ssm"], cfg, h, cache["ssm"])
        return x + out, {"ssm": ssm_cache}
    decode = L.mla_decode if cfg.mla else L.attn_decode
    out, new_cache = decode(p["attn"], cfg, h, cache, pos, pos0)
    new_cache = dict(new_cache)
    if kind == "hybrid":
        s_out, new_cache["ssm"] = S.ssd_decode(p["ssm"], cfg, h,
                                               cache["ssm"])
        out = 0.5 * (out + s_out)
    return _ffn(p, cfg, x + out, kind)[0], new_cache


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def layer_kinds(cfg: ModelConfig) -> Tuple[str, int, int]:
    """(kind of the stacked layers, number of first dense layers, number
    of stacked layers): the JAX package's ``_layer_kinds`` (``lm.py:158``).
    """
    if cfg.family == "ssm":
        return "ssm", 0, cfg.n_layers
    if cfg.hybrid:
        return "hybrid", 0, cfg.n_layers
    if cfg.is_moe:
        return "moe", cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense
    return "dense", 0, cfg.n_layers


def _blocks(cfg: ModelConfig, params: Params) -> List[Tuple[Params, str]]:
    """(parameters, kind) of every layer in order: the first dense layers,
    then the stack."""
    kind, n_first, _ = layer_kinds(cfg)
    return [(params[f"first_{i}"], "dense_first") for i in range(n_first)] \
        + [(lp, kind) for lp in params["layers"]]


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Parameters on ``gen.device`` with the JAX package's shapes, scales
    and dtypes (``lm.py:169-186``, ``layers.py``, ``ssm.py:34-54``); the
    random numbers differ."""
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
    kind, n_first, n_scan = layer_kinds(cfg)
    p["layers"] = [block_init(gen, cfg, kind) for _ in range(n_scan)]
    for i in range(n_first):
        p[f"first_{i}"] = block_init(gen, cfg, "dense_first")
    return p


def _tokens(device, tokens) -> torch.Tensor:
    """Token ids or labels (numpy array or tensor) as int64 on ``device``."""
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.as_tensor(tokens, dtype=torch.int64, device=device)


def _has_patches(cfg: ModelConfig, batch: Dict) -> bool:
    return cfg.family == "vlm" and "patches" in batch


def prompt_len(cfg: ModelConfig, batch: Dict) -> int:
    """Positions a prefill of ``batch`` fills: its tokens, after a VLM's
    patches."""
    n = batch["tokens"].shape[1]
    return n + batch["patches"].shape[1] if _has_patches(cfg, batch) else n


def embed(table: torch.Tensor, tokens, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the embedding ``table`` at ``tokens``, in ``dtype``; of a
    vocabulary-sharded DTensor table, each rank reads its own rows and the
    rows are summed (:func:`_embed_sharded`)."""
    ids = _tokens(table.device, tokens)
    if is_dtensor(table):
        return _embed_sharded(table, ids, dtype)
    return table[ids].to(dtype)


def _embed_sharded(table, ids, dtype: torch.dtype):
    """Vocabulary-parallel lookup (Megatron's): every rank reads the ids
    that fall in its rows of the table, zeros elsewhere, and the rows are
    summed over the model axis (the gradient of a rank's rows is the
    upstream gradient at its ids)."""
    mesh = table.device_mesh
    model = "model" in mesh.mesh_dim_names
    ids_pl = batch_placements(ids, mesh)
    t_pl = placements_of(("model" if model else None, None), 2, mesh)
    n_loc = table.to_local().shape[0]
    v_lo = n_loc * (mesh.get_local_rank("model") if model else 0)
    group = mesh.get_group("model") if model else None

    def local(il, tl):
        rel = il - v_lo
        here = (rel >= 0) & (rel < tl.shape[0])
        rows = tl[torch.clamp(rel, 0, tl.shape[0] - 1)]   # as table[ids]
        rows = torch.where(here[..., None], rows, 0.0)
        if group is not None:
            rows = all_reduce_replicated(rows, "sum", group)
        return rows.to(dtype)

    return local_run(local, (ids, table), (ids_pl, t_pl), ids_pl, mesh)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token (+ VLM patch) embeddings and positions."""
    dev = params["embed"].device
    x = embed(params["embed"], batch["tokens"], L.torch_dtype(cfg.dtype))
    if _has_patches(cfg, batch):
        patches = batch["patches"]
        if not is_dtensor(patches):
            patches = torch.as_tensor(patches, device=dev)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    seq = "seq" if S % max(axis_size("seq"), 1) == 0 else None
    return shard(x, "batch", seq, None), positions


def _text(cfg: ModelConfig, x: torch.Tensor, batch: Dict) -> torch.Tensor:
    """The text positions of ``x`` (a VLM's last ``tokens`` positions)."""
    if cfg.family == "vlm":
        return x[:, -batch["tokens"].shape[1]:]
    return x


def _run_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block in order; returns (x, the sum of the MoE layers' aux)."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, kind in _blocks(cfg, params):
        if remat:
            x, a = checkpoint(block_apply, lp, cfg, x, positions, kind,
                              use_reentrant=False)
        else:
            x, a = block_apply(lp, cfg, x, positions, kind)
        # layer-boundary activations are (batch x seq)-sharded so the
        # saved carries divide over the whole mesh (Megatron-SP)
        x = shard(x, "batch", "seq", None)
        if a is not None:
            aux = aux + a
    return x, aux


def logits_f32(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,vd->bsv", x, lm_head)`` with the head in x's dtype
    and the result in f32, as the JAX package's
    ``preferred_element_type=f32``.  On the card a bf16 product writes f32
    directly (``torch.mm(..., out_dtype=)``) when no gradient is needed;
    otherwise, and on the CPU, both operands are upcast, which gives the
    same products (exact in f32).  On DTensors each rank takes the
    logits of its batch rows and its rows of the head (vocab-sharded
    output)."""
    if is_dtensor(x):
        mesh = x.device_mesh
        model = "model" in mesh.mesh_dim_names
        pl = batch_placements(x, mesh)
        out = [p if n != "model" else (Shard(2) if model else p)
               for n, p in zip(mesh.mesh_dim_names, pl)]
        h_pl = placements_of(("model" if model else None, None), 2, mesh)
        return local_run(logits_f32, (x, lm_head), (pl, h_pl), out, mesh)
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
    x = L.apply_norm(_text(cfg, x, batch), params["final_norm"], cfg)
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
    if is_dtensor(head):
        return _ce_sharded(x, head, labels, maskf)
    logits = logits_f32(x, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum((lse - gold) * maskf)


def _ce_sharded(x, head, labels, maskf) -> torch.Tensor:
    """:func:`_ce` vocabulary-parallel: every rank takes the logits of its
    rows of the head (the JAX package's vocab-sharded logits) for its
    batch shard; the softmax max and sum and the gold logit are reduced
    over the model axis; each batch shard's sum is one entry of a vector
    laid out as the batch over the data axes, summed last."""
    mesh = head.device_mesh
    model = "model" in mesh.mesh_dim_names
    row = batch_placements(labels, mesh)
    h_pl = placements_of(("model" if model else None, None), 2, mesh)
    group = mesh.get_group("model") if model else None
    v_lo = head.to_local().shape[0] * (mesh.get_local_rank("model")
                                       if model else 0)

    def local(xl, hl, ll, ml):
        if group is None or group.size() == 1:   # the vocabulary is whole
            return _ce(xl, hl, ll, ml).reshape(1)
        logits = logits_f32(xl, hl)                        # (b, C, V / tp)
        mx = all_reduce(logits.detach().amax(dim=-1), "max", group)
        se = torch.exp(logits - mx[..., None]).sum(dim=-1)
        rel = ll - v_lo
        here = (rel >= 0) & (rel < hl.shape[0])
        gold = torch.gather(logits, -1, torch.clamp(
            rel, 0, hl.shape[0] - 1)[..., None])[..., 0]
        gold = torch.where(here, gold, 0.0)
        se = all_reduce_replicated(se, "sum", group)
        gold = all_reduce_replicated(gold, "sum", group)
        lse = torch.log(se) + mx
        return torch.sum((lse - gold) * ml).reshape(1)

    nll = local_run(local, (x, head, labels, maskf),
                    (row, h_pl, row, row), row, mesh,
                    reduces=("model",) if model else ())
    return nll.sum()


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy over the unmasked labels + the MoE layers' aux
    (0 without experts); metrics ``nll``, ``aux`` and ``ntok``."""
    x, positions = _embed_inputs(cfg, params, batch)
    x, aux = _run_stack(cfg, params, x, positions)
    x = L.apply_norm(_text(cfg, x, batch), params["final_norm"], cfg)
    nll_sum, ntok = chunked_ce(cfg, x, params["lm_head"], batch["labels"])
    denom = torch.clamp(ntok, min=1.0)
    loss = nll_sum / denom + aux
    return loss, {"nll": nll_sum / denom, "aux": aux, "ntok": ntok}


# -- serving ----------------------------------------------------------------


def prefill(cfg: ModelConfig, params: Params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Process the full prompt; return last-position logits + caches."""
    x, positions = _embed_inputs(cfg, params, batch)
    caches: List[Dict] = []
    for lp, kind in _blocks(cfg, params):
        x, c = block_prefill(lp, cfg, x, positions, kind)
        caches.append(c)
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg)
    logits = logits_f32(x, params["lm_head"])
    B, S = positions.shape
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    n_first = layer_kinds(cfg)[1]
    return logits[:, 0], {"layers": caches[n_first:],
                          "first": caches[:n_first], "pos": pos}


def mask_padding(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-inf at the vocabulary padding (entries ``vocab:``), in place; a
    DTensor gets a masked copy with the vocabulary gathered (the greedy
    pick that follows runs on whole rows)."""
    if is_dtensor(logits):
        ids = torch.arange(logits.shape[-1], device=logits.device)
        return shard(torch.where(ids < vocab, logits, float("-inf")),
                     "batch", None, None)
    logits[..., vocab:] = float("-inf")
    return logits


def init_cache(cfg: ModelConfig, batch: int, seq: int, device) -> Dict:
    """Zero decode caches for a max context of ``seq`` tokens."""
    dt = L.torch_dtype(cfg.dtype)
    kind, n_first, n_scan = layer_kinds(cfg)

    def one(k: str) -> Dict:
        if k == "ssm":
            return {"ssm": S.ssd_cache_init(cfg, batch, dt, device)}
        init = L.mla_cache_init if cfg.mla else L.kv_cache_init
        c = init(cfg, batch, seq, dt, device)
        if k == "hybrid":
            c["ssm"] = S.ssd_cache_init(cfg, batch, dt, device)
        return c

    return {"layers": [one(kind) for _ in range(n_scan)],
            "first": [one("dense_first") for _ in range(n_first)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict, tokens,
                pos0: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """One greedy decode step. tokens: (B, 1) -> (next (B, 1) int32, cache).
    The KV and latent caches are updated in place, the SSM caches are
    replaced; the caches are returned with ``pos`` advanced.  ``pos0``,
    when given, is ``int(cache["pos"][0])`` known on the host (the dry
    run's fake tensors hold no value to read)."""
    pos = cache["pos"]
    if pos0 is None:
        pos0 = int(pos[0])
    x = shard(embed(params["embed"], tokens, L.torch_dtype(cfg.dtype)),
              "batch", None, None)
    new_caches = []
    for (lp, kind), lc in zip(_blocks(cfg, params),
                              cache["first"] + cache["layers"]):
        x, c = block_decode(lp, cfg, x, lc, pos, pos0, kind)
        new_caches.append(c)
    x = L.apply_norm(x, params["final_norm"], cfg)
    logits = logits_f32(x, params["lm_head"])
    # mask vocab padding, then greedy
    logits = mask_padding(logits, cfg.vocab_size)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    n_first = layer_kinds(cfg)[1]
    return next_tok, {"layers": new_caches[n_first:],
                      "first": new_caches[:n_first], "pos": pos + 1}
