"""Batched serving engine: prefill + greedy decode with a static batch.

Each dispatched decode step emits a ``frame.serve_step`` event; the
step-index OFFSET pattern means an arbitrarily long generation loop
compresses to a constant-size grammar in the trace (paper's technique
applied to the serving loop).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import spans
from ..core.apis import framework as frame
from ..models import get_model
from ..models.config import ModelConfig
from ..models.lm import layer_kinds, prompt_len


class ServeEngine:
    """Serves ``params`` (the port's parameters, on ``device``).  After
    each :meth:`generate`, ``stats`` holds the host-clock seconds of the
    prefill (with the first token on the host) and of the decode steps,
    read by the call's ``serve.*`` spans (``repro_torch.spans``), whose
    clock reads they share; ``batches`` counts the calls, and is the
    ``batch`` of their ``serve.generate`` spans."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int = 4096,
                 device="cuda"):
        self.cfg = cfg
        self.model = get_model(cfg, device)
        self.params = params
        self.max_seq = max_seq
        self.stats: Dict[str, float] = {}
        self.batches = 0

    @torch.inference_mode()
    def generate(self, batch: Dict, n_new: int) -> np.ndarray:
        """Greedy-decode ``n_new`` tokens after the prompt batch.

        The prefill cache is re-seated into a fresh max_seq cache so long
        generations never reallocate (static-shape serving).  A dense KV
        or MLA latent cache (no ``sliding_window``) holds ``max_seq``
        positions and no more, so a request whose last decode step would
        write past it is refused with ``ValueError`` before any prefill; a
        VLM's prompt counts its patches, an encoder-decoder's its target
        tokens only.  Ring caches and SSM state decode past ``max_seq``.
        (The JAX package clamps the write and decodes on over a corrupt
        cache.)  An encoder-decoder's cross K/V hold ``max_seq`` encoder
        positions, so longer ``frames`` are refused before any prefill too
        (the JAX package fails there on a shape).
        """
        B = batch["tokens"].shape[0]
        S = prompt_len(self.cfg, batch)
        last = S + n_new - 1          # positions written by the last step
        if last > self.max_seq and _bounded_kv(self.cfg):
            raise ValueError(
                f"{self.cfg.name}: a prompt of {S} positions and {n_new} new "
                f"tokens need {last} cache positions, but max_seq is "
                f"{self.max_seq} and the KV cache is not a ring "
                f"(no sliding_window)")
        if self.cfg.n_encoder_layers \
                and batch["frames"].shape[1] > self.max_seq:
            raise ValueError(
                f"{self.cfg.name}: {batch['frames'].shape[1]} encoder frames "
                f"do not fit the cross-attention cache of max_seq "
                f"{self.max_seq} positions")
        with spans.span("serve.generate", batch=self.batches):
            with spans.timed("serve.prefill") as prefill:
                logits, pf_cache = self.model.prefill(self.params, batch)
            with spans.span("serve.seat"):
                cache = _seat(self.model.init_cache(B, self.max_seq),
                              pf_cache)
            with spans.timed("serve.first_token") as first:
                V = self.cfg.vocab_size
                tok = torch.argmax(logits[:, :V],
                                   dim=-1).to(torch.int32)[:, None]
                out = [tok.cpu().numpy()]
            with spans.timed("serve.decode") as decode:
                for i in range(n_new - 1):
                    frame.serve_step(i)
                    tok, cache = self.model.decode_step(self.params, cache,
                                                        tok)
                    out.append(tok.cpu().numpy())
        self.batches += 1
        self.stats = {"prefill_s": (first.end_ns - prefill.start_ns) * 1e-9,
                      "decode_s": decode.seconds,
                      "decode_steps": n_new - 1}
        return np.concatenate(out, axis=1)


def _bounded_kv(cfg: ModelConfig) -> bool:
    """True when some layer keeps a KV or latent cache of exactly
    ``max_seq`` positions: attention without a sliding window (a windowed
    cache is a ring, SSM state has no positions)."""
    return layer_kinds(cfg)[0] != "ssm" and not cfg.sliding_window


def _seat(cache, pf_cache):
    """Copy the prefill caches (KV or latent, SSM state and conv tail, the
    first dense layers' too, an encoder-decoder's cross K/V) into the
    preallocated max_seq decode cache, in place (the JAX package builds a
    new tree, ``serve/engine.py:52-71``), with ``pos`` and an
    encoder-decoder's encoder length ``xlen``."""
    for dst, src in zip(cache.get("first", []) + cache["layers"],
                        pf_cache.get("first", []) + pf_cache["layers"]):
        _copy_leaves(dst, src)
    for name in ("pos", "xlen"):
        if name in pf_cache:
            cache[name] = pf_cache[name].clone()
    return cache


def _copy_leaves(dst: Dict, src: Dict) -> None:
    for name, s in src.items():
        d = dst[name]
        if isinstance(s, dict):
            _copy_leaves(d, s)
        elif s.shape == d.shape:
            d.copy_(s)
        else:
            # sequence-axis mismatch: place the prompt (or the encoder's
            # K/V) at the cache head (k/v/xk/xv: seq axis ndim-3; c/kr and
            # conv: ndim-2).  As in the JAX package, a prompt shorter than
            # conv_width - 1 puts its conv tail at the head of the window,
            # not beside the next token.
            ax = d.dim() - 3 if name in ("k", "v", "xk", "xv") \
                else d.dim() - 2
            d.narrow(ax, 0, s.shape[ax]).copy_(s)
