"""The port's VLM backbone (llava-next-34b) against the JAX package, on
the CPU.

The smoke configuration (3 layers, 7 heads of 8, 8 patch embeddings a
prompt) with the JAX package's parameters carried across
(``tests/_torch_parity.py``): the patches go before the tokens and
positions run over both; ``train_forward`` logits over the text positions
only, ``prefill`` logits and every cache leaf, 8 greedy ``decode_step``s
and the JAX ``ServeEngine``'s tokens, at prompt lengths 37 and 2, on both
``attn_impl``; ``loss_fn`` over the text positions and every gradient
leaf.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import get_model
from repro_torch.models.lm import prompt_len

from _torch_parity import (B, check_against_jax, check_bf16_bit_for_bit,
                           check_init_shapes, check_loss_and_grads, jax_loss,
                           jax_reference, make_batch)

ARCH = "llava-next-34b"


@pytest.fixture(scope="module", params=[37, 2], ids=lambda s: f"S{s}")
def ref(request):
    return jax_reference(ARCH, request.param)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_forward_prefill_decode_match_jax(ref, impl):
    check_against_jax(ref, attn_impl=impl)


def test_patches_come_first(ref):
    """Logits cover the text only; the prefill fills the patches'
    positions too, and decode goes on after both."""
    cfg = get_smoke_config(ARCH)
    S = ref["S"]
    assert ref["logits"].shape[1] == S
    assert ref["prompt"] == S + cfg.n_patches == prompt_len(cfg,
                                                            ref["batch"])
    assert ref["pf_cache"]["layers"]["k"].shape[2] == S + cfg.n_patches
    text = {"tokens": ref["batch"]["tokens"]}
    assert prompt_len(cfg, text) == S


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_loss_and_grads_match_jax(impl):
    ref = jax_loss(ARCH, 32)
    check_loss_and_grads(ref, attn_impl=impl)
    assert ref["ntok"] == B * 32 and ref["aux"] == 0.0


def test_bf16_params_carry_bit_for_bit():
    flat = check_bf16_bit_for_bit(ARCH)
    assert flat["layers.2.attn.wq"].dtype == torch.bfloat16


def test_init_params_shapes_and_dtypes():
    check_init_shapes(ARCH)


def test_flash_attention_sees_patches_and_tokens(monkeypatch):
    """One flash-attention call a layer in a prefill, over the patches and
    the tokens; 7 query heads to 7 KV heads at the smoke widths."""
    shapes = []
    real = fa_ops.flash_attention

    def shim(q, k, v, **kw):
        shapes.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention", shim)
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 5)
    with torch.inference_mode():
        model.prefill(params, batch)
    S = 5 + cfg.n_patches
    assert shapes == [((B, S, cfg.n_heads, cfg.hd),
                       (B, S, cfg.n_kv_heads, cfg.hd))] * cfg.n_layers


def test_text_only_batch_runs_the_backbone():
    """Without ``patches`` the backbone is a dense decoder over the
    tokens, as in the JAX package (``"patches" in batch``)."""
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    tok = np.random.RandomState(3).randint(0, cfg.vocab_size, (B, 6))
    logits, _ = model.train_forward(params, {"tokens": tok})
    full, _ = model.train_forward(params, {
        "tokens": tok, "patches": np.zeros((B, cfg.n_patches, cfg.d_model),
                                           np.float32)})
    assert logits.shape == full.shape == (B, 6, cfg.padded_vocab)
    assert not torch.allclose(logits, full)
