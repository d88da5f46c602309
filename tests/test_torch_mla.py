"""The port's MLA family (deepseek-v2-lite-16b: latent attention plus MoE)
against the JAX package, on the CPU.

The smoke configuration (3 layers, one first dense, kv_lora_rank 32, q/k
head dim 16 + 8, v head dim 16) with the JAX package's parameters
carried across (``tests/_torch_parity.py``): ``train_forward`` logits and
aux, ``prefill`` logits and every cache leaf (the latent ``c`` and rope
key ``kr``, ``first`` included), 8 greedy ``decode_step``s (absorbed
latent decode) and the JAX ``ServeEngine``'s tokens, at prompt lengths 37
and 2; ``loss_fn`` and every gradient leaf.  MLA's attention takes the
chunked plain path whatever ``attn_impl`` says, as the JAX package's
takes ``flash_attention_xla``; its latent norm goes through the RMSNorm
op once a layer in a prefill and once a layer in a decode step.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.models import get_model
from repro_torch.models.lm import layer_kinds
from repro_torch.serve.engine import _seat

from _torch_parity import (B, MAX_SEQ, check_against_jax,
                           check_bf16_bit_for_bit, check_init_shapes,
                           check_loss_and_grads, jax_loss, jax_reference,
                           make_batch)

ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module", params=[37, 2], ids=lambda s: f"S{s}")
def ref(request):
    return jax_reference(ARCH, request.param)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_forward_prefill_decode_match_jax(ref, impl):
    check_against_jax(ref, attn_impl=impl)


def test_latent_cache_layout(ref):
    cfg = get_smoke_config(ARCH)
    pf = ref["pf_cache"]
    assert set(pf["layers"]) == {"c", "kr"} and set(pf["first"][0]) == \
        {"c", "kr"}
    assert pf["layers"]["c"].shape == (2, B, ref["S"], cfg.kv_lora_rank)
    assert pf["layers"]["kr"].shape == (2, B, ref["S"], cfg.qk_rope_dim)
    cache = get_model(cfg, "cpu").init_cache(B, MAX_SEQ)
    assert cache["first"][0]["c"].shape == (B, MAX_SEQ, cfg.kv_lora_rank)
    assert cache["layers"][1]["kr"].shape == (B, MAX_SEQ, cfg.qk_rope_dim)


@pytest.fixture(scope="module", params=[("default", 1024), ("chunked", 8)],
                ids=lambda p: p[0])
def loss_ref(request):
    return jax_loss(ARCH, 32, loss_chunk=request.param[1])


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_loss_aux_and_grads_match_jax(loss_ref, impl):
    got = check_loss_and_grads(loss_ref, attn_impl=impl)
    assert loss_ref["aux"] > 0
    for name in ("layers/attn/w_uk", "layers/attn/w_uv", "layers/attn/kv_norm",
                 "first_0/attn/w_dkv"):
        assert np.linalg.norm(got[name]) > 0, name


def test_bf16_params_carry_bit_for_bit():
    flat = check_bf16_bit_for_bit(ARCH)
    assert flat["layers.1.attn.w_uk"].dtype == torch.bfloat16
    assert flat["layers.1.attn.kv_norm"].dtype == torch.float32
    assert flat["first_0.attn.w_q"].dtype == torch.bfloat16


def test_init_params_shapes_and_dtypes():
    check_init_shapes(ARCH)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_kernel_calls_of_a_generate(impl, monkeypatch):
    """The latent norm is the one model kernel MLA calls: once a layer in
    the prefill (the cache takes the attention's own projection) and once
    a layer in each decode step; flash attention never."""
    calls = {"rmsnorm": [], "flash_attention": []}
    for mod, name in ((rn_ops, "rmsnorm"), (fa_ops, "flash_attention")):
        real = getattr(mod, name)

        def shim(x, *a, _real=real, _name=name, **k):
            calls[_name].append(tuple(x.shape))
            return _real(x, *a, **k)
        monkeypatch.setattr(mod, name, shim)
    cfg = get_smoke_config(ARCH).replace(attn_impl=impl)
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 11)
    _, pf = model.prefill(params, batch)
    assert calls["rmsnorm"] == [(B, 11, cfg.kv_lora_rank)] * cfg.n_layers
    cache = _seat(model.init_cache(B, MAX_SEQ), pf)
    model.decode_step(params, cache, batch["tokens"][:, :1])
    assert calls["rmsnorm"][cfg.n_layers:] == \
        [(B, 1, cfg.kv_lora_rank)] * cfg.n_layers
    assert calls["flash_attention"] == []


def test_full_width_shapes():
    """The published widths: the q/k head dim 192 and v head dim 128 that
    keep MLA off the flash kernel (one head dim for k and v), and the
    first dense layer before 26 MoE layers."""
    cfg = get_config(ARCH)
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim,
            cfg.kv_lora_rank) == (192, 128, 512)
    assert layer_kinds(cfg) == ("moe", 1, 26)
