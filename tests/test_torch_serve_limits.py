"""Decoding at and past ``max_seq`` in the port's serving engine.

A dense KV cache holds ``max_seq`` positions: a request whose last decode
step would write past it is refused with ``ValueError`` before any prefill
(the JAX engine clamps the write and decodes on over a corrupt cache, so
its tokens there are not an oracle).  At the limit, and on ring caches
(hymba's sliding window) and SSM state (mamba2) past it, the greedy tokens
equal the JAX ``ServeEngine``'s.  MLA's latent cache is bounded the same
way, and a VLM's prompt counts its patch embeddings.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine

PROMPT, MAX_SEQ = 37, 40


def _jax_tokens(arch: str, n_new: int, max_seq: int = MAX_SEQ):
    cfg = jax_smoke(arch)
    params = jax_model(cfg).init_params(jax.random.PRNGKey(0))
    batch = {"tokens": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, PROMPT)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = np.random.RandomState(1).randn(
            2, cfg.n_patches, cfg.d_model).astype(np.float32)
    toks = JaxEngine(cfg, params, max_seq=max_seq).generate(batch, n_new)
    return jax.tree.map(np.asarray, params), batch, toks


def _engine(arch: str, tree, max_seq: int = MAX_SEQ) -> ServeEngine:
    cfg = get_smoke_config(arch)
    return ServeEngine(cfg, params_from_numpy(cfg, tree, "cpu"),
                       max_seq=max_seq, device="cpu")


@pytest.fixture(scope="module")
def qwen3_at_limit():
    return _jax_tokens("qwen3-32b", MAX_SEQ - PROMPT + 1)


def test_dense_overrun_is_refused_before_prefill(qwen3_at_limit):
    tree, batch, _ = qwen3_at_limit
    eng = _engine("qwen3-32b", tree)
    calls = []
    real = eng.model.prefill
    eng.model.prefill = lambda *a, **k: calls.append(1) or real(*a, **k)
    with pytest.raises(ValueError, match="max_seq is 40"):
        eng.generate(batch, 8)
    with pytest.raises(ValueError, match="not a ring"):
        eng.generate(batch, MAX_SEQ - PROMPT + 2)
    assert calls == []
    assert eng.stats == {}


def test_dense_at_the_limit_matches_jax_engine(qwen3_at_limit):
    tree, batch, want = qwen3_at_limit
    n_new = MAX_SEQ - PROMPT + 1          # the last step writes slot 39
    got = _engine("qwen3-32b", tree).generate(batch, n_new)
    assert got.shape == (2, n_new)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_ring_and_ssm_caches_decode_past_max_seq(arch):
    tree, batch, want = _jax_tokens(arch, 8)
    got = _engine(arch, tree).generate(batch, 8)
    assert PROMPT + 8 - 1 > MAX_SEQ and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


# MLA's latent cache and the VLM's KV cache are bounded by max_seq; the
# VLM's 37 tokens follow 8 patches, so its prompt fills 45 positions
LATENT_ARCHS = {"deepseek-v2-lite-16b": 0, "llava-next-34b": 8}
VLM_MAX_SEQ = PROMPT + 8 + 3


def _limit(arch: str):
    """(max_seq, positions of the prompt) of the MLA and VLM cases."""
    n = PROMPT + LATENT_ARCHS[arch]
    return (MAX_SEQ if n == PROMPT else VLM_MAX_SEQ), n


@pytest.mark.parametrize("arch", sorted(LATENT_ARCHS))
def test_mla_and_vlm_overrun_is_refused_before_prefill(arch):
    max_seq, n = _limit(arch)
    tree, batch, _ = _jax_tokens(arch, 2, max_seq)
    eng = _engine(arch, tree, max_seq)
    calls = []
    real = eng.model.prefill
    eng.model.prefill = lambda *a, **k: calls.append(1) or real(*a, **k)
    over = max_seq - n + 2            # the last step would write max_seq
    with pytest.raises(ValueError, match=f"a prompt of {n} positions"):
        eng.generate(batch, over)
    if LATENT_ARCHS[arch]:
        # counted by its tokens alone, the request would fit
        assert PROMPT + over - 1 <= max_seq
    assert calls == [] and eng.stats == {}


@pytest.mark.parametrize("arch", sorted(LATENT_ARCHS))
@pytest.mark.parametrize("below", [0, 2], ids=["at", "under"])
def test_mla_and_vlm_at_and_under_the_limit_match_jax_engine(arch, below):
    max_seq, n = _limit(arch)
    n_new = max_seq - n + 1 - below   # at: the last step writes max_seq - 1
    tree, batch, want = _jax_tokens(arch, n_new, max_seq)
    got = _engine(arch, tree, max_seq).generate(batch, n_new)
    assert got.shape == (2, n_new)
    np.testing.assert_array_equal(got, want)
