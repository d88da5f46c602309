"""The port's models against the JAX package, on the CPU.

Four smoke configurations cover the dense family's branches: qwen3-32b
(QK-norm, GQA), qwen1.5-0.5b (QKV bias), chatglm3-6b (GQA, half RoPE,
QKV bias) and stablelm-1.6b (LayerNorm, quarter RoPE, QKV bias); two
more the SSM family (mamba2-370m: SSD blocks, no attention, no MLP) and
the hybrid one (hymba-1.5b: attention with a sliding window beside the
SSD).  The JAX package's randomly initialised parameters are carried
across with ``params_from_numpy``; both ``attn_impl`` and both
``ssm_impl`` of the port are held against the JAX package's XLA path:
``train_forward`` logits, ``prefill`` logits and every cache leaf, and 8
greedy ``decode_step``s (tokens exact, caches close).  The SSM and hybrid
models run at prompt lengths 37 (a prime: mamba2's smoke chunk search
falls to Q = 1), 32 (Q = 8, 4 chunks) and 2 (shorter than the conv
window).  Tolerance f32 1e-4, as ``tests/test_kernels.py:101``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.serve.engine import _seat as jax_seat
from repro_torch.configs import all_arch_names, get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models.convert import flat_params, params_from_numpy
from repro_torch.serve.engine import _seat

SSM_ARCHS = ["mamba2-370m", "hymba-1.5b"]
ARCHS = ["qwen3-32b", "qwen1.5-0.5b", "chatglm3-6b", "stablelm-1.6b"] \
    + SSM_ARCHS
TOL = 1e-4
B, S, MAX_SEQ, STEPS = 2, 37, 64, 8


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _jax_reference(arch: str, S: int = S) -> dict:
    """The JAX package's outputs for one smoke architecture and prompt
    length."""
    cfg = jax_smoke(arch)
    m = jax_model(cfg)
    params = m.init_params(jax.random.PRNGKey(0))
    tok = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                           size=(B, S)).astype(np.int32)
    logits, _ = jax.jit(m.train_forward)(params, {"tokens": tok})
    pf_logits, pf_cache = jax.jit(m.prefill)(params, {"tokens": tok})
    cache = jax_seat(cfg, m.init_cache(B, MAX_SEQ), pf_cache, S)
    step = jax.jit(m.decode_step)
    nxt = jnp.argmax(pf_logits[:, :cfg.vocab_size], axis=-1
                     ).astype(jnp.int32)[:, None]
    toks = []
    for _ in range(STEPS):
        nxt, cache = step(params, cache, nxt)
        toks.append(np.asarray(nxt))
    return {"arch": arch, "S": S, "tree": jax.tree.map(np.asarray, params),
            "tokens": tok, "logits": np.asarray(logits),
            "pf_logits": np.asarray(pf_logits),
            "pf_cache": jax.tree.map(np.asarray, pf_cache),
            "steps": np.concatenate(toks, axis=1),
            "cache": jax.tree.map(np.asarray, cache)}


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return _jax_reference(request.param)


def _close_layers(layers, stacked):
    """Every leaf of the port's per-layer caches against the JAX
    package's stacked caches (``stacked[...][i]``)."""
    def walk(got, want, i, path):
        assert set(got) == set(want), path
        for name, g in got.items():
            if isinstance(g, dict):
                walk(g, want[name], i, path + (name,))
            else:
                _close(g, want[name][i])
    for i, lc in enumerate(layers):
        walk(lc, stacked, i, ())


def _check_against_jax(ref, attn_impl="cuda", ssm_impl="cuda"):
    cfg = get_smoke_config(ref["arch"]).replace(attn_impl=attn_impl,
                                                ssm_impl=ssm_impl)
    S = ref["S"]
    model = get_model(cfg, "cpu")
    params = params_from_numpy(cfg, ref["tree"], "cpu")
    batch = {"tokens": ref["tokens"]}
    logits, aux = model.train_forward(params, batch)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, ref["logits"])

    pf_logits, pf_cache = model.prefill(params, batch)
    _close(pf_logits, ref["pf_logits"])
    assert pf_cache["pos"].tolist() == [S] * B
    _close_layers(pf_cache["layers"], ref["pf_cache"]["layers"])

    cache = _seat(model.init_cache(B, MAX_SEQ), pf_cache)
    nxt = torch.argmax(pf_logits[:, :cfg.vocab_size], dim=-1
                       ).to(torch.int32)[:, None]
    toks = []
    for _ in range(STEPS):
        nxt, cache = model.decode_step(params, cache, nxt)
        assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
        toks.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, axis=1), ref["steps"])
    assert cache["pos"].tolist() == [S + STEPS] * B
    _close_layers(cache["layers"], ref["cache"]["layers"])


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_forward_prefill_decode_match_jax(ref, impl):
    """``impl`` selects both the attention and the SSD path."""
    _check_against_jax(ref, attn_impl=impl, ssm_impl=impl)


@pytest.fixture(scope="module", params=[(a, s) for a in SSM_ARCHS
                                        for s in (32, 2)],
                ids=lambda p: f"{p[0]}-S{p[1]}")
def ssm_ref(request):
    return _jax_reference(*request.param)


@pytest.mark.parametrize("ssm_impl", ["torch", "cuda"])
def test_ssm_prompt_lengths_match_jax(ssm_ref, ssm_impl):
    """S = 32 chunks for real (mamba2's smoke Q = 8, 4 chunks); S = 2 is
    shorter than the conv window, so the prefill's conv tail is short and
    ``_seat`` places it at the window's head, as the JAX package does."""
    _check_against_jax(ssm_ref, ssm_impl=ssm_impl)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("ssm_impl", ["torch", "cuda"])
def test_ssm_decode_matches_full_forward(arch, ssm_impl):
    """Sequential decode == chunked train forward (state passing); the
    port of ``tests/test_models.py:111``, on both SSD paths."""
    cfg = get_smoke_config(arch).replace(ssm_impl=ssm_impl)
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(6))
    tok = np.random.RandomState(6).randint(0, cfg.vocab_size,
                                           size=(1, 12)).astype(np.int32)
    logits_full, _ = model.train_forward(params, {"tokens": tok})
    want = torch.argmax(logits_full[:, -1, :cfg.vocab_size], -1)
    _, cache = model.prefill(params, {"tokens": tok[:, :-1]})
    nxt, _ = model.decode_step(params, cache, tok[:, -1:])
    assert nxt[:, 0].tolist() == want.tolist()


def test_short_prompt_conv_tail_sits_at_the_window_head():
    """A caveat of the reference, reproduced: a prompt of 2 tokens leaves
    a conv tail of 1 row (``ssm.py:154`` slices from S - 3 = -1), and
    ``_seat`` copies it to row 0 of the 3-row window, with zeros after it
    -- where decode reads the oldest input, not the newest."""
    arch, S2 = "mamba2-370m", 2
    jcfg = jax_smoke(arch)
    m = jax_model(jcfg)
    params = m.init_params(jax.random.PRNGKey(2))
    tok = np.random.RandomState(3).randint(0, jcfg.vocab_size,
                                           size=(B, S2)).astype(np.int32)
    _, pf_cache = jax.jit(m.prefill)(params, {"tokens": tok})
    want = jax_seat(jcfg, m.init_cache(B, MAX_SEQ), pf_cache, S2)
    cfg = get_smoke_config(arch)
    model = get_model(cfg, "cpu")
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    _, tc = model.prefill(tp, {"tokens": tok})
    tail = tc["layers"][0]["ssm"]["conv"]
    assert tail.shape == (B, 1, cfg.d_inner + 2 * cfg.ssm_state)
    seated = _seat(model.init_cache(B, MAX_SEQ), tc)
    conv = seated["layers"][0]["ssm"]["conv"]
    assert torch.equal(conv[:, 0], tail[:, 0])
    assert not conv[:, 1:].any()
    _close(conv, np.asarray(want["layers"]["ssm"]["conv"][0]))


def test_params_carry_across_by_name(ref):
    cfg = get_smoke_config(ref["arch"])
    params = params_from_numpy(cfg, ref["tree"], "cpu")
    flat = flat_params(params)
    tree = ref["tree"]
    assert len(params["layers"]) == cfg.n_layers
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] == "layers":
            leaf = tree["layers"]
            for p in parts[2:]:
                leaf = leaf[p]
            leaf = leaf[int(parts[1])]
        else:
            leaf = tree
            for p in parts:
                leaf = leaf[p]
        np.testing.assert_array_equal(t.numpy(), leaf)
    n_jax = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in flat.values()) == n_jax


def test_bf16_params_carry_bit_for_bit():
    cfg = jax_smoke("qwen3-32b").replace(param_dtype="bfloat16",
                                         dtype="bfloat16", n_layers=2)
    tree = jax.tree.map(np.asarray,
                        jax_model(cfg).init_params(jax.random.PRNGKey(3)))
    params = params_from_numpy(cfg, tree, "cpu")
    wq = params["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.view(torch.int16).numpy().view(np.uint16),
        tree["layers"]["attn"]["wq"][1].view(np.uint16))
    assert params["layers"][1]["attn"]["q_norm"].dtype == torch.float32
    f32 = params_from_numpy(cfg, tree, "cpu", dtype=torch.float32)
    assert f32["embed"].dtype == torch.float32
    np.testing.assert_array_equal(f32["embed"].numpy(),
                                  tree["embed"].astype(np.float32))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_bf16_ssm_params_carry_bit_for_bit(arch):
    """Every leaf, the nested ``ssm`` ones included, bit for bit."""
    cfg = jax_smoke(arch).replace(param_dtype="bfloat16", dtype="bfloat16",
                                  n_layers=2)
    tree = jax.tree.map(np.asarray,
                        jax_model(cfg).init_params(jax.random.PRNGKey(4)))
    params = params_from_numpy(cfg, tree, "cpu")
    flat = flat_params(params)
    assert flat["layers.1.ssm.in_proj"].dtype == torch.bfloat16
    assert flat["layers.1.ssm.A_log"].dtype == torch.float32
    for name, t in flat.items():
        parts = name.split(".")
        leaf = tree["layers"] if parts[0] == "layers" else tree
        for q in (parts[2:] if parts[0] == "layers" else parts):
            leaf = leaf[q]
        if parts[0] == "layers":
            leaf = leaf[int(parts[1])]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                leaf.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), leaf)
    n_layer = len(jax.tree.leaves(tree["layers"]))   # stacked leaves
    assert len(flat) == len(jax.tree.leaves(tree)) + (cfg.n_layers - 1) \
        * n_layer


def test_cuda_path_matches_pallas_interpret():
    """The port's kernel path against the JAX package's kernel path."""
    cfg = jax_smoke("qwen3-32b")
    m = jax_model(cfg.replace(attn_impl="pallas_interpret"))
    params = m.init_params(jax.random.PRNGKey(0))
    tok = np.random.RandomState(2).randint(0, cfg.vocab_size,
                                           size=(B, 32)).astype(np.int32)
    want, _ = jax.jit(m.train_forward)(params, {"tokens": tok})
    tcfg = get_smoke_config("qwen3-32b")
    assert tcfg.attn_impl == "cuda"
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    got, _ = get_model(tcfg, "cpu").train_forward(tparams, {"tokens": tok})
    _close(got, want)


@pytest.mark.parametrize("arch", ["qwen3-32b", "stablelm-1.6b"]
                         + SSM_ARCHS)
def test_init_params_shapes_and_dtypes(arch):
    """Same shapes and dtypes as the JAX package's init; seeded."""
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    want = jax.eval_shape(jax_model(jax_smoke(arch).replace(
        param_dtype="bfloat16")).init_params, jax.random.PRNGKey(0))
    model = get_model(cfg, "cpu")
    p = model.init_params(torch.Generator().manual_seed(0))
    for name, t in flat_params(p).items():
        parts = name.split(".")
        leaf = want["layers"] if parts[0] == "layers" else want
        for q in (parts[2:] if parts[0] == "layers" else parts):
            leaf = leaf[q]
        shape = leaf.shape[1:] if parts[0] == "layers" else leaf.shape
        assert tuple(t.shape) == tuple(shape), name
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), name
    n_top = len(jax.tree.leaves({k: v for k, v in want.items()
                                 if k != "layers"}))
    n_layer = len(jax.tree.leaves(want["layers"]))
    assert len(flat_params(p)) == n_top + cfg.n_layers * n_layer
    again = flat_params(model.init_params(torch.Generator().manual_seed(0)))
    for name, t in flat_params(p).items():
        assert torch.equal(t, again[name]), name


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.25])
def test_rope_matches_jax(fraction):
    from repro.models.layers import rope_rotate
    x = np.random.RandomState(4).randn(2, 9, 3, 16).astype(np.float32)
    pos = np.tile(np.arange(100, 109), (2, 1))
    got = TL.rope_rotate(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         fraction)
    _close(got, rope_rotate(jnp.asarray(x), jnp.asarray(pos), 1e6, fraction),
           2e-5)


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_apply_norm_matches_jax(norm):
    from repro.models.layers import apply_norm
    cfg = get_smoke_config("stablelm-1.6b").replace(norm=norm)
    x = np.random.RandomState(5).randn(2, 5, 64).astype(np.float32)
    rng = np.random.RandomState(6)
    p = {"scale": rng.rand(64).astype(np.float32),
         "bias": rng.randn(64).astype(np.float32)}
    got = TL.apply_norm(torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in p.items()}, cfg)
    want = apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                       p.items()}, jax_smoke("stablelm-1.6b")
                      .replace(norm=norm))
    _close(got, want, 2e-5)


def test_sliding_window_ring_cache_matches_jax():
    """A sliding window shorter than the prompt: the prefill fills a ring
    cache with slot = pos % W, and decode keeps writing into it."""
    arch = "qwen3-32b"
    jcfg = jax_smoke(arch).replace(sliding_window=16)
    m = jax_model(jcfg)
    params = m.init_params(jax.random.PRNGKey(1))
    tok = np.random.RandomState(7).randint(0, jcfg.vocab_size,
                                           size=(B, S)).astype(np.int32)
    pf_logits, pf_cache = jax.jit(m.prefill)(params, {"tokens": tok})
    cache = jax_seat(jcfg, m.init_cache(B, MAX_SEQ), pf_cache, S)
    step = jax.jit(m.decode_step)
    nxt = jnp.argmax(pf_logits[:, :jcfg.vocab_size], -1).astype(
        jnp.int32)[:, None]
    want = []
    for _ in range(4):
        nxt, cache = step(params, cache, nxt)
        want.append(np.asarray(nxt))
    for impl in ("torch", "cuda"):
        cfg = get_smoke_config(arch).replace(sliding_window=16,
                                             attn_impl=impl)
        model = get_model(cfg, "cpu")
        tp = params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
        logits, tc = model.prefill(tp, {"tokens": tok})
        _close(logits, pf_logits)
        _close(tc["layers"][2]["k"], pf_cache["layers"]["k"][2])
        c = _seat(model.init_cache(B, MAX_SEQ), tc)
        n = torch.argmax(logits[:, :cfg.vocab_size], -1).to(
            torch.int32)[:, None]
        got = []
        for _ in range(4):
            n, c = model.decode_step(tp, c, n)
            got.append(n.numpy())
        np.testing.assert_array_equal(np.concatenate(got, 1),
                                      np.concatenate(want, 1))
        _close(c["layers"][0]["v"], cache["layers"]["v"][0])


@pytest.mark.parametrize("arch", sorted(set(all_arch_names()) - set(ARCHS)))
def test_other_families_are_refused(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
        get_model(get_smoke_config(arch), "cpu")


def test_configs_are_the_published_ones():
    cfg = get_config("qwen3-32b")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size, cfg.padded_vocab, cfg.qk_norm, cfg.rope_theta) \
        == (5120, 64, 8, 128, 25600, 151936, 152064, True, 1e6)
    assert cfg.attn_impl == "cuda"
    from repro.configs import get_config as jax_config
    for arch in all_arch_names():
        got = dict(get_config(arch).__dict__)
        assert got.pop("ssm_impl") == "cuda", arch   # the port's own field
        want = jax_config(arch).replace(attn_impl="cuda")
        assert got == want.__dict__, arch


def test_model_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(get_smoke_config("qwen3-32b"))
