"""The port's MoE family (deepseek-moe-16b) against the JAX package, on
the CPU.

The smoke configuration (3 layers: one first dense layer of FFN width
128, then two MoE layers of 8 routed experts, top-2, and one shared
expert) with the JAX package's parameters carried across
(``tests/_torch_parity.py``): ``train_forward`` logits and aux, ``prefill``
logits and every cache leaf (``first`` included), 8 greedy
``decode_step``s and the JAX ``ServeEngine``'s tokens, at prompt lengths
37 and 2, on both ``attn_impl``; ``loss_fn`` and every gradient leaf.
Routing: the top-k experts, their weights, the kept capacity slots, the
dropped (token, k) pairs and aux against the JAX package's, at the
default ``moe_capacity_factor`` (with drops) and at 8.0 (none dropped),
ties broken to the lower expert as ``lax.top_k`` breaks them, and no
near-tie in the parity inputs' routing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import layer_kinds

from _torch_parity import (check_against_jax, check_bf16_bit_for_bit,
                           check_init_shapes, check_loss_and_grads, close,
                           jax_loss, jax_reference)

ARCH = "deepseek-moe-16b"


@pytest.fixture(scope="module", params=[37, 2], ids=lambda s: f"S{s}")
def ref(request):
    return jax_reference(ARCH, request.param)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_forward_prefill_decode_match_jax(ref, impl, monkeypatch):
    """Every top-k choice of the run is clear of a tie: the k-th and the
    next router probabilities differ by more than 1e-5, far above the f32
    rounding by which the port's inputs to the router differ."""
    gaps = []
    real = TL.top_k

    def watched(probs, k):
        srt = torch.sort(probs, dim=-1, descending=True).values
        gaps.append(float((srt[:, k - 1] - srt[:, k]).min()))
        return real(probs, k)
    monkeypatch.setattr(TL, "top_k", watched)
    check_against_jax(ref, attn_impl=impl)
    assert gaps and min(gaps) > 1e-5, min(gaps)


def test_layer_kinds_and_first_dense_layer(ref):
    cfg = get_smoke_config(ARCH)
    assert layer_kinds(cfg) == ("moe", 1, 2)
    tree = ref["tree"]
    assert tree["first_0"]["mlp"]["w_up"].shape == (cfg.d_model,
                                                   cfg.first_dense_ff)
    assert tree["layers"]["moe"]["w_gate_e"].shape == (
        2, cfg.n_routed_experts, cfg.d_model, cfg.d_ff_expert)
    params = params_from_numpy(cfg, tree, "cpu")
    assert len(params["layers"]) == 2
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        params["layers"][1]["moe"]["w_down_e"].numpy(),
        tree["layers"]["moe"]["w_down_e"][1])


@pytest.fixture(scope="module", params=[("default", 1024), ("chunked", 8)],
                ids=lambda p: p[0])
def loss_ref(request):
    return jax_loss(ARCH, 32, loss_chunk=request.param[1])


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_loss_aux_and_grads_match_jax(loss_ref, impl):
    """The loss holds the MoE layers' aux; the router's gradient comes
    through the top-k weights and through aux."""
    got = check_loss_and_grads(loss_ref, attn_impl=impl)
    assert loss_ref["aux"] > 0
    assert np.linalg.norm(got["layers/moe/router"]) > 0


def test_bf16_params_carry_bit_for_bit():
    flat = check_bf16_bit_for_bit(ARCH)
    assert flat["layers.1.moe.w_gate_e"].dtype == torch.bfloat16
    assert flat["layers.1.moe.router"].dtype == torch.float32
    assert flat["first_0.mlp.w_up"].dtype == torch.bfloat16


def test_init_params_shapes_and_dtypes():
    check_init_shapes(ARCH)


# ---------------------------------------------------------------------------
# routing and capacity
# ---------------------------------------------------------------------------


def _moe_layer(cfg, seed: int = 0):
    """One MoE layer's parameters from the JAX package's init, as numpy."""
    params = JL.moe_init(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(np.asarray, params)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _oracle_slots(idx: np.ndarray, E: int, C: int):
    """The capacity rule walked pair by pair in (token, k) order: the n-th
    pair routed to expert e keeps slot e * C + n while n < C."""
    seen = [0] * E
    slot, keep = [], []
    for e in idx.reshape(-1).tolist():
        keep.append(seen[e] < C)
        slot.append(e * C + seen[e] if seen[e] < C else E * C)
        seen[e] += 1
    return np.array(slot), np.array(keep)


@pytest.mark.parametrize("factor", [None, 8.0], ids=["default", "no-drop"])
def test_routing_kept_and_dropped_pairs_match_jax(factor):
    jcfg = jax_smoke(ARCH)
    cfg = get_smoke_config(ARCH)
    if factor is not None:
        jcfg = jcfg.replace(moe_capacity_factor=factor)
        cfg = cfg.replace(moe_capacity_factor=factor)
    p = _moe_layer(jcfg)
    tp = _torch_tree(p)
    T = 16
    x = np.random.RandomState(5).randn(T, cfg.d_model).astype(np.float32)
    jw, jidx, jaux = JL._route(p, jcfg, jnp.asarray(x))
    w, idx, aux = TL._route(tp, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(w, jw, 1e-6)
    close(aux, jaux, 1e-6)

    E = cfg.n_routed_experts
    C = TL.moe_capacity(cfg, T)
    assert C == max(1, int(np.ceil(T * cfg.moe_top_k / E
                                   * cfg.moe_capacity_factor)))
    slot, keep = TL.dispatch_slots(idx, E, C)
    want_slot, want_keep = _oracle_slots(np.asarray(jidx), E, C)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    dropped = int((~keep).sum())
    if factor is None:
        assert dropped > 0       # the default capacity drops some pairs
    else:
        assert dropped == 0

    y, aux2 = TL._dispatch_combine(tp, cfg, torch.from_numpy(x))
    jy, jaux2 = JL._dispatch_combine(p, jcfg, jnp.asarray(x), 1, None)
    close(y, jy)
    close(aux2, jaux2, 1e-6)
    got, gaux = TL.moe_apply(tp, cfg, torch.from_numpy(x)[None])
    want, waux = JL.moe_apply(p, jcfg, jnp.asarray(x)[None])
    close(got, want)
    close(gaux, waux, 1e-6)


def test_one_token_decode_capacity_is_one():
    """A decode step routes B tokens: at the smoke widths (E 8, top-2) and
    at the full ones (E 64, top-6) with 4 prompts C is 1, so most
    collisions drop."""
    assert TL.moe_capacity(get_smoke_config(ARCH), 2) == 1
    from repro_torch.configs import get_config
    assert TL.moe_capacity(get_config(ARCH), 4) == 1
    assert TL.moe_capacity(get_config(ARCH), 4096) == 480


def test_ties_go_to_the_lower_expert_as_lax_top_k():
    """A zero router makes every probability equal: both packages pick
    experts 0 and 1 for every token, with equal weights."""
    jcfg = jax_smoke(ARCH)
    cfg = get_smoke_config(ARCH)
    p = _moe_layer(jcfg)
    p["router"] = np.zeros_like(p["router"])
    x = np.random.RandomState(6).randn(5, cfg.d_model).astype(np.float32)
    jw, jidx, _ = JL._route(p, jcfg, jnp.asarray(x))
    w, idx, _ = TL._route(_torch_tree(p), cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jidx), [[0, 1]] * 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(w, jw, 0)
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.5, 0.2, 0.5, 0.2]])
    vals, top = TL.top_k(probs, 3)
    assert top.tolist() == [[1, 2, 3], [0, 2, 1]]
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]),
        top.numpy())


@pytest.mark.parametrize("factor", [None, 8.0], ids=["default", "no-drop"])
def test_dispatch_gradients_match_jax(factor):
    """Gradients of the MoE layer's output through dispatch and combine:
    a dropped (token, k) pair passes none to its token, as ``jax.grad``
    gives; the router's comes through the weights and aux."""
    jcfg = jax_smoke(ARCH)
    cfg = get_smoke_config(ARCH)
    if factor is not None:
        jcfg = jcfg.replace(moe_capacity_factor=factor)
        cfg = cfg.replace(moe_capacity_factor=factor)
    p = _moe_layer(jcfg, seed=1)
    T = 64
    x = np.random.RandomState(7).randn(1, T, cfg.d_model).astype(np.float32)
    ct = np.random.RandomState(8).randn(1, T, cfg.d_model).astype(np.float32)

    def jfun(pp, xx):
        y, aux = JL.moe_apply(pp, jcfg, xx)
        return jnp.sum(y * ct) + aux
    jgp, jgx = jax.grad(jfun, argnums=(0, 1))(p, jnp.asarray(x))
    tp = _torch_tree(p)
    leaves = {}

    def req(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                req(v, prefix + k + ".")
            else:
                leaves[prefix + k] = v.requires_grad_(True)
    req(tp)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TL.moe_apply(tp, cfg, tx)
    (torch.sum(y * torch.from_numpy(ct)) + aux).backward()

    def pick(tree, name):
        for part in name.split("."):
            tree = tree[part]
        return np.asarray(tree)
    for name, leaf in leaves.items():
        want = pick(jgp, name)
        np.testing.assert_allclose(leaf.grad.numpy(), want, atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-4,
                               rtol=1e-4)
