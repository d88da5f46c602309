"""Shared helpers of the family parity tests
(``tests/test_torch_{moe,mla,vlm,encdec}.py``): the JAX package's outputs
for a smoke configuration, and the port's held against them on the CPU.

The JAX package's randomly initialised parameters are carried across with
``params_from_numpy``.  Tokens come from numpy seed 1, a VLM's patch
embeddings from seed 2 and an encoder-decoder's ``MAX_SEQ`` frames from
seed 3 (as many as the decode cache holds: there the JAX package's decode
attends to the encoder and nothing else).  Tolerances: f32 1e-4 for logits, aux and every
cache leaf, as ``tests/test_kernels.py``; the loss within 1e-5 and every
gradient leaf within relative L2 1e-4 of ``jax.grad``, as
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.serve import ServeEngine as JaxEngine
from repro.serve.engine import _seat as jax_seat
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import (flat_params, params_from_numpy,
                                        params_to_numpy, reference_leaves,
                                        tree_map)
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import _seat

B, MAX_SEQ, STEPS = 2, 64, 8
TOL, LOSS_TOL, GRAD_RTOL = 1e-4, 1e-5, 1e-4


def close(got: torch.Tensor, want, tol: float = TOL) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def make_batch(cfg, S: int, labels: bool = False, s_enc: int = MAX_SEQ
               ) -> dict:
    """B prompts of S tokens (numpy seed 1); a VLM's n_patches patch
    embeddings (seed 2) go before them; an encoder-decoder's ``s_enc``
    frames (seed 3) go beside them."""
    tok = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                           size=(B, S)).astype(np.int32)
    batch = {"tokens": tok}
    if cfg.family == "vlm":
        batch["patches"] = np.random.RandomState(2).randn(
            B, cfg.n_patches, cfg.d_model).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = np.random.RandomState(3).randn(
            B, s_enc, cfg.d_model).astype(np.float32)
    if labels:
        batch["labels"] = np.roll(tok, -1, axis=1)
    return batch


def jax_reference(arch: str, S: int, **replace) -> dict:
    """The JAX package's train_forward, prefill, 8 decode steps and
    ServeEngine tokens for one smoke architecture and prompt length."""
    cfg = jax_smoke(arch).replace(**replace)
    m = jax_model(cfg)
    params = m.init_params(jax.random.PRNGKey(0))
    batch = make_batch(cfg, S)
    logits, aux = jax.jit(m.train_forward)(params, batch)
    pf_logits, pf_cache = jax.jit(m.prefill)(params, batch)
    prompt = int(pf_cache["pos"][0])
    cache = jax_seat(cfg, m.init_cache(B, MAX_SEQ), pf_cache, prompt)
    step = jax.jit(m.decode_step)
    nxt = jnp.argmax(pf_logits[:, :cfg.vocab_size], axis=-1
                     ).astype(jnp.int32)[:, None]
    toks = []
    for _ in range(STEPS):
        nxt, cache = step(params, cache, nxt)
        toks.append(np.asarray(nxt))
    engine = JaxEngine(cfg, params, max_seq=MAX_SEQ).generate(batch,
                                                              STEPS + 1)
    return {"arch": arch, "S": S, "prompt": prompt, "replace": replace,
            "tree": jax.tree.map(np.asarray, params), "batch": batch,
            "logits": np.asarray(logits), "aux": float(aux),
            "pf_logits": np.asarray(pf_logits),
            "pf_cache": jax.tree.map(np.asarray, pf_cache),
            "steps": np.concatenate(toks, axis=1), "engine": engine,
            "cache": jax.tree.map(np.asarray, cache)}


def close_caches(got: dict, want: dict) -> None:
    """Every leaf of the port's caches (``first``, where the family has
    it, and per-layer ``layers``) against the JAX package's (``first`` a
    list, ``layers`` stacked)."""
    def walk(g, w, pick):
        assert set(g) == set(w)
        for name, leaf in g.items():
            if isinstance(leaf, dict):
                walk(leaf, w[name], pick)
            else:
                close(leaf, pick(w[name]))
    assert len(got.get("first", [])) == len(want.get("first", []))
    for g, w in zip(got.get("first", []), want.get("first", [])):
        walk(g, w, lambda a: a)
    for i, g in enumerate(got["layers"]):
        walk(g, want["layers"], lambda a, i=i: a[i])
    assert got["pos"].tolist() == np.asarray(want["pos"]).tolist()


def port_model(ref: dict, attn_impl: str = "cuda"):
    cfg = get_smoke_config(ref["arch"]).replace(attn_impl=attn_impl,
                                                **ref["replace"])
    return cfg, get_model(cfg, "cpu"), params_from_numpy(cfg, ref["tree"],
                                                         "cpu")


def check_against_jax(ref: dict, attn_impl: str = "cuda") -> None:
    """train_forward logits and aux, prefill logits and every cache leaf,
    8 greedy decode steps (tokens exact, caches close) and the engine's
    tokens, against the JAX package's."""
    cfg, model, params = port_model(ref, attn_impl)
    batch = ref["batch"]
    logits, aux = model.train_forward(params, batch)
    assert logits.shape == ref["logits"].shape
    close(logits, ref["logits"])
    close(aux, ref["aux"])

    pf_logits, pf_cache = model.prefill(params, batch)
    close(pf_logits, ref["pf_logits"])
    close_caches(pf_cache, ref["pf_cache"])

    cache = _seat(model.init_cache(B, MAX_SEQ), pf_cache)
    nxt = torch.argmax(pf_logits[:, :cfg.vocab_size], dim=-1
                       ).to(torch.int32)[:, None]
    toks = []
    for _ in range(STEPS):
        nxt, cache = model.decode_step(params, cache, nxt)
        toks.append(nxt.numpy())
    np.testing.assert_array_equal(np.concatenate(toks, axis=1), ref["steps"])
    close_caches(cache, ref["cache"])

    eng = ServeEngine(cfg, params, max_seq=MAX_SEQ, device="cpu")
    np.testing.assert_array_equal(eng.generate(batch, STEPS + 1),
                                  ref["engine"])


def jax_loss(arch: str, S: int, **replace) -> dict:
    """The JAX package's loss, metrics and gradients for one smoke
    architecture."""
    cfg = jax_smoke(arch).replace(**replace)
    model = jax_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = make_batch(cfg, S, labels=True)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, batch)
    return {"arch": arch, "replace": replace, "batch": batch,
            "tree": jax.tree.map(np.asarray, params), "loss": float(loss),
            "aux": float(metrics["aux"]), "ntok": float(metrics["ntok"]),
            "grads": jax.tree.map(np.asarray, grads)}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def check_loss_and_grads(ref: dict, attn_impl: str = "cuda") -> dict:
    """The port's loss, aux and every leaf's gradient against ``ref``;
    returns the port's gradients by reference name."""
    _cfg, model, params = port_model(ref, attn_impl)
    leaves = [p.requires_grad_(True) for p in flat_params(params).values()]
    loss, metrics = model.loss_fn(params, ref["batch"])
    assert abs(loss.item() - ref["loss"]) <= LOSS_TOL
    assert abs(metrics["aux"].item() - ref["aux"]) <= LOSS_TOL
    assert float(metrics["ntok"]) == ref["ntok"]
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gtree = params_to_numpy(tree_map(lambda p, _: next(it), params))
    got = {n: np.asarray(x, np.float32) for n, x in reference_leaves(gtree)}
    want = {n: np.asarray(x, np.float32)
            for n, x in reference_leaves(ref["grads"])}
    assert got.keys() == want.keys()
    for name, g in want.items():
        assert got[name].shape == g.shape, name
        assert _rel_l2(got[name], g) <= GRAD_RTOL, name
    return got


def check_bf16_bit_for_bit(arch: str) -> dict:
    """Every leaf of a bf16 smoke model carried across bit for bit (f32
    leaves exactly); returns the port's leaves by dotted name."""
    cfg = jax_smoke(arch).replace(param_dtype="bfloat16", dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jax_model(cfg).init_params(jax.random.PRNGKey(4)))
    params = params_from_numpy(get_smoke_config(arch).replace(
        param_dtype="bfloat16", dtype="bfloat16"), tree, "cpu")
    back = dict(reference_leaves(params_to_numpy(params)))
    want = dict(reference_leaves(tree))
    assert back.keys() == want.keys()
    for name, w in want.items():
        g = back[name]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16), err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(g), w, err_msg=name)
    return flat_params(params)


def check_init_shapes(arch: str) -> None:
    """The port's init: the JAX package's shapes and dtypes, leaf for
    leaf, and the same tensors from the same seed."""
    cfg = get_smoke_config(arch).replace(param_dtype="bfloat16")
    want = jax.eval_shape(jax_model(jax_smoke(arch).replace(
        param_dtype="bfloat16")).init_params, jax.random.PRNGKey(0))
    model = get_model(cfg, "cpu")
    p = model.init_params(torch.Generator().manual_seed(0))
    got = dict(reference_leaves(params_to_numpy(p)))
    want = dict(reference_leaves(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == tuple(w.shape), name
        gdt = str(g.dtype).split(".")[-1]
        assert gdt == str(w.dtype), name
    again = flat_params(model.init_params(torch.Generator().manual_seed(0)))
    for name, t in flat_params(p).items():
        assert torch.equal(t, again[name]), name
