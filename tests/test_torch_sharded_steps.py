"""The port's sharded steps against the JAX package's unsharded ones.

One 2 x 2 gloo world (``("data", "model")``, four processes on this host,
``tests/_torch_sharded_workers.py``) runs, for the f32 smoke configuration
of each of the ten architectures, one sharded train step, a sharded
prefill and 8 sharded greedy decode steps, all built by
``launch.steps.build_cell`` from the JAX package's parameters (carried
across with ``params_from_numpy``); then ``compressed_psum_tree`` over the
world.  The JAX package runs the same steps unsharded
(``make_train_step``, ``prefill``, ``decode_step``) here.

Tolerances: the loss within 1e-5 and the gradient norm within relative
1e-5; every leaf of the new f32 master and the prefill logits within
relative L2 1e-4; greedy tokens identical.  AdamW's first step is
``lr * g / (|g| + eps)``, which turns a gradient near zero into a step of
any size below ``lr``: an entry whose reference gradient is below 1e-6
(100 eps; the k biases', whose gradient is zero in exact arithmetic since
softmax ignores a shift of a row, and a few of hymba's ``conv_b``) is left
out of the relative L2 and held to the only bound such a step has,
``|difference| <= 2 lr``.

The two MoE configurations run with ``moe_capacity_factor=8.0`` (no drops,
as ``tests/test_distributed.py`` sets it), so their sequence (32) divides
the model axis and the port takes the expert-parallel branch (two
all-to-alls).  Their load-balance term is the mean, over the world's four
(batch shard, sequence shard) token blocks, of each block's aux (the JAX
package's ``pmean``), a nonlinear function of per-block routing statistics
that differs from the global aux.  So the JAX reference runs with its own
``_route`` standing in for itself: the routing of all tokens, the aux the
block-wise mean of the JAX ``_route``'s aux on each block.  The train step
(router gradient included) runs at the configuration's aux coefficient.

Two more cases take ``accum_steps=2`` on a batch of 4 rows whose label
masks leave each micro-batch another token count (qwen3-32b and
deepseek-moe-16b), against the JAX ``make_train_step`` with the same
accumulation: each micro-batch is the reference's global rows.
"""

import contextlib
import os
import pickle
import tempfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as tmp

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.steps import cast_params as jax_cast
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import get_model as jax_model
from repro.models import layers as jax_layers
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.compress import ef_int8_compress
from repro.serve.engine import _seat as jax_seat
from repro_torch.configs import all_arch_names

from _torch_parity import make_batch
from _torch_sharded_workers import (MAX_SEQ, OCFG, STEPS, compress_input,
                                    sharded_rank)

S = 32
LOSS_TOL, RTOL, TINY_GRAD = 1e-5, 1e-4, 1e-6
MOE = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
ARCHS = all_arch_names()
ACCUM = ("qwen3-32b", "deepseek-moe-16b")
ACCUM_KEYS = [f"{a}@accum2" for a in ACCUM]
MESH = (2, 2)                       # (data, model)


def _replace(arch: str) -> dict:
    return {"moe_capacity_factor": 8.0} if arch in MOE else {}


def _blockwise_route(S: int):
    """The JAX ``_route`` with the expert-parallel layout's aux: the
    routing of all tokens, the aux the mean of ``_route``'s aux over the
    mesh's (batch shard, sequence shard) blocks of the (B * S, d)
    tokens."""
    route = jax_layers._route

    def blockwise(p, cfg, x_flat):
        w, idx, _ = route(p, cfg, x_flat)
        T, d = x_flat.shape
        B = T // S
        x = x_flat.reshape(B, S, d)
        nb, ns = MESH
        auxes = [route(p, cfg, x[i * B // nb:(i + 1) * B // nb,
                                 j * S // ns:(j + 1) * S // ns]
                       .reshape(-1, d))[2]
                 for i in range(nb) for j in range(ns)]
        return w, idx, sum(auxes) / len(auxes)
    return blockwise


def _accum_batch(cfg) -> dict:
    """4 rows of S tokens; rows 0-1 (micro-batch 0) keep 5 and 32 labels,
    rows 2-3 keep 29 and 30, so that the two micro-batches, and each
    data shard's rows, count other tokens."""
    tok = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                           size=(4, S)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    for row, masked in enumerate((27, 0, 3, 2)):
        labels[row, :masked] = -1
    return {"tokens": tok, "labels": labels}


def _train_reference(cfg, batch, accum: int) -> dict:
    """The JAX package's unsharded train step, and the gradient (the
    micro-batches' mean) that tells the near-zero entries."""
    m = jax_model(cfg)
    params = m.init_params(jax.random.PRNGKey(0))
    patch = mock.patch.object(jax_layers, "_route", _blockwise_route(S)) \
        if cfg.is_moe else contextlib.nullcontext()
    with patch:
        new_state, metrics = jax.jit(jax_train_step(
            cfg, JaxAdamW(**OCFG), accum_steps=accum))(
            jax_adamw_init(params), batch)
        grad_fn = jax.jit(jax.grad(lambda p, b: m.loss_fn(p, b)[0]))
        cast = jax_cast(params, jnp.dtype(cfg.param_dtype))
        n = batch["tokens"].shape[0] // accum
        grads = [grad_fn(cast, {k: v[i * n:(i + 1) * n]
                                for k, v in batch.items()})
                 for i in range(accum)]
    grads = jax.tree.map(lambda *g: np.mean(np.stack(g), axis=0), *grads)
    return params, {
        "loss": float(metrics["loss"]), "nll": float(metrics["nll"]),
        "aux": float(metrics["aux"]),
        "grad_norm": float(metrics["grad_norm"]),
        "master": jax.tree.map(np.asarray, new_state["master"]),
        "grads": jax.tree.map(np.asarray, grads)}


def _reference(arch: str) -> dict:
    cfg = jax_smoke(arch).replace(**_replace(arch))
    m = jax_model(cfg)
    train_batch = make_batch(cfg, S, labels=True)
    params, ref = _train_reference(cfg, train_batch, 1)
    prompt = make_batch(cfg, S, s_enc=MAX_SEQ)
    pf_logits, pf_cache = jax.jit(m.prefill)(params, prompt)
    cache = jax_seat(cfg, m.init_cache(2, MAX_SEQ), pf_cache,
                     int(pf_cache["pos"][0]))
    nxt = jnp.argmax(pf_logits[:, :cfg.vocab_size], axis=-1
                     ).astype(jnp.int32)[:, None]
    step = jax.jit(m.decode_step)
    toks = []
    for _ in range(STEPS):
        nxt, cache = step(params, cache, nxt)
        toks.append(np.asarray(nxt))
    ref.update(case={"key": arch, "arch": arch, "replace": _replace(arch),
                     "accum": 1, "tree": jax.tree.map(np.asarray, params),
                     "train_batch": train_batch, "prompt_batch": prompt},
               pf_logits=np.asarray(pf_logits),
               steps=np.concatenate(toks, axis=1))
    return ref


def _accum_reference(arch: str) -> dict:
    cfg = jax_smoke(arch).replace(**_replace(arch))
    batch = _accum_batch(cfg)
    params, ref = _train_reference(cfg, batch, 2)
    ref["case"] = {"key": f"{arch}@accum2", "arch": arch,
                   "replace": _replace(arch), "accum": 2,
                   "tree": jax.tree.map(np.asarray, params),
                   "train_batch": batch}
    return ref


@pytest.fixture(scope="module")
def world():
    refs = {a: _reference(a) for a in ARCHS}
    refs.update({f"{a}@accum2": _accum_reference(a) for a in ACCUM})
    d = tempfile.mkdtemp(prefix="repro-sharded-")
    cases = os.path.join(d, "cases.pkl")
    out = os.path.join(d, "out.pkl")
    with open(cases, "wb") as f:
        pickle.dump([r["case"] for r in refs.values()], f)
    tmp.spawn(sharded_rank, args=(4, os.path.join(d, "init"), cases, out),
              nprocs=4, join=True)
    with open(out, "rb") as f:
        got = pickle.load(f)
    return refs, got


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, np.float32)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ARCHS + ACCUM_KEYS)
def test_sharded_train_step_matches_unsharded(world, arch):
    refs, got = world
    ref, g = refs[arch], got[arch]
    assert abs(g["loss"] - ref["loss"]) <= LOSS_TOL
    assert abs(g["nll"] - ref["nll"]) <= LOSS_TOL
    assert abs(g["aux"] - ref["aux"]) <= LOSS_TOL
    assert abs(g["grad_norm"] - ref["grad_norm"]) \
        <= LOSS_TOL * ref["grad_norm"]
    want = dict(_leaves(ref["master"]))
    have = dict(_leaves(g["master"]))
    grad = dict(_leaves(ref["grads"]))
    assert have.keys() == want.keys()
    for name, w in want.items():
        assert have[name].shape == w.shape, name
        live = np.abs(grad[name]) >= TINY_GRAD
        assert _rel_l2(have[name][live], w[live]) <= RTOL, name
        assert np.all(np.abs(have[name][~live] - w[~live])
                      <= 2 * OCFG["lr"]), name


@pytest.mark.parametrize("arch", MOE)
def test_moe_takes_the_expert_parallel_branch(world, arch):
    """Every MoE layer of the sharded train step (forward, and again in
    the remat backward) dispatched expert parallel, with a load-balance
    term (held against the block-wise reference by the train test)."""
    cfg = jax_smoke(arch)
    n_moe = cfg.n_layers - cfg.first_k_dense
    _, got = world
    g = got[arch]
    assert g["ep_calls"] == 2 * n_moe
    assert g["aux"] > 0


def test_accumulation_cases_see_uneven_micro_batches():
    """The accumulation batch's micro-batches, and the rows each data
    rank holds, count different numbers of labels: taking a rank's
    share of each micro-batch instead of the global rows would change
    the loss."""
    labels = _accum_batch(jax_smoke("qwen3-32b"))["labels"]
    per_row = (labels >= 0).sum(axis=1)
    assert per_row[:2].sum() != per_row[2:].sum()
    assert per_row[[0, 2]].sum() != per_row[:2].sum()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_unsharded(world, arch):
    refs, got = world
    ref, g = refs[arch], got[arch]
    assert g["pf_logits"].shape == ref["pf_logits"].shape
    assert _rel_l2(g["pf_logits"], ref["pf_logits"]) <= RTOL
    np.testing.assert_array_equal(g["steps"], ref["steps"])


def test_compressed_psum_tree_over_the_world(world):
    """The world's mean equals, leaf by leaf, the reference's
    ``ef_int8_compress`` of each rank's input at the shared scale, summed
    in NumPy; rank 0's new error is its own residual."""
    _, got = world
    res = got["__compress__"]
    ins = [compress_input(r) for r in range(4)]
    for name in ("w", "b"):
        xs = [g[name] + e[name] for g, e in ins]
        scale = max(max(float(np.max(np.abs(x))) for x in xs), 1e-12) / 127
        qs = [np.asarray(ef_int8_compress(jnp.asarray(g[name]),
                                          jnp.asarray(e[name]),
                                          scale=jnp.float32(scale))[0])
              for g, e in ins]
        want = np.sum([q.astype(np.int32) for q in qs], axis=0
                      ).astype(np.float32) * np.float32(scale) / 4
        np.testing.assert_allclose(res["avg"][name], want, rtol=1e-6,
                                   atol=0)
        err0 = np.asarray(ef_int8_compress(
            jnp.asarray(ins[0][0][name]), jnp.asarray(ins[0][1][name]),
            scale=jnp.float32(scale))[2])
        np.testing.assert_allclose(res["err"][name], err0, rtol=0,
                                   atol=1e-7)
