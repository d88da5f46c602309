"""The port's training side against the JAX package's, on the CPU.

Smoke configurations in f32, inputs made with numpy from seeds, the JAX
package's parameters carried across with ``params_from_numpy``:

- ``loss_fn`` on qwen1.5-0.5b, mamba2-370m and hymba-1.5b, chunked
  (``S % loss_chunk == 0``) and unchunked, both ``attn_impl``/``ssm_impl``
  of the port against the JAX package's XLA path: the loss within 1e-5,
  every leaf's gradient within relative L2 1e-4 of ``jax.grad`` after the
  port's layers are stacked;
- the three model kernels' autograd Functions against plain autograd
  through their plain versions: equal;
- ``cosine_lr`` and 1 and 3 ``adamw_update`` steps within 1e-6, including
  the JAX package's decay of the stacked per-layer norms; ``cast_params``;
  the int8 compression (``q`` identical); the data pipeline (batches and
  corpus bytes identical);
- the ``Trainer`` from a checkpoint of the JAX package's step-0 state:
  loss and grad norm per step within 1e-4 of the JAX ``Trainer``'s,
  ``accum_steps=2`` against the full batch, retry and restore on a fault,
  the straggler flags, async checkpoints, ``launch.train`` in a
  subprocess, and a traced run whose records, CST and grammar are the JAX
  package's (every label masked, so that both packages' states, and so
  their checkpoints' crc32 fields, stay bit-identical).

On the CPU a kernel wrapper returns its plain version, whose autograd
works, so a CPU test cannot see a graph cut at a kernel.  The card check
that does is ``chip_smoke.py``'s ``train`` phase: every parameter leaf of
mamba2-370m (and of qwen1.5-0.5b, through flash attention) must get a
finite, non-zero gradient on the kernel path, and its kernels phase holds
each Function's gradients equal to plain autograd on the card.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from repro.checkpoint import CheckpointEngine as RefEngine
from repro.configs import get_smoke_config as jax_smoke
from repro.core import recorder as ref_recorder
from repro.core.reader import TraceReader as RefReader
from repro.data import SyntheticConfig as RefSynth
from repro.data import TokenFileDataset as RefDataset
from repro.data import synthetic_batch as ref_batch
from repro.data import write_corpus as ref_corpus
from repro.launch.steps import cast_params as ref_cast
from repro.models import get_model as jax_model
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.optim import cosine_lr as ref_lr
from repro.optim import ef_int8_compress as ref_ef
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import encode_backend as eb
from repro_torch.core import recorder as port_recorder
from repro_torch.core.reader import TraceReader
from repro_torch.data import (SyntheticConfig, TokenFileDataset,
                              synthetic_batch, write_corpus)
from repro_torch.kernels import _grad
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as train_cli
from repro_torch.models import get_model
from repro_torch.models.convert import (flat_params, params_from_numpy,
                                        params_to_numpy, reference_leaves,
                                        state_to_numpy, tree_map)
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_lr, ef_int8_compress,
                               ef_int8_decompress)
from repro_torch.train import StragglerDetector, Trainer, TrainerConfig

ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "hymba-1.5b"]
B, S = 2, 32
# loss_chunk 8 divides S: the chunked branch; 12 does not: one chunk
CHUNKS = {"chunked": 8, "unchunked": 12}
LOSS_TOL, GRAD_RTOL, OPT_TOL, TRAIN_TOL = 1e-5, 1e-4, 1e-6, 1e-4


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """Grammar and cfg_index packing follow the port's module default,
    which is ``cuda``: point it at NumPy."""
    monkeypatch.setattr(eb, "_default_backend", "numpy")


def _leaves_with_names(tree):
    return [(n, np.asarray(x, np.float32))
            for n, x in reference_leaves(tree)]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30))


def _batch(vocab: int, seed: int = 0):
    return synthetic_batch(SyntheticConfig(vocab_size=vocab, seq_len=S,
                                           batch_size=B, seed=seed), 0)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(a, c) for a in ARCHS
                                        for c in CHUNKS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def jax_loss(request):
    arch, chunk = request.param
    cfg = jax_smoke(arch).replace(loss_chunk=CHUNKS[chunk])
    model = jax_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = _batch(cfg.vocab_size)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.loss_fn, has_aux=True))(params, batch)
    return {"arch": arch, "chunk": CHUNKS[chunk], "batch": batch,
            "tree": jax.tree.map(np.asarray, params),
            "loss": float(loss), "ntok": float(metrics["ntok"]),
            "grads": jax.tree.map(np.asarray, grads)}


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_loss_and_grads_match_jax(jax_loss, impl):
    """``impl`` selects both the attention and the SSD path; ``"cuda"``
    goes through the kernels' autograd Functions."""
    cfg = get_smoke_config(jax_loss["arch"]).replace(
        loss_chunk=jax_loss["chunk"], attn_impl=impl, ssm_impl=impl)
    model = get_model(cfg, "cpu")
    params = params_from_numpy(cfg, jax_loss["tree"], "cpu")
    leaves = [p.requires_grad_(True) for p in flat_params(params).values()]
    loss, metrics = model.loss_fn(params, jax_loss["batch"])
    assert abs(loss.item() - jax_loss["loss"]) <= LOSS_TOL
    assert float(metrics["ntok"]) == jax_loss["ntok"] == B * S
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gtree = params_to_numpy(tree_map(lambda p, _: next(it), params))
    got = dict(_leaves_with_names(gtree))
    want = dict(_leaves_with_names(jax_loss["grads"]))
    assert got.keys() == want.keys()
    for name, g in want.items():
        assert got[name].shape == g.shape, name
        assert _rel_l2(got[name], g) <= GRAD_RTOL, name


def test_masked_labels_are_left_out_of_the_loss():
    cfg = get_smoke_config("mamba2-370m")
    jcfg = jax_smoke("mamba2-370m")
    params = jax_model(jcfg).init_params(jax.random.PRNGKey(1))
    batch = _batch(cfg.vocab_size, seed=3)
    batch["labels"][:, ::3] = -1
    want, wm = jax_model(jcfg).loss_fn(params, batch)
    got, gm = get_model(cfg, "cpu").loss_fn(
        params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu"),
        batch)
    assert float(gm["ntok"]) == float(wm["ntok"]) < B * S
    assert abs(float(got) - float(want)) <= LOSS_TOL


# ---------------------------------------------------------------------------
# the kernels' autograd Functions
# ---------------------------------------------------------------------------


def _rand(shape, seed, dtype=torch.float32, scale=1.0):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (torch.from_numpy(x) * scale).to(dtype)


def _function_vs_plain(kernel, plain, inputs, kwargs, n_out=1, used=None):
    """Gradients of ``_grad.apply(kernel, plain, ...)`` (the Function
    route) and of ``plain`` for the same inputs and upstream gradients:
    (Function's, plain's)."""
    def run(f):
        xs = [t.clone().requires_grad_(True) for t in inputs]
        out = f(*xs, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        assert len(outs) == n_out
        pick = used if used is not None else range(n_out)
        gos = [_rand(outs[i].shape, 50 + i, outs[i].dtype) for i in pick]
        return [o.detach() for o in outs], torch.autograd.grad(
            [outs[i] for i in pick], xs, gos)
    return run(functools.partial(_grad.apply, kernel, plain)), run(plain)


SSD_WITH_STATE = functools.partial(ssd_ops.ssd_scan, return_state=True)


FLASH_CASES = {
    # (B, S, H, KVH, D), causal, window: S prime, not a block multiple
    "causal-gqa": ((2, 37, 4, 2, 16), True, 0),
    "windowed": ((1, 53, 5, 5, 8), True, 16),      # hymba smoke's layout
    "full": ((1, 29, 2, 1, 32), False, 0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_function_equals_plain_autograd(case, dtype):
    (b, s, h, kvh, d), causal, window = FLASH_CASES[case]
    q = _rand((b, s, h, d), 1, dtype)
    k = _rand((b, s, kvh, d), 2, dtype)
    v = _rand((b, s, kvh, d), 3, dtype)
    kw = dict(causal=causal, window=window)
    (fo, fg), (po, pg) = _function_vs_plain(
        fa_ops.flash_attention, flash_attention_ref, (q, k, v), kw)
    assert torch.equal(fo[0], po[0])
    for a, b_ in zip(fg, pg):
        assert a.dtype == dtype and torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 7, 16), (41, 64), (2, 13, 5, 8)],
                         ids=str)
def test_rmsnorm_function_equals_plain_autograd(shape, dtype):
    x = _rand(shape, 4, dtype)
    w = _rand(shape[-1:], 5, scale=0.5) + 1.0
    (fo, fg), (po, pg) = _function_vs_plain(
        rn_ops.rmsnorm, rmsnorm_ref, (x, w), {"eps": 1e-5})
    assert torch.equal(fo[0], po[0])
    assert fg[0].dtype == dtype and fg[1].dtype == torch.float32
    for a, b_ in zip(fg, pg):
        assert torch.equal(a, b_)


def _ssd_inputs(B_, nc, Q, nh, hd, ns, dtype, seed):
    x = _rand((B_, nc, Q, nh, hd), seed, dtype)
    b = _rand((B_, nc, Q, ns), seed + 1, dtype, 0.5)
    c = _rand((B_, nc, Q, ns), seed + 2, dtype, 0.5)
    dt = torch.nn.functional.softplus(_rand((B_, nc, Q, nh), seed + 3) - 2)
    da = -dt * torch.arange(1, nh + 1, dtype=torch.float32)
    return x, b, c, dt, da


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 8, 4, 16, 8), (1, 5, 7, 2, 8, 4),
                                   (1, 13, 1, 3, 16, 8)], ids=str)
@pytest.mark.parametrize("state_grad", [False, True],
                         ids=["y-only", "y-and-state"])
def test_ssd_scan_function_equals_plain_autograd(shape, dtype, state_grad):
    """The final state may carry an upstream gradient or none (training
    leaves it unused)."""
    inputs = _ssd_inputs(*shape, dtype, seed=7)
    used = [0, 1] if state_grad else [0]
    (fo, fg), (po, pg) = _function_vs_plain(
        SSD_WITH_STATE, ssd_scan_chunked_ref, inputs, {},
        n_out=2, used=used)
    assert all(torch.equal(a, b_) for a, b_ in zip(fo, po))
    for a, b_ in zip(fg, pg):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_scan_gradient_is_finite_when_the_decay_overflows(dtype):
    """mamba2's decays make exp(cs_q - cs_p) above the diagonal overflow
    within a chunk; the plain version masks the exponent before the
    exponential, so its backward has no 0 * inf."""
    x, b, c, dt, da = _ssd_inputs(2, 2, 64, 3, 16, 8, dtype, seed=11)
    da = da * 40.0                    # cs spans thousands within a chunk
    assert float((da.sum(dim=2)).min()) < -1000
    (fo, fg), (po, pg) = _function_vs_plain(
        SSD_WITH_STATE, ssd_scan_chunked_ref,
        (x, b, c, dt, da), {}, n_out=2, used=[0])
    for a, b_ in zip(fg, pg):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b_)


def test_model_gradient_is_finite_where_the_reference_is_nan():
    """With decays strong enough to overflow within a chunk (A_log + 8
    here; mamba2-370m's own widths reach it at 256-token chunks), the JAX
    package's SSD takes exp before its causal mask and its gradients are
    NaN; the port's are finite, and its loss is the JAX package's."""
    jcfg = jax_smoke("mamba2-370m")
    cfg = get_smoke_config("mamba2-370m")
    params = jax_model(jcfg).init_params(jax.random.PRNGKey(0))
    params["layers"]["ssm"]["A_log"] = params["layers"]["ssm"]["A_log"] + 8
    batch = _batch(cfg.vocab_size)
    (want, _), jgrads = jax.value_and_grad(jax_model(jcfg).loss_fn,
                                           has_aux=True)(params, batch)
    assert bool(jnp.isnan(jgrads["layers"]["ssm"]["A_log"]).any())
    ported = params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    leaves = [p.requires_grad_(True) for p in flat_params(ported).values()]
    loss, _ = get_model(cfg, "cpu").loss_fn(ported, batch)
    assert abs(loss.item() - float(want)) <= LOSS_TOL
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_serving_calls_skip_the_functions():
    """Without a gradient to take, the wrappers are called directly (no
    inputs saved)."""
    q = _rand((1, 5, 2, 8), 1)
    with torch.no_grad():
        out = _grad.apply(fa_ops.flash_attention, flash_attention_ref,
                          q, q, q)
    assert out.grad_fn is None
    x = _rand((4, 8), 2).requires_grad_(True)

    def norm():
        return _grad.apply(rn_ops.rmsnorm, rmsnorm_ref, x, torch.ones(8))
    assert norm().grad_fn is not None
    with torch.inference_mode():
        assert norm().grad_fn is None


# ---------------------------------------------------------------------------
# optimizer, compression, cast, data
# ---------------------------------------------------------------------------


def test_cosine_lr_matches_jax():
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=40, min_lr_frac=0.1)
    port, ref = AdamWConfig(**kw), RefAdamW(**kw)
    for s in range(0, 45):
        got = float(cosine_lr(port, torch.tensor(s, dtype=torch.int32)))
        want = float(ref_lr(ref, jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= OPT_TOL * max(1.0, abs(want)), s


def _opt_problem(arch="mamba2-370m"):
    """A stacked parameter tree and 3 gradient trees (numpy, seeded)."""
    cfg = jax_smoke(arch)
    tree = jax.tree.map(np.asarray, jax_model(cfg).init_params(
        jax.random.PRNGKey(2)))
    rs = np.random.RandomState(9)
    grads = [jax.tree.map(lambda a: (rs.randn(*a.shape) * 0.3).astype(
        np.float32), tree) for _ in range(3)]
    return cfg, tree, grads


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_steps_match_jax(n_steps, weight_decay):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=weight_decay, grad_clip=1.0)
    jcfg, tree, grads = _opt_problem()
    cfg = get_smoke_config("mamba2-370m")
    ref_state = ref_init(jax.tree.map(jnp.asarray, tree))
    port_state = adamw_init(params_from_numpy(cfg, tree, "cpu"))
    for g in grads[:n_steps]:
        ref_state, rm = ref_update(RefAdamW(**kw), ref_state,
                                   jax.tree.map(jnp.asarray, g))
        port_state, pm = adamw_update(AdamWConfig(**kw), port_state,
                                      params_from_numpy(cfg, g, "cpu"))
        assert abs(float(pm["grad_norm"]) - float(rm["grad_norm"])) \
            <= OPT_TOL * float(rm["grad_norm"])
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]),
                                                rel=OPT_TOL)
    got = state_to_numpy(port_state)
    want = jax.tree.map(np.asarray, ref_state)
    assert int(got["step"]) == int(want["step"]) == n_steps
    for part in ("master", "mu", "nu"):
        g, w = dict(_leaves_with_names(got[part])), \
            dict(_leaves_with_names(want[part]))
        assert g.keys() == w.keys()
        for name in w:
            np.testing.assert_allclose(g[name], w[name], rtol=OPT_TOL,
                                       atol=OPT_TOL, err_msg=name)


def test_weight_decay_reaches_the_stacked_per_layer_leaves():
    """The JAX package decays leaves of rank >= 2 in its stacked layout:
    every per-layer leaf (norm scales, A_log, dt_bias, D) is decayed, the
    top-level final_norm is not."""
    _, tree, grads = _opt_problem()
    cfg = get_smoke_config("mamba2-370m")
    out = {}
    for wd in (0.1, 0.0):
        st = adamw_init(params_from_numpy(cfg, tree, "cpu"))
        st, _ = adamw_update(AdamWConfig(lr=1e-2, warmup_steps=0,
                                         weight_decay=wd), st,
                             params_from_numpy(cfg, grads[0], "cpu"))
        out[wd] = st["master"]
    for lp_d, lp_0 in zip(out[0.1]["layers"], out[0.0]["layers"]):
        for name in ("A_log", "D", "dt_bias", "gate_norm"):   # not zero
            assert not torch.equal(lp_d["ssm"][name], lp_0["ssm"][name])
        assert not torch.equal(lp_d["ln1"]["scale"], lp_0["ln1"]["scale"])
    assert torch.equal(out[0.1]["final_norm"]["scale"],
                       out[0.0]["final_norm"]["scale"])


def test_adamw_update_leaves_the_state_as_it_was():
    _, tree, grads = _opt_problem()
    cfg = get_smoke_config("mamba2-370m")
    st = adamw_init(params_from_numpy(cfg, tree, "cpu"))
    before = state_to_numpy(st)
    adamw_update(AdamWConfig(), st, params_from_numpy(cfg, grads[0], "cpu"))
    after = state_to_numpy(st)
    for (n, a), (_, b_) in zip(_leaves_with_names(before),
                               _leaves_with_names(after)):
        np.testing.assert_array_equal(a, b_, err_msg=n)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast_params_matches_jax(dtype):
    jcfg = jax_smoke("hymba-1.5b")
    cfg = get_smoke_config("hymba-1.5b")
    tree = jax.tree.map(np.asarray, jax_model(jcfg).init_params(
        jax.random.PRNGKey(3)))
    want = jax.tree.map(np.asarray, ref_cast(
        jax.tree.map(jnp.asarray, tree), jnp.dtype(dtype)))
    params = port_steps.cast_params(params_from_numpy(cfg, tree, "cpu"),
                                    getattr(torch, dtype))
    assert all(p.requires_grad for p in flat_params(params).values())
    got = params_to_numpy(params)
    for (n, g), (_, w) in zip(reference_leaves(got),
                              reference_leaves(want)):
        assert str(w.dtype) == (str(g.dtype).replace("torch.", "")
                                if isinstance(g, torch.Tensor)
                                else str(g.dtype)), n
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=n)


def test_ef_int8_matches_jax():
    rs = np.random.RandomState(0)
    g = (rs.randn(257) * 1e-3).astype(np.float32)
    err = (rs.randn(257) * 1e-5).astype(np.float32)
    q, scale, new_err = ef_int8_compress(torch.from_numpy(g),
                                         torch.from_numpy(err))
    rq, rscale, rerr = ref_ef(jnp.asarray(g), jnp.asarray(err))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == pytest.approx(float(rscale), rel=1e-7)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(rerr),
                               atol=1e-9, rtol=1e-6)
    np.testing.assert_allclose(ef_int8_decompress(q, scale).numpy(),
                               np.asarray(rq, np.float32) * float(rscale),
                               rtol=1e-6)
    # a shared scale is used as given
    q2, s2, _ = ef_int8_compress(torch.from_numpy(g), torch.zeros(257),
                                 scale=torch.tensor(1e-4))
    rq2, _, _ = ref_ef(jnp.asarray(g), jnp.zeros(257),
                       scale=jnp.float32(1e-4))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(rq2))


@pytest.mark.parametrize("step,rank", [(0, 0), (5, 0), (3, 2)])
def test_synthetic_batch_identical(step, rank):
    kw = dict(vocab_size=503, seq_len=19, batch_size=3, seed=4)
    got = synthetic_batch(SyntheticConfig(**kw), step, rank)
    want = ref_batch(RefSynth(**kw), step, rank)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_corpus_and_dataset_identical(tmp_path):
    paths = [str(tmp_path / n) for n in ("port.bin", "ref.bin")]
    write_corpus(paths[0], 300001, 503, seed=5)
    ref_corpus(paths[1], 300001, 503, seed=5)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    port = TokenFileDataset(paths[0], 31, 4, rank=1, nranks=3, vocab=503)
    ref = RefDataset(paths[1], 31, 4, rank=1, nranks=3, vocab=503)
    try:
        for step in (0, 1, 7, 1000):
            a, b_ = port.batch(step), ref.batch(step)
            for k in b_:
                np.testing.assert_array_equal(a[k], b_[k])
    finally:
        port.close()
        ref.close()


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

ARCH = "qwen1.5-0.5b"
TCFG = dict(seq_len=24, batch_size=4, seed=0)


def _port_data(cfg):
    dcfg = SyntheticConfig(vocab_size=cfg.vocab_size, **TCFG)
    return lambda step: synthetic_batch(dcfg, step)


def _step0_checkpoint(ckpt_dir, seed=0, arch=ARCH, loss_chunk=0):
    """The JAX package's step-0 train state, written by its engine."""
    cfg = jax_smoke(arch).replace(loss_chunk=loss_chunk)
    params = jax_model(cfg).init_params(jax.random.PRNGKey(seed))
    state = jax.tree.map(np.asarray, ref_init(params))
    RefEngine(ckpt_dir, keep=5).save(state, 0, meta={"next_step": 0})
    return cfg


def _port_trainer(tmp, n, ocfg=None, **kw):
    cfg = get_smoke_config(ARCH).replace(loss_chunk=0)
    ocfg = ocfg or AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=n)
    tcfg = TrainerConfig(num_steps=n, ckpt_dir=str(tmp),
                         **{k: v for k, v in kw.items()
                            if k != "fault_hook"})
    return Trainer(cfg, tcfg, ocfg, data=_port_data(cfg), device="cpu",
                   fault_hook=kw.get("fault_hook"))


def test_trainer_matches_jax_trainer(tmp_path):
    """Both packages auto-resume the same step-0 checkpoint and take 5
    steps: loss and grad norm per step within 1e-4."""
    base = str(tmp_path / "step0")
    jcfg = _step0_checkpoint(base)
    for name in ("ref", "port"):
        shutil.copytree(base, str(tmp_path / name))
    dcfg = RefSynth(vocab_size=jcfg.vocab_size, **TCFG)
    ref = RefTrainer(jcfg, RefTrainerConfig(
        num_steps=5, ckpt_dir=str(tmp_path / "ref"), ckpt_every=0),
        RefAdamW(lr=1e-3, warmup_steps=2, total_steps=5),
        data=lambda s: ref_batch(dcfg, s))
    ref.run()
    port = _port_trainer(tmp_path / "port", 5, ckpt_every=0)
    res = port.run()
    assert port.start_step == 0 and res["final_step"] == 5
    assert len(port.metrics_log) == len(ref.metrics_log) == 5
    for got, want in zip(port.metrics_log, ref.metrics_log):
        assert got["step"] == want["step"]
        for key in ("loss", "grad_norm", "nll", "ntok", "lr"):
            assert abs(got[key] - want[key]) <= TRAIN_TOL * max(
                1.0, abs(want[key])), (got["step"], key)


def test_grad_accum_matches_full_batch(monkeypatch):
    """accum_steps=2 sums the micro-batch gradients and halves them: the
    gradients reaching AdamW equal the full batch's (atol as the JAX
    package's test), the loss their mean."""
    cfg = get_smoke_config(ARCH).replace(loss_chunk=0)
    seen = []
    real = port_steps.adamw_update

    def spy(ocfg, state, grads):
        seen.append(params_to_numpy(grads))
        return real(ocfg, state, grads)
    monkeypatch.setattr(port_steps, "adamw_update", spy)
    gen = torch.Generator().manual_seed(0)
    state = adamw_init(get_model(cfg, "cpu").init_params(gen))
    batch = _port_data(cfg)(0)
    metrics = []
    for accum in (1, 2):
        step = port_steps.make_train_step(cfg, AdamWConfig(),
                                          accum_steps=accum, device="cpu")
        metrics.append(step(state, batch)[1])
    for (n, a), (_, b_) in zip(_leaves_with_names(seen[0]),
                               _leaves_with_names(seen[1])):
        np.testing.assert_allclose(a, b_, atol=3e-5, err_msg=n)
    assert float(metrics[1]["loss"]) == pytest.approx(
        float(metrics[0]["loss"]), abs=1e-5)


def test_checkpoint_resume_continuity(tmp_path):
    t1 = _port_trainer(tmp_path, 10, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=20),
                       ckpt_every=5)
    t1.run()
    t2 = _port_trainer(tmp_path, 12, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=20),
                       ckpt_every=5)
    t2.init_state()
    assert t2.start_step == 10
    a, b_ = state_to_numpy(t1.state), state_to_numpy(t2.state)
    for (n, x), (_, y) in zip(_leaves_with_names(a), _leaves_with_names(b_)):
        np.testing.assert_array_equal(x, y, err_msg=n)
    assert t2.run()["final_step"] == 12


def test_step_retry_and_restore_on_fault(tmp_path):
    calls = {"n": 0}

    def fault(step):
        if step == 7:
            calls["n"] += 1
            if calls["n"] <= 4:       # 2 retries + 2 after-restore retries
                raise RuntimeError("injected node failure")

    tr = _port_trainer(tmp_path, 9, ckpt_every=5, retry_max=1,
                       fault_hook=fault)
    res = tr.run()
    assert res["final_step"] == 9
    assert calls["n"] >= 3            # retried, restored, retried again
    # two restores from the step-5 checkpoint: steps 5 and 6 ran 3 times
    assert [m["step"] for m in tr.metrics_log] == [0, 1, 2, 3, 4, 5, 6,
                                                   5, 6, 5, 6, 7, 8]


def test_straggler_detector():
    det = StragglerDetector(z=3.0, warmup=5)
    for i in range(20):
        det.update(i, 0.1 + (0.001 * (i % 3)))
    assert det.update(20, 5.0) is True
    assert 20 in det.flagged
    assert det.update(21, 0.1) is False


def test_trainer_flags_a_slow_step(tmp_path, monkeypatch):
    """The loop's step times come from a fake clock: 0.1 s a step with a
    little spread, and 5 s more at step 11.  The step's ``train.step``
    span reads the clock for the loop."""
    from repro_torch import spans

    class Clock:
        t = 0.0

        def perf_counter_ns(self):
            return round(self.t * 1e9)
    clock = Clock()
    monkeypatch.setattr(spans, "time", clock)

    def slow(step):
        clock.t += 0.1 + 0.001 * (step % 3) + (5.0 if step == 11 else 0.0)

    tr = _port_trainer(tmp_path, 12, ckpt_every=0, fault_hook=slow)
    assert tr.run()["stragglers"] == [11]
    assert tr.metrics_log[11]["step_time_s"] == pytest.approx(5.1 + 0.002)


def test_async_checkpoint(tmp_path):
    from repro_torch.checkpoint import latest_step
    tr = _port_trainer(tmp_path, 6, ckpt_every=3, async_ckpt=True)
    assert tr.run()["final_step"] == 6
    assert latest_step(str(tmp_path)) == 6
    assert tr.engine._thread is None


def test_trainer_needs_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)))


def test_cli_trains_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--smoke", "--device", "cpu", "--steps", "4",
         "--batch", "2", "--seq", "16", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path / "ckpt"),
         "--trace-dir", str(tmp_path / "trace")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert '"final_step": 4' in proc.stdout and "traced" in proc.stdout
    steps = [r for r in TraceReader(str(tmp_path / "trace")).iter_records(0)
             if r.func == "step"]
    assert [r.arg("step_idx") for r in steps] == [0, 1, 2, 3]
    assert train_cli.build_parser().parse_args(
        ["--arch", "x"]).device == "cuda"


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "deepseek-v2-lite-16b", "llava-next-34b"])
def test_cli_trains_moe_mla_and_vlm_on_the_cpu(arch, tmp_path, capsys):
    """Two steps and a checkpoint; the MoE models' loss holds aux."""
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--ckpt-every", "2", "--ckpt-dir",
                    str(tmp_path / "ckpt")])
    out = json.loads(capsys.readouterr().out)
    assert out["result"]["final_step"] == 2
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])


# ---------------------------------------------------------------------------
# a traced run in both packages
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-6
        return self.t


def _traced_run(pkg, workdir, make_trainer):
    """4 steps, a checkpoint every 2, traced; returns the trace dir."""
    ckpt = os.path.join(workdir, "ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    _step0_checkpoint(ckpt)
    tdir = os.path.join(workdir, f"trace-{pkg.__name__.split('.')[0]}")
    real = time.perf_counter
    time.perf_counter = _FakeClock()
    try:
        kw = dict(trace_dir=tdir)
        if pkg is port_recorder:
            kw["encode_backend"] = "numpy"
        with pkg.session(pkg.RecorderConfig(**kw)):
            make_trainer(ckpt).run()
    finally:
        time.perf_counter = real
    return tdir


def _masked(data):
    """Every label masked: the loss and the gradients are exactly 0, so
    the state after each step is the same in both packages bit for bit
    (master unchanged with weight decay 0, moments 0) and so are the
    manifests' crc32 fields, whose decimal length the trace records as
    a write size."""
    def batch(step):
        b = data(step)
        b["labels"] = np.full_like(b["labels"], -1)
        return b
    return batch


def test_traced_run_matches_jax(tmp_path):
    jcfg = jax_smoke(ARCH).replace(loss_chunk=0)
    cfg = get_smoke_config(ARCH).replace(loss_chunk=0)
    tkw = dict(num_steps=4, ckpt_every=2, keep=2)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.0)
    dcfg = RefSynth(vocab_size=jcfg.vocab_size, **TCFG)
    work = str(tmp_path)

    def ref(ckpt):
        return RefTrainer(jcfg, RefTrainerConfig(ckpt_dir=ckpt, **tkw),
                          RefAdamW(**okw),
                          data=_masked(lambda s: ref_batch(dcfg, s)))

    def port(ckpt):
        return Trainer(cfg, TrainerConfig(ckpt_dir=ckpt, **tkw),
                       AdamWConfig(**okw), data=_masked(_port_data(cfg)),
                       device="cpu")

    readers = [RefReader(_traced_run(ref_recorder, work, ref)),
               TraceReader(_traced_run(port_recorder, work, port))]
    # repr: each package has its own Handle class
    recs = [[(r.func, repr(r.args), r.depth) for r in rd.iter_records(0)]
            for rd in readers]
    assert recs[0] == recs[1]
    funcs = [f for f, _, _ in recs[1]]
    assert funcs.count("step") == 4 and funcs.count("ckpt_end") == 2
    assert funcs.count("shard_write_at") == 2 * (3 * 15 + 1 + 1)
    assert readers[0].merged_cst == readers[1].merged_cst
    assert readers[0].unique_cfgs == readers[1].unique_cfgs
    assert list(readers[0].cfg_index) == list(readers[1].cfg_index)
