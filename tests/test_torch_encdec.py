"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package, on the CPU.

The smoke configuration (2 encoder + 2 decoder layers, d 64, 8 heads,
LayerNorm) with the JAX package's parameters carried across
(``tests/_torch_parity.py``), frames and tokens from numpy seeds, both
``attn_impl``:

- ``train_forward`` logits, ``prefill`` logits and every cache leaf (k, v,
  xk, xv), 8 greedy ``decode_step``s from a seated cache and the JAX
  ``ServeEngine``'s tokens, at prompt lengths 37 and 2, with as many
  frames as the decode cache holds (``S_enc == max_seq``, where the JAX
  package's decode attends to the encoder alone): f32 1e-4, tokens exact;
- ``loss_fn`` within 1e-5 and every gradient leaf within relative L2 1e-4
  of ``jax.grad``; the ``Trainer`` from the JAX package's step-0
  checkpoint, loss and grad norm a step within 1e-4 of the JAX
  ``Trainer``'s on the launchers' data;
- with fewer frames than ``max_seq``, the port's teacher-forced decode
  logits within 1e-4 of its own ``train_forward``; the JAX package's
  decode there weighs the zero keys behind the encoder's, and the test
  that records its gap holds it above 0.1;
- a request past ``max_seq`` and frames longer than ``max_seq`` are
  refused with ``ValueError`` before any prefill;
- parameters and a train state carried across and back bit for bit, the
  checkpoint bytes the JAX package's, ``cast_params``' dtypes;
- ``launch.serve`` and ``launch.train`` with ``--smoke --device cpu`` in
  a subprocess.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointEngine as RefEngine
from repro.checkpoint import save_sharded as ref_save
from repro.configs import get_smoke_config as jax_smoke
from repro.data import SyntheticConfig as RefSynth
from repro.data import synthetic_batch as ref_batch
from repro.launch.steps import cast_params as ref_cast
from repro.models import encdec as jax_encdec
from repro.models import get_model as jax_model
from repro.models import layers as jax_layers
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro.serve.engine import _seat as jax_seat
from repro.train import Trainer as RefTrainer
from repro.train import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint import restore_sharded, save_sharded
from repro_torch.configs import get_smoke_config
from repro_torch.core import encode_backend as eb
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import steps as port_steps
from repro_torch.launch.train import build_data
from repro_torch.models import encdec, get_model
from repro_torch.models.convert import (flat_params, params_from_numpy,
                                        params_to_numpy, reference_leaves,
                                        state_from_numpy, state_shapes,
                                        state_to_numpy)
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import _seat
from repro_torch.train import Trainer, TrainerConfig

from _torch_parity import (B, MAX_SEQ, TOL, check_against_jax,
                           check_bf16_bit_for_bit, check_init_shapes,
                           check_loss_and_grads, close, jax_loss,
                           jax_reference, make_batch)

ARCH = "seamless-m4t-large-v2"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# teacher forcing: a prefix of PREFIX target tokens, then STEPS decode
# steps fed the true next tokens, against train_forward over all of them
PREFIX, STEPS, SHORT_MAX = 8, 8, 32
# the JAX package's decode with 8 frames and max_seq 32: its logits are
# off its train_forward's by 1.85-3.42 at each of the 7 steps on this
# smoke model (0.93-1.24 with 17 frames; 1.4e-6 to 2.2e-6 with 32); held
# above GAP_FLOOR, 18 times under the smallest reading and 1,000 times
# over TOL
GAP_FLOOR = 0.1


@pytest.fixture(scope="module", params=[37, 2], ids=lambda s: f"S{s}")
def ref(request):
    return jax_reference(ARCH, request.param)


@pytest.fixture(scope="module")
def tree():
    """The JAX package's smoke parameters (key 0), as numpy."""
    return jax.tree.map(np.asarray, jax_model(jax_smoke(ARCH)).init_params(
        jax.random.PRNGKey(0)))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_forward_prefill_decode_match_jax(ref, impl):
    check_against_jax(ref, attn_impl=impl)


def test_caches_hold_the_encoder_and_the_prefix(ref):
    """The prefill's cross K/V cover every frame, its self-attention KV
    the target prefix; ``pos`` counts the target tokens only."""
    cfg = get_smoke_config(ARCH)
    S = ref["S"]
    assert ref["prompt"] == S
    assert ref["pf_cache"]["layers"]["k"].shape[2] == S
    assert ref["pf_cache"]["layers"]["xk"].shape[2] == MAX_SEQ
    model = get_model(cfg, "cpu")
    params = params_from_numpy(cfg, ref["tree"], "cpu")
    _, cache = model.prefill(params, ref["batch"])
    assert cache["pos"].tolist() == [S] * B
    assert cache["xlen"].tolist() == [MAX_SEQ] * B
    seated = _seat(model.init_cache(B, MAX_SEQ), cache)
    assert seated["xlen"].tolist() == [MAX_SEQ] * B
    assert seated["layers"][0]["k"].shape == (B, MAX_SEQ, cfg.n_kv_heads,
                                              cfg.hd)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_loss_and_grads_match_jax(impl):
    ref = jax_loss(ARCH, 32)
    check_loss_and_grads(ref, attn_impl=impl)
    assert ref["ntok"] == B * 32 and ref["aux"] == 0.0


def test_bf16_params_carry_bit_for_bit():
    flat = check_bf16_bit_for_bit(ARCH)
    assert flat["dec_layers.1.xattn.wq"].dtype == torch.bfloat16
    assert flat["enc_layers.1.ln1.bias"].dtype == torch.float32


def test_init_params_shapes_and_dtypes():
    check_init_shapes(ARCH)


def test_flash_attention_runs_both_self_attentions(monkeypatch):
    """A prefill calls the flash kernel's wrapper once an encoder layer
    without a causal mask (over the frames) and once a decoder layer with
    one (over the prefix); cross attention takes the plain path."""
    calls = []
    real = fa_ops.flash_attention

    def shim(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw.get("causal")))
        return real(q, k, v, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention", shim)
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    batch = make_batch(cfg, 5, s_enc=11)
    with torch.inference_mode():
        model.prefill(params, batch)
    enc = (B, 11, cfg.n_heads, cfg.hd)
    dec = (B, 5, cfg.n_heads, cfg.hd)
    assert calls == [(enc, enc, False)] * cfg.n_encoder_layers \
        + [(dec, dec, True)] * cfg.n_layers


def test_unseated_cache_decodes_as_jax(tree):
    """A fresh cache holds zero cross K/V, all of them valid, as the JAX
    package's: 4 decode steps from it give the JAX package's tokens."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    m = jax_model(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    jc, jt = m.init_cache(B, 16), jnp.zeros((B, 1), jnp.int32) + 7
    model = get_model(cfg, "cpu")
    pp = params_from_numpy(cfg, tree, "cpu")
    pc, pt = model.init_cache(B, 16), torch.full((B, 1), 7, dtype=torch.int32)
    for _ in range(4):
        jt, jc = m.decode_step(params, jc, jt)
        pt, pc = model.decode_step(pp, pc, pt)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    close(pc["layers"][1]["k"], jc["layers"]["k"][1])


def test_bf16_paths_differ_within_the_card_bound_a_layer():
    """The bf16 smoke model's prefill logits, kernel path (on the CPU, the
    kernel's plain version, p kept in f32) against the ``"torch"`` path (p
    rounded to bf16), relative L2, weight seeds 0-2: each within the bound
    ``chip_smoke.py`` holds the full model to (0.2 over its 48 attention
    layers) times this model's 4.  The readings are 1.32e-2 to 1.62e-2."""
    cfg = get_smoke_config(ARCH).replace(dtype="bfloat16",
                                         param_dtype="bfloat16")
    n_attn = cfg.n_layers + cfg.n_encoder_layers
    for seed in range(3):
        params = get_model(cfg, "cpu").init_params(
            torch.Generator().manual_seed(seed))
        batch = {"tokens": np.random.RandomState(seed).randint(
                     0, cfg.vocab_size, (B, 37)).astype(np.int32),
                 "frames": np.random.RandomState(seed + 10).randn(
                     B, 48, cfg.d_model).astype(np.float32)}
        with torch.inference_mode():
            got, _ = get_model(cfg, "cpu").prefill(params, batch)
            want, _ = get_model(cfg.replace(attn_impl="torch"),
                                "cpu").prefill(params, batch)
        rel = float((got - want).norm() / want.norm())
        assert 0 < rel <= 0.2 / 48 * n_attn, (seed, rel)


# ---------------------------------------------------------------------------
# fewer frames than max_seq: the cross-attention length
# ---------------------------------------------------------------------------


def _teacher_batch(cfg, s_enc: int) -> dict:
    return make_batch(cfg, PREFIX + STEPS, s_enc=s_enc)


def teacher_forced_gap(cfg, params, s_enc: int) -> float:
    """Max abs difference of the port's decode logits, fed the true next
    tokens after a PREFIX-token prefill seated in a SHORT_MAX cache,
    against ``train_forward`` at the same positions."""
    batch = _teacher_batch(cfg, s_enc)
    model = get_model(cfg, "cpu")
    with torch.inference_mode():
        full, _ = model.train_forward(params, batch)
        tok = batch["tokens"]
        pf = dict(batch, tokens=tok[:, :PREFIX])
        logits, cache = model.prefill(params, pf)
        cache = _seat(model.init_cache(B, SHORT_MAX), cache)
        gap = float((logits - full[:, PREFIX - 1]).abs().max())
        for i in range(PREFIX, PREFIX + STEPS - 1):
            lg, cache = encdec.step_logits(cfg, params, cache,
                                           tok[:, i:i + 1])
            gap = max(gap, float((lg[:, 0] - full[:, i]).abs().max()))
    return gap


@pytest.mark.parametrize("s_enc", [8, 17, SHORT_MAX])
@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_decode_matches_the_teacher_forced_forward(tree, s_enc, impl):
    cfg = get_smoke_config(ARCH).replace(attn_impl=impl)
    params = params_from_numpy(cfg, tree, "cpu")
    assert teacher_forced_gap(cfg, params, s_enc) <= TOL


def _jax_step_logits(cfg, params, cache, tokens):
    """The JAX package's ``decode_step`` body, layer by layer, up to the
    logits (``encdec.py:228-243``)."""
    pos = cache["pos"]
    x = params["dec_embed"].astype(jnp.dtype(cfg.dtype))[tokens]
    new = []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], params["dec_layers"])
        lc = jax.tree.map(lambda a: a[i], cache["layers"])
        x, c = jax_encdec.dec_block_decode(lp, cfg, x, lc, pos)
        new.append(c)
    x = jax_layers.apply_norm(x, params["final_norm"], cfg)
    logits = jnp.einsum("bsd,vd->bsv", x, params["lm_head"].astype(x.dtype),
                        preferred_element_type=jnp.float32)
    return logits, {"layers": jax.tree.map(lambda *a: jnp.stack(a), *new),
                    "pos": pos + 1}


@pytest.mark.parametrize("s_enc", [8, SHORT_MAX])
def test_reference_decode_weighs_the_padding(s_enc):
    """A caveat of the reference, recorded: its decode masks cross
    attention to the cache's length, which its engine sizes at max_seq.
    With as many frames as that, its teacher-forced decode is its
    train_forward; with fewer, it is off by more than GAP_FLOOR."""
    cfg = jax_smoke(ARCH)
    m = jax_model(cfg)
    params = m.init_params(jax.random.PRNGKey(0))
    batch = _teacher_batch(cfg, s_enc)
    tok = batch["tokens"]
    full, _ = m.train_forward(params, batch)
    logits, pf = m.prefill(params, dict(batch, tokens=tok[:, :PREFIX]))
    cache = jax_seat(cfg, m.init_cache(B, SHORT_MAX), pf, PREFIX)
    gap = float(jnp.abs(logits - full[:, PREFIX - 1]).max())
    for i in range(PREFIX, PREFIX + STEPS - 1):
        lg, cache = _jax_step_logits(cfg, params, cache, tok[:, i:i + 1])
        gap = max(gap, float(jnp.abs(lg[:, 0] - full[:, i]).max()))
    if s_enc == SHORT_MAX:
        assert gap <= TOL
    else:
        assert gap > GAP_FLOOR
        # the port, on the same parameters and inputs
        pcfg = get_smoke_config(ARCH)
        pparams = params_from_numpy(pcfg, jax.tree.map(np.asarray, params),
                                    "cpu")
        assert teacher_forced_gap(pcfg, pparams, s_enc) <= TOL


@pytest.mark.parametrize("case", ["overrun", "long_encoder"])
def test_refused_before_prefill(case, monkeypatch):
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, max_seq=SHORT_MAX, device="cpu")

    def no_prefill(*a, **kw):
        raise AssertionError("prefill ran")
    monkeypatch.setattr(eng.model, "prefill", no_prefill)
    if case == "overrun":
        # 8 target tokens + 26 new: the last step writes position 33 > 32
        batch, n_new, match = make_batch(cfg, 8, s_enc=8), 26, "max_seq"
    else:
        batch, n_new, match = make_batch(cfg, 8, s_enc=SHORT_MAX + 1), 2, \
            "encoder frames"
    with pytest.raises(ValueError, match=match):
        eng.generate(batch, n_new)
    assert eng.stats == {}


def test_at_the_limit_the_engine_decodes(tree):
    """8 target tokens + 25 new write position 32 of 32: served."""
    cfg = get_smoke_config(ARCH)
    params = params_from_numpy(cfg, tree, "cpu")
    eng = ServeEngine(cfg, params, max_seq=SHORT_MAX, device="cpu")
    toks = eng.generate(make_batch(cfg, 8, s_enc=8), 25)
    assert toks.shape == (B, 25) and int(toks.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# conversion, checkpoints, cast_params, the Trainer
# ---------------------------------------------------------------------------


def _ref_state():
    """The JAX package's AdamW state of the smoke model after one step."""
    cfg = jax_smoke(ARCH)
    params = jax_model(cfg).init_params(jax.random.PRNGKey(5))
    rs = np.random.RandomState(5)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rs.randn(*p.shape).astype(np.float32)), params)
    state, _ = ref_update(RefAdamW(lr=1e-2, warmup_steps=0),
                          ref_init(params), grads)
    return jax.tree.map(np.asarray, state)


def test_convert_round_trip_is_bit_for_bit():
    cfg = get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jax_model(jax_smoke(ARCH)).init_params(
        jax.random.PRNGKey(6)))
    params = params_from_numpy(cfg, tree, "cpu")
    assert len(params["enc_layers"]) == cfg.n_encoder_layers
    assert len(params["dec_layers"]) == cfg.n_layers
    assert set(params["dec_layers"][0]) == {"ln1", "attn", "lnx", "xattn",
                                            "ln2", "mlp"}
    back = reference_leaves(params_to_numpy(params))
    want = reference_leaves(tree)
    assert [n for n, _ in back] == [n for n, _ in want]
    for (n, g), (_, w) in zip(back, want):
        assert g.dtype == w.dtype and g.shape == w.shape, n
        assert g.tobytes() == w.tobytes(), n


def test_checkpoint_is_the_reference_byte_for_byte(tmp_path):
    ref = _ref_state()
    cfg = get_smoke_config(ARCH)
    state = state_from_numpy(cfg, ref, "cpu")
    assert len(state["mu"]["dec_layers"]) == cfg.n_layers
    a = save_sharded(state_to_numpy(state), str(tmp_path / "port"), 3,
                     meta={"next_step": 3})
    b = ref_save(ref, str(tmp_path / "ref"), 3, meta={"next_step": 3})
    for name in ("arrays.bin", "manifest.json"):
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    got, _ = restore_sharded(state_shapes(state), b)
    back = state_from_numpy(cfg, got, "cpu")
    for (n, x), (_, y) in zip(flat_params(back).items(),
                              flat_params(state).items()):
        assert x.dtype == y.dtype and torch.equal(x, y), n


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cast_params_matches_jax(dtype):
    """Per-layer leaves (LayerNorm scales and biases too) go to the
    compute dtype, the top-level norms (enc_norm, final_norm) stay f32."""
    cfg = get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jax_model(jax_smoke(ARCH)).init_params(
        jax.random.PRNGKey(3)))
    want = jax.tree.map(np.asarray, ref_cast(
        jax.tree.map(jnp.asarray, tree), jnp.dtype(dtype)))
    got = params_to_numpy(port_steps.cast_params(
        params_from_numpy(cfg, tree, "cpu"), getattr(torch, dtype)))
    for (n, g), (_, w) in zip(reference_leaves(got),
                              reference_leaves(want)):
        gdt = str(g.dtype).replace("torch.", "")
        assert gdt == str(w.dtype), n
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_array_equal(g, np.asarray(w, np.float32),
                                      err_msg=n)


def test_trainer_matches_jax_trainer(tmp_path, monkeypatch):
    """Both packages auto-resume the JAX package's step-0 checkpoint and
    take 3 steps on their launchers' data (synthetic tokens, frames from
    numpy seed ``step``): loss and grad norm a step within 1e-4."""
    monkeypatch.setattr(eb, "_default_backend", "numpy")
    batch, seq = 2, 16
    jcfg = jax_smoke(ARCH)
    params = jax_model(jcfg).init_params(jax.random.PRNGKey(0))
    base = str(tmp_path / "step0")
    RefEngine(base, keep=5).save(jax.tree.map(np.asarray, ref_init(params)),
                                 0, meta={"next_step": 0})
    for name in ("ref", "port"):
        shutil.copytree(base, str(tmp_path / name))
    dcfg = RefSynth(vocab_size=jcfg.vocab_size, seq_len=seq,
                    batch_size=batch)

    def ref_data(step):     # the JAX launcher's recipe (train.py:46-56)
        b = ref_batch(dcfg, step)
        b["frames"] = np.random.RandomState(step).randn(
            batch, seq, jcfg.d_model).astype(np.float32)
        return b
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    ref = RefTrainer(jcfg, RefTrainerConfig(
        num_steps=3, ckpt_dir=str(tmp_path / "ref"), ckpt_every=0),
        RefAdamW(**ocfg), data=ref_data)
    ref.run()
    cfg = get_smoke_config(ARCH)
    port = Trainer(cfg, TrainerConfig(num_steps=3,
                                      ckpt_dir=str(tmp_path / "port"),
                                      ckpt_every=0),
                   AdamWConfig(**ocfg), data=build_data(cfg, batch, seq),
                   device="cpu")
    assert port.run()["final_step"] == 3 and port.start_step == 0
    for got, want in zip(port.metrics_log, ref.metrics_log, strict=True):
        for key in ("loss", "grad_norm", "nll", "ntok", "lr"):
            assert abs(got[key] - want[key]) <= 1e-4 * max(
                1.0, abs(want[key])), (got["step"], key)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


def _run(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m"] + args, env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_cli_serves_on_the_cpu(tmp_path):
    out = _run(["repro_torch.launch.serve", "--arch", ARCH, "--smoke",
                "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                "--new-tokens", "4", "--max-seq", "32"], tmp_path)
    out = json.loads(out)
    assert out["generated_shape"] == [2, 4] and out["device"] == "cpu"


def test_cli_trains_on_the_cpu(tmp_path):
    out = _run(["repro_torch.launch.train", "--arch", ARCH, "--smoke",
                "--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                "16", "--ckpt-every", "2", "--ckpt-dir",
                str(tmp_path / "ckpt")], tmp_path)
    out = json.loads(out)
    assert out["result"]["final_step"] == 2
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])
    assert os.path.isdir(tmp_path / "ckpt" / "step_00000002")
