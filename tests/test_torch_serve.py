"""The port's serving engine and CLI against the JAX package, on the CPU.

``ServeEngine.generate`` must give the JAX engine's greedy tokens on the
qwen3-32b smoke configuration (QK-norm, GQA) with the JAX package's
parameters carried across, on both ``attn_impl``, and on the mamba2-370m
and hymba-1.5b smoke configurations on both ``ssm_impl``.  The CLI runs
with ``--device cpu --smoke``, and a traced serving loop keeps a grammar
of the same size however many tokens it generates.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_model
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.reader import TraceReader
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine


@pytest.fixture(scope="module")
def jax_run():
    cfg = jax_smoke("qwen3-32b")
    params = jax_model(cfg).init_params(jax.random.PRNGKey(0))
    batch = {"tokens": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 37)).astype(np.int32)}
    toks = JaxEngine(cfg, params, max_seq=64).generate(batch, 8)
    return jax.tree.map(np.asarray, params), batch, toks


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_generate_matches_jax_engine(jax_run, impl):
    tree, batch, want = jax_run
    cfg = get_smoke_config("qwen3-32b").replace(attn_impl=impl)
    params = params_from_numpy(cfg, tree, "cpu")
    eng = ServeEngine(cfg, params, max_seq=64, device="cpu")
    got = eng.generate(batch, 8)
    assert got.shape == (2, 8) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert eng.stats["decode_steps"] == 7
    assert eng.stats["prefill_s"] > 0 and eng.stats["decode_s"] > 0


@pytest.fixture(scope="module", params=["mamba2-370m", "hymba-1.5b"])
def jax_ssm_run(request):
    arch = request.param
    cfg = jax_smoke(arch)
    params = jax_model(cfg).init_params(jax.random.PRNGKey(0))
    batch = {"tokens": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 37)).astype(np.int32)}
    toks = JaxEngine(cfg, params, max_seq=64).generate(batch, 8)
    return arch, jax.tree.map(np.asarray, params), batch, toks


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_ssm_and_hybrid_generate_match_jax_engine(jax_ssm_run, impl):
    arch, tree, batch, want = jax_ssm_run
    cfg = get_smoke_config(arch).replace(ssm_impl=impl)
    params = params_from_numpy(cfg, tree, "cpu")
    got = ServeEngine(cfg, params, max_seq=64, device="cpu").generate(
        batch, 8)
    np.testing.assert_array_equal(got, want)


def test_engine_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("qwen3-32b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, {}, max_seq=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "qwen3-32b", "--smoke"])


def test_cli_serves_on_the_cpu(capsys):
    serve_cli.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "37",
                    "--new-tokens", "8", "--max-seq", "64"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_shape"] == [2, 8]
    assert out["device"] == "cpu" and out["tokens_per_s"] > 0
    assert len(out["first_sequence"]) == 8


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_cli_serves_ssm_and_hybrid_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "32",
                    "--new-tokens", "4", "--max-seq", "64"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_shape"] == [2, 4] and out["device"] == "cpu"


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "deepseek-v2-lite-16b", "llava-next-34b"])
def test_cli_serves_moe_mla_and_vlm_on_the_cpu(arch, capsys):
    """The VLM's prompt holds its patches: 8 + 16 positions of 64."""
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "16",
                    "--new-tokens", "4", "--max-seq", "64"])
    out = json.loads(capsys.readouterr().out)
    assert out["generated_shape"] == [2, 4] and out["device"] == "cpu"


def _traced(tmp_path, n_new: int):
    tdir = os.path.join(tmp_path, f"serve{n_new}")
    serve_cli.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "16",
                    "--new-tokens", str(n_new), "--max-seq", "64",
                    "--trace-dir", tdir])
    return TraceReader(tdir)


def test_traced_serving_loop_has_a_constant_grammar(tmp_path, capsys):
    from repro_torch.core import encode_backend
    before = encode_backend.default_backend()
    short, long = _traced(tmp_path, 8), _traced(tmp_path, 32)
    assert encode_backend.default_backend() == before
    capsys.readouterr()
    for reader, n in ((short, 8), (long, 32)):
        recs = [r for r in reader.iter_records(0) if r.func == "serve_step"]
        assert [r.arg("step_idx") for r in recs] == list(range(n - 1))
    # rules and (symbol, exponent) pairs: only an exponent grows with n
    size = [[len(rule) for rule in r.unique_cfgs[r.cfg_index[0]]]
            for r in (short, long)]
    assert size[0] == size[1]
    assert len(short.merged_cst) == len(long.merged_cst)
