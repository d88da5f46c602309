"""Serving launcher: prefill a batch of prompts, greedy-decode, report
tokens/s; optionally trace the serving loop with the port's Recorder.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --new-tokens 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
        --smoke --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-moe-16b --smoke --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-large-v2 --smoke --device cpu

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it fails.  Every family is ported (dense, MoE,
MLA, SSM, hybrid, VLM, encoder-decoder).  Weights are random, drawn from a
``torch.Generator`` seeded with 0 on the chosen device.  The prompts are
the JAX package's launcher's (:func:`build_batch`): tokens from numpy seed
0; a VLM's ``n_patches`` patch embeddings a prompt are zeros (the vision
tower is a stub); an encoder-decoder's ``prompt_len`` frames a prompt (the
speech frontend is a stub) are drawn from the same generator after the
tokens.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core import encode_backend
from ..core.recorder import RecorderConfig, session
from ..models import get_model, model_device
from ..serve import ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="Greedy serving of a model with the port")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke configuration")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default cuda; cpu also "
                         "selects the numpy encode backend for --trace-dir)")
    ap.add_argument("--trace-dir", default=None,
                    help="trace the serving loop into this directory")
    return ap


def build_batch(cfg, batch: int, prompt_len: int) -> Dict[str, np.ndarray]:
    """The prompt batch of the JAX package's launcher
    (``launch/serve.py:38-46``): ``batch`` x ``prompt_len`` tokens from
    numpy seed 0; zero patches for a VLM; for an encoder-decoder
    ``prompt_len`` frames a prompt, normal, from the same generator after
    the tokens."""
    rng = np.random.RandomState(0)
    out = {"tokens": rng.randint(0, cfg.vocab_size, size=(batch, prompt_len)
                                 ).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = np.zeros((batch, cfg.n_patches, cfg.d_model),
                                  np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.randn(batch, prompt_len, cfg.d_model
                                  ).astype(np.float32)
    return out


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    device = model_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg, device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    batch = build_batch(cfg, args.batch, args.prompt_len)

    def run():
        eng = ServeEngine(cfg, params, max_seq=args.max_seq, device=device)
        t0 = time.perf_counter()
        toks = eng.generate(batch, args.new_tokens)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "generated_shape": list(toks.shape),
            "tokens_per_s": round(toks.size / dt, 1),
            "prefill_s": eng.stats["prefill_s"],
            "decode_s": eng.stats["decode_s"],
            "device": str(device),
            "first_sequence": toks[0][:16].tolist(),
        }, indent=1))

    if args.trace_dir:
        # grammar packing follows the module default, so set it too
        backend = "cuda" if device.type == "cuda" else "numpy"
        prev = encode_backend.default_backend()
        encode_backend.set_default_backend(backend)
        try:
            with session(RecorderConfig(trace_dir=args.trace_dir,
                                        encode_backend=backend)) as rec:
                run()
                print(f"traced {rec.n_records} records -> {args.trace_dir}")
        finally:
            encode_backend.set_default_backend(prev)
    else:
        run()


if __name__ == "__main__":
    main()
