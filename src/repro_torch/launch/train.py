"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --smoke --device cpu --steps 50 --batch 4 --seq 64 --trace-dir d

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 20 --batch 4 --seq 1024 --ckpt-dir ckpt

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-large-v2 --smoke --device cpu --steps 2

Runs on the card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it fails.  ``--smoke`` selects the reduced
configuration so the run trains in CPU-minutes.  Every family is ported
(dense, MoE, MLA, SSM, hybrid, VLM, encoder-decoder).  Data is the JAX
package's launcher's (:func:`build_data`): ``synthetic_batch``, plus zero
patches for a VLM and seeded frames for an encoder-decoder.  Weights start
from a generator seeded with 0 on the device, or from the newest
checkpoint in ``--ckpt-dir`` (default ``repro_train_ckpt`` under the
temporary directory, which follows ``TMPDIR``).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np

from ..configs import get_config, get_smoke_config
from ..core import encode_backend
from ..core.recorder import RecorderConfig, session
from ..data import SyntheticConfig, synthetic_batch
from ..models import model_device
from ..optim import AdamWConfig
from ..train import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.train",
        description="Train a model with the port")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model trains (default cuda)")
    ap.add_argument("--encode-backend", default=None,
                    choices=encode_backend.BACKENDS,
                    help="trace encode backend (default: cuda on the card, "
                         "numpy on the CPU)")
    ap.add_argument("--trace-dir", default=None,
                    help="Recorder trace output (enables tracing)")
    return ap


def build_data(cfg, batch: int, seq: int) -> Callable[[int], Dict]:
    """step -> batch, the JAX package's launcher's (``launch/train.py:
    46-56``): ``synthetic_batch``; zero patches for a VLM; for an
    encoder-decoder ``seq`` frames a sequence, normal, from numpy seed
    ``step``."""
    dcfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           batch_size=batch)

    def data(step: int) -> Dict:
        b = synthetic_batch(dcfg, step)
        if cfg.family == "vlm":
            b["patches"] = np.zeros((batch, cfg.n_patches, cfg.d_model),
                                    np.float32)
        if cfg.family == "encdec":
            b["frames"] = np.random.RandomState(step).randn(
                batch, seq, cfg.d_model).astype(np.float32)
        return b
    return data


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    device = model_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data = build_data(cfg, args.batch, args.seq)
    tcfg = TrainerConfig(num_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         async_ckpt=args.async_ckpt,
                         accum_steps=args.accum)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps)

    def run():
        tr = Trainer(cfg, tcfg, ocfg, data=data, device=device)
        res = tr.run()
        print(json.dumps({"result": res,
                          "loss_first": tr.metrics_log[0]["loss"],
                          "loss_last": tr.metrics_log[-1]["loss"],
                          "device": str(device)}, indent=1))

    if args.trace_dir:
        # grammar packing follows the module default, so set it too
        backend = args.encode_backend or (
            "cuda" if device.type == "cuda" else "numpy")
        prev = encode_backend.default_backend()
        encode_backend.set_default_backend(backend)
        try:
            with session(RecorderConfig(trace_dir=args.trace_dir,
                                        encode_backend=backend)) as rec:
                run()
                print(f"traced {rec.n_records} records "
                      f"({len(rec.cst)} unique signatures) -> "
                      f"{args.trace_dir}")
        finally:
            encode_backend.set_default_backend(prev)
    else:
        run()


if __name__ == "__main__":
    main()
