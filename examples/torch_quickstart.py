"""Quickstart on the PyTorch/CUDA port: train a small LM with the full
substrate -- traced data pipeline, AdamW, fault-tolerant checkpointing --
then read the I/O trace back and print what Recorder captured.

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 60]
    PYTHONPATH=src python examples/torch_quickstart.py --steps 4 \\
        --device cpu --encode-backend numpy     # on a host without a card

Uses the qwen1.5-family reduced config (~1M params); ``--big`` selects a
~100M-param variant (same code path).  The model trains on ``--device``
(``cuda``, the default, needs the card) and the trace encodes on
``--encode-backend`` (default: ``cuda`` on the card, ``numpy`` on the
CPU).  The trace and the checkpoints go under ``--work-dir`` (default: a
fresh temporary directory, kept so the trace can be read after).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import encode_backend  # noqa: E402
from repro_torch.core.reader import TraceReader  # noqa: E402
from repro_torch.core.recorder import RecorderConfig, session  # noqa: E402
from repro_torch.data import SyntheticConfig, synthetic_batch  # noqa: E402
from repro_torch.models import model_device  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--encode-backend", default=None,
                    choices=encode_backend.BACKENDS,
                    help="trace encode backend (default: cuda on the card, "
                         "numpy on the CPU)")
    ap.add_argument("--work-dir", default=None)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = model_device(args.device)
    backend = args.encode_backend or (
        "cuda" if device.type == "cuda" else "numpy")
    cfg = get_smoke_config("qwen1.5-0.5b")
    if args.big:  # ~100M params: d_model 512, 8 layers, full vocab
        cfg = cfg.replace(n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
                          d_ff=1408, vocab_size=151936)
    dcfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=64,
                           batch_size=8)
    work = args.work_dir or tempfile.mkdtemp(prefix="repro_torch_quickstart_")
    trace_dir = os.path.join(work, "trace")

    # grammar packing follows the module default, so set it too
    before = encode_backend.default_backend()
    encode_backend.set_default_backend(backend)
    try:
        with session(RecorderConfig(trace_dir=trace_dir,
                                    encode_backend=backend)) as rec:
            trainer = Trainer(
                cfg,
                TrainerConfig(num_steps=args.steps,
                              ckpt_dir=os.path.join(work, "ckpt"),
                              ckpt_every=max(args.steps // 3, 1)),
                AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps),
                data=lambda s: synthetic_batch(dcfg, s), device=device)
            result = trainer.run()
            print(f"trained {result['final_step']} steps on {device}: "
                  f"loss {trainer.metrics_log[0]['loss']:.3f} -> "
                  f"{result['last_loss']:.3f}")
        n_sigs = len(rec.cst)

        reader = TraceReader(trace_dir)
        by_layer = {}
        for _r, rec_ in reader.all_records(timestamps=False):
            by_layer.setdefault(rec_.layer, {}).setdefault(rec_.func, 0)
            by_layer[rec_.layer][rec_.func] += 1
    finally:
        encode_backend.set_default_backend(before)
    n_funcs = sum(len(f) for f in by_layer.values())
    print(f"\nRecorder captured {reader.n_records(0)} calls ({n_sigs} unique "
          f"signatures, {n_funcs} functions) -> {trace_dir}; trace files:")
    for f in sorted(os.listdir(trace_dir)):
        print(f"  {f:18s} {os.path.getsize(os.path.join(trace_dir, f)):7d} B")
    print("\ncalls by layer (the framework's own I/O stack):")
    for layer, funcs in sorted(by_layer.items()):
        top = sorted(funcs.items(), key=lambda kv: -kv[1])[:4]
        print(f"  {layer:8s} " + "  ".join(f"{k}x{v}" for k, v in top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
