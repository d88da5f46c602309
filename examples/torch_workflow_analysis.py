"""Workflow I/O analysis (paper Section 4) on the PyTorch/CUDA port: trace
a two-stage workflow -- train (writes checkpoints), then serve (reads
nothing, emits serve_step events) -- convert the trace to Chrome-timeline
+ columnar form, and answer analysis questions that counter-based tools
cannot (exact offsets, call chains, per-thread activity).

    PYTHONPATH=src python examples/torch_workflow_analysis.py
    PYTHONPATH=src python examples/torch_workflow_analysis.py \\
        --device cpu --encode-backend numpy     # on a host without a card

The model trains and serves on ``--device`` (``cuda``, the default, needs
the card); the trace encodes on ``--encode-backend`` (default: ``cuda`` on
the card, ``numpy`` on the CPU).  Everything goes under ``--work-dir``
(default: a fresh temporary directory, kept so the outputs can be read
after).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import encode_backend  # noqa: E402
from repro_torch.core.analysis import call_chains  # noqa: E402
from repro_torch.core.converters import (read_columnar,  # noqa: E402
                                         to_chrome_timeline, to_columnar)
from repro_torch.core.reader import TraceReader  # noqa: E402
from repro_torch.core.recorder import RecorderConfig, session  # noqa: E402
from repro_torch.data import SyntheticConfig, synthetic_batch  # noqa: E402
from repro_torch.launch.steps import cast_params  # noqa: E402
from repro_torch.models import model_device  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    dcfg = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=48,
                           batch_size=4)
    work = args.work_dir or tempfile.mkdtemp(prefix="repro_torch_workflow_")
    trace_dir = os.path.join(work, "trace")

    # grammar packing follows the module default, so set it too
    before = encode_backend.default_backend()
    encode_backend.set_default_backend(backend)
    try:
        with session(RecorderConfig(trace_dir=trace_dir,
                                    encode_backend=backend)) as rec:
            tr = Trainer(cfg, TrainerConfig(num_steps=20,
                                            ckpt_dir=os.path.join(work, "ck"),
                                            ckpt_every=10, async_ckpt=True),
                         AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=20),
                         data=lambda s: synthetic_batch(dcfg, s),
                         device=device)
            tr.run()
            params = cast_params(tr.state["master"],
                                 torch_dtype(cfg.param_dtype))
            eng = ServeEngine(cfg, params, max_seq=96, device=device)
            eng.generate({"tokens": synthetic_batch(dcfg, 99)["tokens"]}, 12)
        print(f"traced {rec.n_records} records ({len(rec.cst)} unique "
              f"signatures) on {device} -> {trace_dir}")

        # --- conversions (paper Section 2.3) -----------------------------
        chrome = os.path.join(work, "timeline.json")
        n = to_chrome_timeline(trace_dir, chrome)
        cols_dir = os.path.join(work, "columnar")
        sizes = to_columnar(trace_dir, cols_dir)
        print(f"chrome timeline: {n} events -> {chrome} "
              f"({os.path.getsize(chrome)} B)")
        print(f"columnar dataset: {sum(sizes.values())} B in {len(sizes)} "
              f"files")

        # --- analyses only a full-parameter trace supports ---------------
        cols = read_columnar(cols_dir)
        reader = TraceReader(trace_dir)
        funcs = sorted({r.func for _, r in reader.all_records(
            timestamps=False)})
        print(f"columnar read: {len(cols['func_id'])} rows, {len(funcs)} "
              f"functions traced: {funcs}")
        writes = [(o, s) for o, s in zip(cols["offset"], cols["size"])
                  if o >= 0 and s > 0]
        print(f"\n{len(writes)} offset-carrying data ops; "
              f"max file extent touched: {max(o + s for o, s in writes)} B")
        depths = cols["depth"]
        print("call-depth histogram (cross-layer cause and effect):",
              {int(d): int((depths == d).sum()) for d in sorted(set(depths))})
        threads = cols["thread"]
        print(f"threads observed: {sorted(set(int(t) for t in threads))} "
              f"(async checkpoint thread shows up as its own tid)")
        # cause-of-write: which framework-level op encloses each posix
        # write?
        chains = call_chains(reader, targets={"pwrite", "write"})
    finally:
        encode_backend.set_default_backend(before)
    print("\nwrite call-chains:")
    for c, k in sorted(chains.items(), key=lambda kv: -kv[1]):
        print(f"  {k:5d}  {c}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
