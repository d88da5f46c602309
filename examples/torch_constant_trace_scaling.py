"""The paper's headline result on the PyTorch/CUDA port: a parallel
checkpoint workload (FLASH weak scaling) traced across 4 -> 512 simulated
ranks compresses to a CONSTANT-size trace, while the peephole baseline
(Recorder-old) grows linearly.

    PYTHONPATH=src python examples/torch_constant_trace_scaling.py
    PYTHONPATH=src python examples/torch_constant_trace_scaling.py \\
        --ranks 4,16 --encode-backend numpy     # on a host without a card

The timestamps compress, the rank-linear fit and the grammars pack on
``--encode-backend`` (``cuda``, the default, needs the card).  The CST
records the paths given to ``open()``, so the byte counts move with the
length of ``--data-root``.
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import encode_backend  # noqa: E402
from repro_torch.core.baselines import RecorderOld, ToolAdapter  # noqa: E402
from repro_torch.core.recorder import RecorderConfig  # noqa: E402
from repro_torch.workloads import flash_rank, run_ranks  # noqa: E402

ITERATIONS = 60


def row(nprocs: int, data_dir: str, backend: str) -> dict:
    """One rank count: Recorder's CFG+CST bytes and Recorder-old's."""
    r = run_ranks(flash_rank, nprocs,
                  RecorderConfig(timestamps=False, encode_backend=backend),
                  data_dir=data_dir, iterations=ITERATIONS)
    old_total = 0
    for rank in range(nprocs):
        tool = RecorderOld(rank)
        flash_rank(ToolAdapter(tool, rank=rank), rank, nprocs,
                   data_dir=data_dir, iterations=ITERATIONS)
        old_total += tool.nbytes
    return {"nprocs": nprocs, "n_records": r["n_records"],
            "pattern_bytes": r["pattern_bytes"], "old_bytes": old_total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", default="4,16,64,256,512",
                    help="comma-separated simulated rank counts")
    ap.add_argument("--data-root", default=None,
                    help="directory the workload writes its files in "
                         "(default: a fresh temporary directory, removed "
                         "after)")
    ap.add_argument("--encode-backend", default="cuda",
                    choices=("cuda", "numpy", "torch"))
    args = ap.parse_args(argv)
    if args.encode_backend == "cuda" and not torch.cuda.is_available():
        print("torch_constant_trace_scaling: --encode-backend cuda needs a "
              "CUDA card; pass --encode-backend numpy or torch to run on "
              "the CPU", file=sys.stderr)
        return 1
    ranks = [int(n) for n in args.ranks.split(",")]
    own = args.data_root is None
    data_dir = tempfile.mkdtemp() if own else args.data_root
    before = encode_backend.default_backend()
    encode_backend.set_default_backend(args.encode_backend)
    try:
        print(f"{'ranks':>6s} {'records':>9s} {'Recorder CFG+CST':>17s} "
              f"{'Recorder-old':>13s} {'ratio':>7s}")
        for nprocs in ranks:
            r = row(nprocs, data_dir, args.encode_backend)
            print(f"{nprocs:6d} {r['n_records']:9d} "
                  f"{r['pattern_bytes']:15d} B {r['old_bytes']:11d} B "
                  f"{r['old_bytes'] / max(r['pattern_bytes'], 1):6.1f}x",
                  flush=True)
    finally:
        encode_backend.set_default_backend(before)
        if own:
            shutil.rmtree(data_dir, ignore_errors=True)
    print("\nRecorder's pattern files stay flat as ranks grow; the"
          " record-at-a-time baseline grows linearly (paper Figs 5-6).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
