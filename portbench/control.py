"""Readings that the limits of ``correct`` are set from, at a cell's own
size on the card: the program's numbers over many seeds, the control's
(the reference in float8, the precision below the configuration's bf16)
and the faults' on a few, one seed after another in one process.

    python3 portbench/control.py --workload mamba2-370m-plainssd.train \\
        --seeds 1,2,3 --control-seeds 1,2 --seconds 6 --out readings.json

Each seed is one ``harness.run_cell`` (set-up, a window of ``--seconds``,
the check); the control's readings are taken after the check.  Training:
the control is the reference's three steps with float8 products, held
against the f32 reference; the fault "half of the batch left out, the
mean taken over the rest" is the reference on half the rows.  Prefill:
the control's gap is that of the token the float8 reference puts first,
read in the f32 reference's logits.  ``--fault`` plants a fault in the
program for the whole run, and its readings are the program's:
``ssd_backward_fp8`` rounds every gradient that leaves the SSD chunk
scan's backward pass to float8 (e5m2, one scale a tensor).  The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def _control(run, job):
    """The control's readings, and for training the half batch's, on the
    inputs the check handed the reference."""
    from portbench.reference import compare
    if run.mix["job"] == "train":
        from portbench.jobs.train import follow
        opt = run.mix["optimizer"]
        out = {}
        for key, rows, fp8 in (
                ("control", job.batches, True),
                ("half_batch", [b[: b.shape[0] // 2] for b in job.batches],
                 False)):
            low = follow(run.model, run.seed, run.device, rows, opt, fp8=fp8)
            out[key] = compare.training_gaps(
                low["losses"], low["grad_norms"], low["change_norms"],
                job.ref_out, low["grads"])
        return out
    from portbench.jobs.prefill import reference_logits
    low = reference_logits(run, job.prompt_rows, fp8=True)
    V = run.model["vocab_size"]
    return {"control": {"served_gap": compare.served_gap(
        job.ref_logits, low[:, :V].argmax(1).tolist(), V)}}


@contextlib.contextmanager
def ssd_backward_fp8():
    """The program's SSD chunk scan with every input's gradient rounded to
    float8 on its way out of the backward pass."""
    import torch
    from repro_torch.models import ssm
    from portbench.reference.model import _fp8

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, g):
            return _fp8(g, torch.float8_e5m2).to(g.dtype)

    real = ssm.ssd_chunk_scan

    def scan(cfg, *args):
        return real(cfg, *(Round.apply(a) if a.requires_grad else a
                           for a in args))
    ssm.ssd_chunk_scan = scan
    try:
        yield
    finally:
        ssm.ssd_chunk_scan = real


FAULTS = {"ssd_backward_fp8": ssd_backward_fp8}


def readings(name: str, seed: int, seconds: float, control: bool,
             device: str = "cuda", model_override=None, mix_override=None,
             fault: str = ""):
    from portbench import harness
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        res = harness.run_cell(name, seed, seconds, False, device=device,
                               model_override=model_override,
                               mix_override=mix_override,
                               after_check=_control if control else None)
    out = {"seed": seed, "correct": res["correct"],
           "program": {k: c["value"] for k, c in res["checks"].items()},
           "diagnostics": res["work"]["diagnostics"]}
    out.update(res.get("after_check") or {})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="", choices=("",) + tuple(FAULTS))
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        row = readings(args.workload, seed, args.seconds, seed in ctrl,
                       fault=args.fault)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
