"""CLI for the always-on trace query service.

Point it at a root directory that holds many trace directories (one per
job) and either list them, answer one query, rank jobs by bandwidth,
find stragglers, or run a watch loop that keeps printing a live league
table as jobs commit new epochs.

    python -m repro_torch.launch.traceserve --root runs/ --list
    python -m repro_torch.launch.traceserve --root runs/ --job job_a \\
        --query io_summary
    python -m repro_torch.launch.traceserve --root runs/ --job job_a \\
        --query overlap_ratio --rank 2 --t0 0 --t1 500000
    python -m repro_torch.launch.traceserve --root runs/ --league
    python -m repro_torch.launch.traceserve --root runs/ --job job_a --stragglers
    python -m repro_torch.launch.traceserve --root runs/ --job job_a --phases
    python -m repro_torch.launch.traceserve --root runs/ --job job_a --anomalies
    python -m repro_torch.launch.traceserve --root runs/ --job job_a \\
        --query dfg --top 10
    python -m repro_torch.launch.traceserve --root runs/ --watch --interval 2 \\
        --iterations 10

Output is JSON on stdout (one document per watch iteration).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict

from ..core import encode_backend
from ..traceserve import QUERY_FAMILIES, TraceService


def _job_rows(service: TraceService) -> Dict[str, Any]:
    return {name: dataclasses.asdict(info)
            for name, info in service.jobs().items()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro_torch.launch.traceserve",
        description="Live compressed-domain queries over many trace jobs")
    p.add_argument("--root", required=True,
                   help="directory holding one trace directory per job")
    p.add_argument("--mode", default="auto",
                   choices=("auto", "stitched", "tail", "merged"))
    p.add_argument("--staleness", type=float, default=1.0, metavar="S",
                   help="serve snapshots at most S seconds stale")
    p.add_argument("--no-validate", action="store_true",
                   help="skip per-segment CRC validation during scans")
    p.add_argument("--encode-backend", choices=encode_backend.BACKENDS,
                   default=None,
                   help="backend of the grammar re-encoding a stitched read "
                        "does (default: the port's default, cuda; pick "
                        "numpy or torch on a machine without a card)")
    act = p.add_argument_group("actions (pick one)")
    act.add_argument("--list", action="store_true",
                     help="scan the root and list every job")
    act.add_argument("--query", metavar="FAMILY", choices=QUERY_FAMILIES,
                     help=f"one of {', '.join(QUERY_FAMILIES)}")
    act.add_argument("--league", action="store_true",
                     help="bandwidth league table across all jobs")
    act.add_argument("--stragglers", action="store_true",
                     help="per-rank reasons-attached straggler report "
                          "for --job")
    act.add_argument("--phases", action="store_true",
                     help="phase segmentation of --job (--rank, default 0)")
    act.add_argument("--anomalies", action="store_true",
                     help="cross-rank DFG divergence report for --job")
    act.add_argument("--watch", action="store_true",
                     help="repeatedly print jobs + league table")
    p.add_argument("--job", help="job name (for --query / --stragglers / "
                                 "--phases / --anomalies)")
    p.add_argument("--rank", type=int, default=None)
    p.add_argument("--t0", type=int, default=None)
    p.add_argument("--t1", type=int, default=None)
    p.add_argument("--top", type=int, default=None,
                   help="edge cutoff for --query dfg / digram_counts")
    p.add_argument("--threshold", type=float, default=0.5,
                   help="straggler cutoff as a fraction of the median")
    p.add_argument("--divergence", type=float, default=0.25,
                   help="DFG divergence cutoff (--anomalies / "
                        "--stragglers)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch period in seconds")
    p.add_argument("--iterations", type=int, default=0,
                   help="--watch iterations (0 = until interrupted)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.encode_backend is not None:
        encode_backend.set_default_backend(args.encode_backend)
    with TraceService(args.root, mode=args.mode,
                      max_staleness_s=args.staleness,
                      validate=not args.no_validate) as service:
        if args.list:
            out: Any = {"root": args.root, "jobs": _job_rows(service)}
        elif args.query:
            if not args.job:
                print("--query needs --job", file=sys.stderr)
                return 2
            params: Dict[str, Any] = {}
            if args.rank is not None:
                params["rank"] = args.rank
            if args.t0 is not None:
                params["t0"] = args.t0
            if args.t1 is not None:
                params["t1"] = args.t1
            if args.top is not None:
                params["top"] = args.top
            out = service.query(args.job, args.query, params).to_dict()
        elif args.league:
            out = {"league": service.league_table(),
                   "stats": service.stats()}
        elif args.stragglers:
            if not args.job:
                print("--stragglers needs --job", file=sys.stderr)
                return 2
            out = service.stragglers(args.job, threshold=args.threshold,
                                     divergence=args.divergence)
        elif args.phases:
            if not args.job:
                print("--phases needs --job", file=sys.stderr)
                return 2
            out = service.phases(args.job, rank=args.rank or 0).to_dict()
        elif args.anomalies:
            if not args.job:
                print("--anomalies needs --job", file=sys.stderr)
                return 2
            out = service.anomalies(
                args.job, threshold=args.divergence).to_dict()
        elif args.watch:
            i = 0
            try:
                while args.iterations == 0 or i < args.iterations:
                    if i:
                        time.sleep(args.interval)
                    doc = {"iteration": i,
                           "jobs": _job_rows(service),
                           "league": service.league_table(),
                           "stats": service.stats()}
                    print(json.dumps(doc, default=str), flush=True)
                    i += 1
            except KeyboardInterrupt:
                pass
            return 0
        else:
            print("pick an action: --list / --query / --league / "
                  "--stragglers / --phases / --anomalies / --watch",
                  file=sys.stderr)
            return 2
        print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
