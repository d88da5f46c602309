#!/usr/bin/env python3
"""Compare the port of another checkout with this one's on one card.

    python3 chip_ab.py OTHER_CHECKOUT

It runs a probe four times, each in a process of its own, in the order
OTHER, THIS, THIS, OTHER, so that a drift of the host during the run falls
on both sides alike.  A probe imports the ``repro_torch`` of its checkout
(whose kernels build into that checkout's ``build/kernels``) and drives it
with the workloads of THIS checkout's ``chip_smoke.py``, so only the port
under them differs:

- the IOR write path (32 ranks x 32,771 records, tree finalize) on the
  ``cuda`` encode backend and on ``numpy``, which launches nothing and so
  reads the host alone: seconds, and the digest of the ``*.bin`` bytes;
- ``delta_zigzag`` at 65,542 and 16,777,216 u32 and ``uvarint_encode64``
  at 32,784 u64 (the main path's largest shapes, and one where the bytes
  dominate): the wrapper between CUDA events and the kernel's device time
  from the profiler; the encode dispatch from numpy on ``cuda`` of a tick
  block and of a varint pack;
- the serve runs of ``chip_smoke.py``'s qwen3-32b and mamba2-370m specs
  (full width, seeded random weights, 4 prompts, 32 new tokens, untraced):
  prefill ms and decode ms a step.

Each probe prints its numbers as one JSON line; the last line of the run
is ``{"card": ..., "runs": [...]}`` in run order.  It needs one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def probe(src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    import repro_torch.core.apis  # noqa: F401  (populate the registry)
    from repro_torch.configs import get_config
    from repro_torch.core import encode_backend as eb
    from repro_torch.core import recorder
    from repro_torch.core.comm import run_thread_world
    from repro_torch.core.specs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_encode import ops as de
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t = time.monotonic()
    _build.build_all()
    res = {"src": src, "build_s": time.monotonic() - t}

    for n in (65542, 1 << 24):
        x = torch.from_numpy(cs.tick_stream(n, "mono", 1).view(np.int32)
                             ).to(dev)
        res[f"delta_zigzag@{n}"] = {
            "ms": cs.cuda_ms(lambda: de.delta_zigzag(x)),
            "device_ms": cs.device_kernel_ms(lambda: de.delta_zigzag(x),
                                             "delta_zigzag_kernel")}
    v = cs.ragged_u64(32784, 2)
    x = torch.from_numpy(v.view(np.int64)).to(dev)
    res["uvarint_encode64@32784"] = {
        "ms": cs.cuda_ms(lambda: de.uvarint_encode64(x)),
        "device_ms": cs.device_kernel_ms(lambda: de.uvarint_encode64(x),
                                         "uvarint_encode64_kernel")}
    ticks = cs.tick_stream(65542, "mono", 1)
    res["dispatch_delta_zigzag_ms"] = cs.host_ms(
        lambda: eb.delta_zigzag(ticks, "cuda"), iters=50)
    res["dispatch_pack_ms"] = cs.host_ms(
        lambda: eb.pack_uvarints_batch(v, "cuda"), iters=50)

    p = SimpleNamespace(Recorder=recorder.Recorder,
                        RecorderConfig=recorder.RecorderConfig,
                        REGISTRY=REGISTRY, run_thread_world=run_thread_world)
    for backend in ("cuda", "numpy"):
        d = os.path.join(os.path.dirname(src), "build", "chip_ab", backend)
        eb.set_default_backend(backend)
        t = time.monotonic()
        cs.run_ior(p, d, "tree", backend)
        torch.cuda.synchronize()
        res[f"ior_tree_{backend}_s"] = time.monotonic() - t
        res[f"ior_tree_{backend}_sha256"] = cs.digest(cs.bin_files(d))[:16]
    eb.set_default_backend("cuda")

    for spec in cs.SERVE_SPECS[:2]:
        cfg = get_config(spec.arch).replace(n_layers=spec.layers)
        params = get_model(cfg, dev).init_params(
            torch.Generator(device=dev).manual_seed(0))
        batch = {"tokens": np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(cs.SERVE_BATCH, spec.prompt)
        ).astype(np.int32)}
        eng = ServeEngine(cfg, params, max_seq=spec.max_seq, device=dev)
        eng.generate(batch, 2)
        runs = []
        for _ in range(2):
            eng.generate(batch, cs.SERVE_NEW)
            st = eng.stats
            runs.append({"prefill_ms": st["prefill_s"] * 1e3,
                         "decode_ms_per_step": st["decode_s"] * 1e3
                         / st["decode_steps"]})
        res[f"serve_{spec.arch}"] = runs
        del params, eng
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--probe":
        print(json.dumps(probe(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 1
    other = os.path.abspath(sys.argv[1])
    for tree in (other, ROOT):
        if not os.path.isdir(os.path.join(tree, "src", "repro_torch")):
            print(f"chip_ab: {tree}/src/repro_torch not found",
                  file=sys.stderr)
            return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    runs = []
    for tree in (other, ROOT, ROOT, other):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--probe",
             os.path.join(tree, "src")], cwd=tree, stdout=subprocess.PIPE,
            text=True, timeout=900)
        lines = out.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        if out.returncode != 0 or not lines:
            print(f"chip_ab: the probe of {tree} failed "
                  f"({out.returncode})", file=sys.stderr)
            return 1
        runs.append({"tree": "other" if tree == other else "this",
                     **json.loads(lines[-1])})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
