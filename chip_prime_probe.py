"""The prime prefill's kernel-vs-plain error against its depth, on the card.

``chip_smoke.py``'s ``serve_ssm`` phase runs a prefill of mamba2-370m on
prompts of a prime length (``PRIME_PROMPT`` tokens: the SSD scan runs at
chunk length Q = 1) and holds the kernel path's logits to the plain path's
within the serve run's relative-L2 bound a layer times ``PRIME_LAYERS``.
This script reads that error at the depths it is given, with the same
seeded weights and prompts, so the room the bound leaves at each depth is
on record:

    python3 chip_prime_probe.py 8 16 24 32 48

It prints, for each depth, the relative L2 over the batch, the same a
layer, each prompt's, and the plain path's seconds; then the card's name
and power limit.  It needs a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_prime_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import get_model

    depths = [int(x) for x in argv] or [cs.PRIME_LAYERS]
    cs.phase_build(_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cs.SERVE_SPECS[1]
    dev = torch.device("cuda")
    for layers in depths:
        cfg = get_config(spec.arch).replace(n_layers=layers)
        params = get_model(cfg, dev).init_params(
            torch.Generator(device=dev).manual_seed(0))
        batch = {"tokens": np.random.RandomState(1).randint(
            0, cfg.vocab_size, size=(cs.SERVE_BATCH, cs.PRIME_PROMPT)
        ).astype(np.int32)}
        with torch.inference_mode():
            lk, _ = get_model(cfg, dev).prefill(params, batch)
            t = time.monotonic()
            lp, _ = get_model(cfg.replace(**spec.plain), dev).prefill(
                params, batch)
            torch.cuda.synchronize()
            plain_s = time.monotonic() - t
        rel = cs.rel_l2(lk, lp)
        per = [cs.rel_l2(lk[i], lp[i]) for i in range(lk.shape[0])]
        print(f"{spec.arch} x {layers}, {cs.SERVE_BATCH} x "
              f"{cs.PRIME_PROMPT} tokens: relative L2 {rel:.4g} "
              f"({rel / layers:.3g} a layer; bound {spec.rtol / spec.layers:.3g}"
              f" a layer), per prompt {[round(x, 4) for x in per]}, plain "
              f"path {plain_s:.1f} s", flush=True)
        del params, lk, lp
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
