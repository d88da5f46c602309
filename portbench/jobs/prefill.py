"""A traced prefill pool: ``repro_torch.serve.ServeEngine.generate`` over
prompts read through the traced ``pread`` from a document store, inside a
Recorder session that is flushed every few batches and finalized inside
the window.

Requests come from a closed loop of ``batch`` clients: each sends its
next request as soon as the token of its last one is on the host, so every
batch is full and batches run back to back, at whatever rate the engine
sustains.  A batch is ``batch`` prompts of ``prompt_len`` tokens,
``new_tokens`` each; each request asks for a document of the store drawn
from the seed.  ``serve_tokens_per_s`` is the prompt and generated tokens
of every request completed in the window over the window, finalize
included; ``ttft_p95_ms`` is the 95th percentile of the time from a
request's sending to its token on the host, over every request of the
window.

The check draws ``check_requests`` completed requests from the seed and
runs the reference over each prompt: the widest gap by which a served
token's logit lies below the reference's best; and it decodes the trace
and compares its records with the reads the job made.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import weights
from ..profiler import subwindow
from ..roofline import counts
from ..reference import compare, model as ref
from ..reference.trace_decode import Handle, read_records


class Job:
    UNITS = {"serve_tokens_per_s": "tokens/s", "ttft_p95_ms": "ms"}

    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.B, self.L = self.mix["batch"], self.mix["prompt_len"]
        self.n_new = self.mix["new_tokens"]
        self.cfg = run.port_config()
        self.attempted = self.failed = 0
        self.reads: List[int] = []        # document of every read, in order
        self.served: List[tuple] = []     # (request, document, first token)
        self.ttft: List[float] = []
        self.window_batches = 0
        self.batch_s: List[float] = []

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.core.apis import posix
        from repro_torch.core.recorder import session
        from repro_torch.serve import ServeEngine
        run, mix = self.run, self.mix
        rng = np.random.default_rng(run.seed)
        self.doc_bytes = 4 * self.L
        self.store = os.path.join(run.work, "store.bin")
        rng.integers(0, run.model["vocab_size"],
                     size=mix["store_docs"] * self.L, dtype=np.uint32) \
            .astype("<u4").tofile(self.store)
        run.mark("store")
        self.doc_rng = rng
        run.warm_recorder()
        run.mark("warm_recorder")
        self.engine = ServeEngine(
            self.cfg, weights.make_params(run.model, run.seed, run.device,
                                          torch.bfloat16),
            max_seq=self.L + self.n_new, device=run.device)
        run.mark("weights")
        self.session = session(run.recorder_config(
            os.path.join(run.work, "trace")))
        self.rec = self.session.__enter__()
        self.fd = posix.open(self.store, os.O_RDONLY, 0o644)
        # one batch of the window's shape, its documents the first drawn
        self.engine.generate({"tokens": self._read(self._docs())},
                             self.n_new)
        run.mark("warm_batch")
        with run.span("flush_setup"):
            self.rec.flush()

    def _docs(self) -> np.ndarray:
        """The documents of the next batch's requests, drawn from the
        seed."""
        return self.doc_rng.integers(0, self.mix["store_docs"], size=self.B)

    def _read(self, docs) -> np.ndarray:
        from repro_torch.core.apis import posix
        rows = []
        for d in docs:
            raw = posix.pread(self.fd, self.doc_bytes, int(d) * self.doc_bytes)
            rows.append(np.frombuffer(raw, dtype="<u4"))
            self.reads.append(int(d))
        return np.stack(rows).astype(np.int32)

    # -- window -------------------------------------------------------------

    def window(self) -> Dict[str, float]:
        run, B = self.run, self.B
        every = self.mix["flush_every_batches"]
        n_prof = self.mix["profile_batches"] if run.trace else 0
        profiled = False
        t0 = run.now()
        # every client sends its first request when the window opens
        sent = np.full(B, t0)
        while run.now() - t0 < run.seconds or (n_prof and not profiled):
            if n_prof and not profiled and run.spans.get("flush"):
                with subwindow(run.profile):
                    for _ in range(n_prof):
                        sent = self._batch(sent)
                profiled = True
            else:
                sent = self._batch(sent)
            if self.window_batches % every == 0:
                with run.span("flush"):
                    self.rec.flush()
        with run.span("finalize"):
            self.session.__exit__(None, None, None)
        self.window_s = run.now() - t0
        done = len(self.served)
        run.counters["model_flops"] = self.window_batches * \
            counts.prefill_flops(run.model, B, self.L)
        run.counters["window_s"] = self.window_s
        return {"serve_tokens_per_s":
                done * (self.L + self.n_new) / self.window_s,
                "ttft_p95_ms": float(np.percentile(self.ttft, 95)) * 1e3}

    def _batch(self, sent: np.ndarray) -> np.ndarray:
        """Serve one request of every client, sent at ``sent``; returns
        when each client sends its next one: now, its token on the
        host."""
        B, k = self.B, len(self.served)
        docs = self._docs()
        self.attempted += B
        try:
            toks = self.engine.generate({"tokens": self._read(docs)},
                                        self.n_new)
        except Exception:
            self.failed += B
            raise
        t = time.perf_counter()
        self.batch_s.append(self.engine.stats["prefill_s"])
        for i in range(B):
            self.ttft.append(t - sent[i])
            self.served.append((k + i, int(docs[i]), int(toks[i, 0])))
        self.window_batches += 1
        return np.full(B, t)

    def release(self) -> None:
        from repro_torch.core.apis import posix
        posix.close(self.fd)
        self.engine = None

    def work_summary(self) -> Dict[str, Any]:
        return {"batches": self.window_batches, "requests": len(self.served),
                "tokens_per_request": self.L + self.n_new,
                "window_s": self.window_s, "batch_s": self.batch_s}

    # -- check --------------------------------------------------------------

    def expected_records(self) -> List[tuple]:
        out = [("open", (self.store, os.O_RDONLY, 0o644), Handle(0))]
        out += [("pread", (Handle(0), self.doc_bytes, d * self.doc_bytes),
                 self.doc_bytes) for d in self.reads]
        return out

    def sample(self) -> List[tuple]:
        n = min(self.mix["check_requests"], len(self.served))
        pick = np.random.default_rng(self.run.seed + 1).choice(
            len(self.served), size=n, replace=False)
        return [self.served[i] for i in sorted(pick)]

    def prompts(self, docs) -> torch.Tensor:
        rows = [np.fromfile(self.store, dtype="<u4", count=self.L,
                            offset=int(d) * self.doc_bytes) for d in docs]
        return torch.as_tensor(np.stack(rows).astype(np.int64),
                               device=self.run.device)

    def check(self) -> Dict[str, float]:
        run = self.run
        trace_dir = os.path.join(run.work, "trace", "merged")
        mismatch = compare.records_mismatch(read_records(trace_dir),
                                            self.expected_records())
        self.picked = self.sample()
        self.prompt_rows = self.prompts([d for _, d, _ in self.picked])
        self.ref_logits = reference_logits(run, self.prompt_rows, fp8=False)
        return {"served_gap": compare.served_gap(
                    self.ref_logits, [t for _, _, t in self.picked],
                    run.model["vocab_size"]),
                "trace_mismatch": float(mismatch)}


def reference_logits(run, prompts: torch.Tensor, fp8: bool,
                     block: int = 8) -> torch.Tensor:
    """The reference's last-position logits of every prompt, in blocks of
    prompts, on the seeded weights the engine served."""
    params = weights.make_params(run.model, run.seed, run.device,
                                 torch.bfloat16)
    out = []
    with ref.strict_f32():
        for i in range(0, len(prompts), block):
            out.append(ref.last_logits(params, run.model,
                                       prompts[i:i + block], fp8=fp8).cpu())
    return torch.cat(out)
