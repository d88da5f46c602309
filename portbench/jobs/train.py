"""A traced training job: ``repro_torch.train.Trainer`` over a token corpus
read through the traced ``pread`` of ``TokenFileDataset``, inside a
Recorder session that is flushed every few steps and finalized inside the
window.

Set-up writes the corpus from the seed, builds the Trainer on the
benchmark's seeded f32 master weights and runs the first ``warm_steps``
steps through the Trainer's own loop: they compile nothing later, and the
check reads them.  The window runs one step at a time until ``seconds``
have passed, flushing every ``flush_every_steps``, then finalizes.
``train_tokens_per_s`` is the tokens of every step of the window over the
window, finalize included.

The check follows the set-up's steps with the plain reference: the loss
of each step, the norm of every leaf's first gradient as the optimizer
got it (its first moment after one step, the clip factor taken out), and
the norm of every leaf's change after the steps; and it decodes the trace
and compares its records with the calls the job drove.
"""

from __future__ import annotations

import os
import statistics
from typing import Any, Dict, List

import numpy as np
import torch

from .. import weights
from ..profiler import subwindow
from ..roofline import counts
from ..reference import compare, model as ref
from ..reference.adamw import AdamW
from ..reference.trace_decode import Handle, read_records


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dotted name -> leaf, ``layers.3.ssm.in_proj``."""
    out: Dict[str, torch.Tensor] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def corpus_tokens(seed: int, n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=n,
                                                dtype=np.uint32)


class Job:
    UNITS = {"train_tokens_per_s": "tokens/s"}

    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.B, self.S = self.mix["batch"], self.mix["seq_len"]
        self.cfg = run.port_config()
        self.attempted = self.failed = 0
        self.window_steps = 0
        self.next = 0

    # -- set-up -------------------------------------------------------------

    def _write_corpus(self) -> None:
        self.row_bytes = 4 * self.B * (self.S + 1)
        n = self.row_bytes // 4 * self.mix["corpus_batches"]
        self.corpus = os.path.join(self.run.work, "corpus.bin")
        corpus_tokens(self.run.seed, n, self.run.model["vocab_size"]) \
            .astype("<u4").tofile(self.corpus)
        self.corpus_bytes = os.path.getsize(self.corpus)

    def _steps(self, n: int) -> None:
        tr = self.trainer
        tr.start_step = self.next
        tr.tcfg.num_steps = self.next + n
        tr.run()
        self.next += n

    def setup(self) -> None:
        from repro_torch.core.recorder import session
        from repro_torch.data.pipeline import TokenFileDataset
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.train.loop import Trainer, TrainerConfig
        run = self.run
        self._write_corpus()
        run.mark("corpus")
        run.warm_recorder()
        run.mark("warm_recorder")
        self.trainer = Trainer(
            self.cfg, TrainerConfig(num_steps=0, ckpt_every=0,
                                    ckpt_dir=os.path.join(run.work, "ckpt"),
                                    seed=run.seed),
            AdamWConfig(**self.mix["optimizer"]), device=run.device)
        self.session = session(run.recorder_config(
            os.path.join(run.work, "trace")))
        self.rec = self.session.__enter__()
        self.data = TokenFileDataset(self.corpus, self.S, self.B,
                                     vocab=run.model["vocab_size"])
        self.trainer.data = self.data.batch
        self.trainer.state = adamw_init(
            weights.make_params(run.model, run.seed, run.device,
                                torch.float32))
        run.mark("weights")
        # step 1, then the gradient the optimizer got from its moment
        self._steps(1)
        run.mark("step_1")
        b1 = self.mix["optimizer"]["b1"]
        clip = self._clip(self.trainer.metrics_log[0]["grad_norm"])
        self.grads = {k: (v / ((1 - b1) * clip)).to("cpu")
                      for k, v in flat(self.trainer.state["mu"]).items()}
        self.grad_norms = {k: float(v.norm()) for k, v in self.grads.items()}
        self._steps(self.mix["warm_steps"] - 1)
        run.mark("warm_steps")
        master0 = flat(weights.make_params(run.model, run.seed, run.device,
                                           torch.float32))
        self.change_norms = {
            k: float((v - master0[k]).norm())
            for k, v in flat(self.trainer.state["master"]).items()}
        del master0
        self.losses = [m["loss"] for m in self.trainer.metrics_log]
        with run.span("flush_setup"):
            self.rec.flush()

    def _clip(self, gnorm: float) -> float:
        c = self.mix["optimizer"]["grad_clip"]
        return min(c / max(gnorm, 1e-12), 1.0) if c else 1.0

    # -- window -------------------------------------------------------------

    def window(self) -> Dict[str, float]:
        run = self.run
        every = self.mix["flush_every_steps"]
        n_prof = self.mix["profile_steps"] if run.trace else 0
        prof_at = None
        t0 = run.now()
        while True:
            if n_prof and prof_at is None and run.spans.get("flush"):
                prof_at = self.window_steps
                with subwindow(run.profile):
                    for _ in range(n_prof):
                        self._one_step()
            else:
                self._one_step()
            if self.next % every == 0:
                with run.span("flush"):
                    self.rec.flush()
            if run.now() - t0 >= run.seconds and (not n_prof or prof_at
                                                  is not None):
                break
        with run.span("finalize"):
            self.session.__exit__(None, None, None)
        self.window_s = run.now() - t0
        tokens = self.window_steps * self.B * self.S
        run.counters["window_steps"] = self.window_steps
        run.counters["model_flops"] = self.window_steps * \
            counts.train_step_flops(run.model, self.B, self.S)
        run.counters["window_s"] = self.window_s
        return {"train_tokens_per_s": tokens / self.window_s}

    def _one_step(self) -> None:
        self.attempted += 1
        try:
            self._steps(1)
        except Exception:
            self.failed += 1
            raise
        self.window_steps += 1

    def release(self) -> None:
        self.step_s = [m["step_time_s"] for m in
                       self.trainer.metrics_log[self.mix["warm_steps"]:]]
        self.data.close()
        self.steps_run = self.next
        self.trainer = None

    def work_summary(self) -> Dict[str, Any]:
        return {"steps": self.window_steps,
                "tokens_per_step": self.B * self.S,
                "window_s": self.window_s,
                "step_s": self.step_s}

    # -- check --------------------------------------------------------------

    def _rows(self, step: int) -> np.ndarray:
        """The corpus rows of ``step``, read from the file."""
        max_start = self.corpus_bytes - self.row_bytes
        off = (step * self.row_bytes) % (max_start + 1)
        off -= off % 4
        raw = np.fromfile(self.corpus, dtype="<u4",
                          count=self.row_bytes // 4, offset=off)
        return raw.astype(np.int64).reshape(self.B, self.S + 1)

    def expected_records(self) -> List[tuple]:
        out = [("open", (self.corpus, os.O_RDONLY, 0o644), Handle(0)),
               ("stat", (self.corpus,), self.corpus_bytes)]
        max_start = self.corpus_bytes - self.row_bytes
        for s in range(self.steps_run):
            off = (s * self.row_bytes) % (max_start + 1)
            off -= off % 4
            out += [("step", (s,), 0),
                    ("pread", (Handle(0), self.row_bytes, off),
                     self.row_bytes),
                    ("fetch_batch", (s, 2 * 4 * self.B * self.S), 0)]
        return out

    def check(self) -> Dict[str, float]:
        run = self.run
        m = run.model
        n = self.mix["warm_steps"]
        trace_dir = os.path.join(run.work, "trace", "merged")
        mismatch = compare.records_mismatch(read_records(trace_dir),
                                            self.expected_records())
        batches = [torch.as_tensor(self._rows(s), device=run.device)
                   for s in range(n)]
        self.batches = batches
        self.ref_out = follow(m, run.seed, run.device, batches,
                              self.mix["optimizer"], fp8=False)
        readings = compare.training_gaps(
            self.losses[:n], self.grad_norms, self.change_norms, self.ref_out,
            self.grads)
        rel = compare.relative_errors(self.grads, self.ref_out["grads"])
        self.diagnostics = {
            "losses": [self.losses[:n], self.ref_out["losses"]],
            "grad_rel_by_layer": [
                statistics.median(v for k, v in rel.items()
                                  if k.startswith(f"layers.{i}."))
                for i in range(m["n_layers"])],
            "grad_worst": compare.worst_leaves(self.grad_norms,
                                               self.ref_out["grad_norms"]),
            "change_worst": compare.worst_leaves(
                self.change_norms, self.ref_out["change_norms"])}
        readings["trace_mismatch"] = float(mismatch)
        return readings


def follow(m: Dict[str, Any], seed: int, device, batches, opt,
           fp8: bool) -> Dict[str, Any]:
    """The reference's steps from the seeded weights over ``batches``
    ((B, S + 1) token rows): each step's loss, every leaf's first
    gradient (on the host) and its norm, and every leaf's change after the
    steps."""
    start = flat(weights.make_params(m, seed, device, torch.float32))
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in start.items()}
    tree = weights.unflatten(leaves)
    adam = AdamW(opt, leaves)
    losses: List[float] = []
    first: Dict[str, torch.Tensor] = {}
    with ref.strict_f32():
        for i, rows in enumerate(batches):
            for v in leaves.values():
                v.grad = None
            loss = ref.loss(tree, m, rows[:, :-1], rows[:, 1:], fp8=fp8)
            loss.backward()
            losses.append(float(loss.detach()))
            grads = {k: v.grad for k, v in leaves.items()}
            adam.update(leaves, grads)
            if i == 0:
                first = {k: g.detach().to("cpu") for k, g in grads.items()}
    change = {k: float((leaves[k].detach() - start[k]).norm())
              for k in leaves}
    return {"losses": losses, "grads": first,
            "grad_norms": {k: float(g.norm()) for k, g in first.items()},
            "change_norms": change}
