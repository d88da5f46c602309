"""Fault-tolerant training loop (the JAX package's ``train/loop.py``).

Production behaviors, all exercised by tests:

  * auto-resume from the newest valid checkpoint (crc-verified, falls back
    to older ones on corruption),
  * periodic checkpointing (sync or async thread) with keep-k GC, through
    the traced I/O facades -- a Recorder session sees the whole step loop
    (``frame.step`` events) plus the checkpoint call chains,
  * step retry with restore-on-repeated-failure,
  * straggler detection: per-step wall-time z-score against a running
    mean/variance; slow steps are reported,
  * gradient-accumulation microbatching (``accum_steps``) for memory,
  * deterministic, resumable data (state == step counter).

The train state lives on one device in the port's layout; checkpoints hold
the JAX package's stacked layout (``models.convert.state_to_numpy``), so
either package restores the other's.  A fresh state comes from a
``torch.Generator`` seeded with ``TrainerConfig.seed`` on that device,
which draws other numbers than the JAX package's ``PRNGKey``: to start
both packages from one state, let the port auto-resume from a checkpoint
the JAX package wrote.  Step times are host-clock seconds after the step's
metrics reached the host (which waits for the device), read by the step's
``train.step`` span (``repro_torch.spans``), whose clock reads they share.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import spans
from ..checkpoint import CheckpointEngine
from ..core.apis import framework as frame
from ..launch.steps import make_train_step
from ..models import get_model
from ..models.config import ModelConfig
from ..models.convert import (flat_params, state_from_numpy, state_shapes,
                              state_to_numpy)
from ..optim import AdamWConfig, adamw_init


@dataclass
class TrainerConfig:
    num_steps: int = 100
    # under the temporary directory, which follows TMPDIR
    ckpt_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    keep: int = 2
    log_every: int = 10
    retry_max: int = 2
    straggler_z: float = 3.0
    async_ckpt: bool = False
    accum_steps: int = 1
    seed: int = 0


class StragglerDetector:
    """Welford running mean/var over step times; flags z-score outliers."""

    def __init__(self, z: float = 3.0, warmup: int = 8):
        self.z = z
        self.warmup = warmup
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.flagged: List[int] = []

    def update(self, step: int, dt: float) -> bool:
        slow = False
        if self.n >= self.warmup:
            std = math.sqrt(self.m2 / max(self.n - 1, 1))
            if std > 0 and (dt - self.mean) / std > self.z:
                slow = True
                self.flagged.append(step)
        self.n += 1
        d = dt - self.mean
        self.mean += d / self.n
        self.m2 += d * (dt - self.mean)
        return slow


def state_nbytes(state: Dict[str, Any]) -> int:
    """Bytes of every leaf of the state (the ``ckpt_end`` count)."""
    return sum(t.numel() * t.element_size() for t in flat_params(state).values())


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 ocfg: Optional[AdamWConfig] = None,
                 data: Optional[Callable[[int], Dict]] = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.ocfg = ocfg or AdamWConfig()
        self.model = get_model(cfg, device)
        self.device = self.model.device
        self.data = data
        self.fault_hook = fault_hook
        self.engine = CheckpointEngine(tcfg.ckpt_dir, keep=tcfg.keep,
                                       async_save=tcfg.async_ckpt)
        self.straggler = StragglerDetector(z=tcfg.straggler_z)
        self._step_fn = make_train_step(cfg, self.ocfg,
                                        accum_steps=tcfg.accum_steps,
                                        device=self.device)
        self.state = None
        self.start_step = 0
        self.metrics_log: List[Dict[str, float]] = []

    # -- state ----------------------------------------------------------------

    def _restore(self, shapes) -> Optional[int]:
        """Load the newest valid checkpoint into ``self.state``; return
        the step to go on from, or None when there is none."""
        restored = self.engine.restore_latest(shapes)
        if restored is None:
            return None
        tree, manifest = restored
        self.state = None                  # free the device copy first
        self.state = state_from_numpy(self.cfg, tree, self.device)
        return int(manifest["meta"].get("next_step", manifest["step"]))

    def init_state(self) -> None:
        """Fresh init or auto-resume from the newest valid checkpoint."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        state = adamw_init(self.model.init_params(gen))
        shapes = state_shapes(state)
        self.state = state
        del state
        step = self._restore(shapes)
        self.start_step = 0 if step is None else step

    # -- loop -------------------------------------------------------------------

    def _run_step(self, step: int) -> Dict[str, float]:
        with spans.span("train.data"):
            batch = self.data(step)
            frame.fetch_batch(step, sum(v.nbytes for v in batch.values()))
        if self.fault_hook is not None:
            self.fault_hook(step)
        self.state, metrics = self._step_fn(self.state, batch)
        with spans.span("train.readback"):
            return {k: float(v) for k, v in metrics.items()}

    def run(self) -> Dict[str, Any]:
        if self.state is None:
            self.init_state()
        step = self.start_step
        retries = 0
        while step < self.tcfg.num_steps:
            frame.step(step)
            try:
                with spans.timed("train.step", step=step) as timer:
                    metrics = self._run_step(step)
            except Exception:
                retries += 1
                if retries <= self.tcfg.retry_max:
                    continue  # transient failure: retry the same step
                # repeated failure: restore from last good checkpoint
                resume = self._restore(state_shapes(self.state))
                if resume is None:
                    raise
                step = resume
                retries = 0
                continue
            retries = 0
            dt = timer.seconds
            self.straggler.update(step, dt)
            metrics["step_time_s"] = dt
            metrics["step"] = step
            self.metrics_log.append(metrics)
            step += 1
            if self.tcfg.ckpt_every and step % self.tcfg.ckpt_every == 0:
                frame.ckpt_begin(step)
                self.engine.save(state_to_numpy(self.state), step,
                                 meta={"next_step": step})
                frame.ckpt_end(step, state_nbytes(self.state))
        self.engine.wait()
        return {"final_step": step,
                "stragglers": list(self.straggler.flagged),
                "last_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else float("nan")}
