"""Trainer (port of ``train/trainer.py``): checkpoint and auto-resume,
a straggler watchdog, the stateless token pipeline.

* **Checkpoint/restart**: atomic keep-k checkpoints
  (:mod:`repro_torch.checkpoint`) in the reference's format and layout
  (parameters period-stacked, the optimizer state as ``optim.adamw``
  keeps it), so either side resumes the other's run.  The trainer resumes
  from the newest complete step; a kill loses at most ``ckpt_every``
  steps.
* **Stateless data**: batches derive from (seed, step); replaying after a
  restart consumes the identical stream.
* **Straggler mitigation**: a step-time EMA watchdog flags outlier steps.

The reference's ``restore_into_mesh`` places a checkpoint under the
current mesh; here the checkpoint is restored onto the trainer's device.
Sharded training is ROADMAP A13.3.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..data.tokens import TokenPipeline
from ..models import init_params
from ..models.convert import (params_from_reference, params_to_reference,
                              stacked_view)
from ..optim import adamw
from .train_step import make_train_step

__all__ = ["TrainConfig", "StragglerWatchdog", "Trainer"]


def _default_ckpt_dir():
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    # None: no checkpoints (no restore, no saves)
    ckpt_dir: Optional[str] = dataclasses.field(
        default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    n_microbatches: int = 1
    remat: str = "full"
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    straggler_factor: float = 3.0
    async_ckpt: bool = True


class StragglerWatchdog:
    """EMA step-time monitor; flags steps slower than factor x EMA."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.1):
        self.factor = factor
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.flagged = 0

    def record(self, dt: float) -> bool:
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.factor * self.ema
        if slow:
            self.flagged += 1       # real fleet: emit reschedule signal
        else:                       # stragglers don't poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class Trainer:
    def __init__(self, arch_cfg, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainConfig, sctx=None, device="cuda"):
        if sctx is not None:
            raise NotImplementedError(
                "sharded training is not ported yet (ROADMAP A13.3)")
        self.cfg = arch_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = torch.device(device)
        self.manager = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
                        if tcfg.ckpt_dir is not None else None)
        self.pipeline = TokenPipeline(
            arch_cfg.vocab, tcfg.global_batch, tcfg.seq_len, seed=tcfg.seed,
            embed_dim=arch_cfg.d_model if arch_cfg.embeds_input else 0)
        self.watchdog = StragglerWatchdog(tcfg.straggler_factor)
        self._step = make_train_step(arch_cfg, opt_cfg,
                                     n_microbatches=tcfg.n_microbatches,
                                     remat=tcfg.remat)
        self.history: list[dict] = []

    # -- state ------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, device=self.device)
        return params, adamw.init(stacked_view(params, self.cfg),
                                  self.opt_cfg)

    def restore(self, state):
        """A checkpoint's ``{"params", "opt"}`` (CPU tensors in the
        reference's layout) as the port's parameters and optimizer state
        on the trainer's device."""
        return (params_from_reference(state["params"], self.cfg,
                                      self.device),
                _to_device(state["opt"], self.device))

    def _snapshot(self, params, opt_state):
        return {"params": params_to_reference(params, self.cfg),
                "opt": opt_state}

    # -- loop ---------------------------------------------------------------
    def run(self, steps: Optional[int] = None):
        steps = steps if steps is not None else self.tcfg.steps
        start, restored = (self.manager.restore() if self.manager
                           else (None, None))
        if restored is not None:
            params, opt_state = self.restore(restored)
            start = int(start)
        else:
            params, opt_state = self.init_state()
            start = 0

        done, saved, in_step = start, start, False
        try:
            for step in range(start, steps):
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.pipeline.batch(step).items()}
                t0 = time.perf_counter()
                in_step = True
                params, opt_state, metrics = self._step(params, opt_state,
                                                        batch)
                in_step = False
                done = step + 1
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                slow = self.watchdog.record(dt)
                metrics.update(step=step, dt=dt, straggler=slow)
                self.history.append(metrics)
                if self.manager and done % self.tcfg.ckpt_every == 0:
                    self.manager.save(done,
                                      self._snapshot(params, opt_state),
                                      blocking=not self.tcfg.async_ckpt)
                    saved = done
        finally:
            # a stopped run leaves a snapshot of its last whole step; one
            # stopped inside a step (the update writes the parameters in
            # place) resumes from its last periodic checkpoint instead
            if self.manager and not in_step and done != saved:
                self.manager.save(done, self._snapshot(params, opt_state),
                                  blocking=True)
            if self.manager:
                self.manager.wait()
        return params, opt_state
