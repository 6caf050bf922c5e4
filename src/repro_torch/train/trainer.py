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
* **Sharded training and elastic restarts**: with ``sctx`` every rank of
  the mesh runs a trainer with its blocks of the model and optimizer
  state and its rows of each global batch.  A checkpoint holds the whole
  model in the reference's layout: every rank gathers the blocks (on the
  main thread, before any asynchronous write), rank 0 writes, and the
  others meet it in a collective before they go on; with asynchronous
  saves they meet it once more when its writer has finished, so that no
  rank leaves :meth:`Trainer.run` before the last checkpoint is on disk.
  :meth:`Trainer.restore_into_mesh` cuts each rank's blocks for the
  current mesh from a checkpoint, so a run saved on one mesh (8 ranks,
  say) resumes on another (4), and on the unsharded port or the
  reference.
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
from ..models import init_params, sharding
from ..models.convert import (params_from_reference, params_to_reference,
                              stacked_view)
from ..models.model import param_shapes
from ..optim import adamw
from .train_step import make_train_step, placement

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
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _rank_device(mesh) -> torch.device:
    """The device of this rank's blocks: the mesh's type, on CUDA the
    card ``init_distributed`` set."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Trainer:
    """The training loop on ``device``, or, with ``sctx`` (a ``ShardCtx``
    over a ``DeviceMesh``; ``device`` is then the rank's, from
    ``init_distributed``), on each rank of the mesh."""

    def __init__(self, arch_cfg, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainConfig, sctx=None, device="cuda"):
        self.cfg = arch_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.sctx = sctx
        if sctx is not None:
            from ..launch.mesh import check_mesh
            device = _rank_device(check_mesh(sctx.mesh))
            shapes = param_shapes(arch_cfg)
            self._cuts = sharding.cuts(
                shapes, sharding.param_specs(shapes, arch_cfg, sctx),
                sctx.mesh)
            self._place = placement(arch_cfg, sctx)
        self.device = torch.device(device)
        self.manager = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
                        if tcfg.ckpt_dir is not None else None)
        self.pipeline = TokenPipeline(
            arch_cfg.vocab, tcfg.global_batch, tcfg.seq_len, seed=tcfg.seed,
            embed_dim=arch_cfg.d_model if arch_cfg.embeds_input else 0)
        self.watchdog = StragglerWatchdog(tcfg.straggler_factor)
        self._step = make_train_step(arch_cfg, opt_cfg, sctx=sctx,
                                     n_microbatches=tcfg.n_microbatches,
                                     remat=tcfg.remat)
        self.history: list[dict] = []

    @property
    def _lead(self) -> bool:
        """Whether this rank writes the checkpoints (rank 0 of a mesh)."""
        return self.sctx is None or torch.distributed.get_rank() == 0

    # -- state ------------------------------------------------------------
    def init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(self.cfg, gen, device=self.device,
                             sctx=self.sctx)
        place = None if self.sctx is None else self._place
        return params, adamw.init(stacked_view(params, self.cfg),
                                  self.opt_cfg, place)

    def restore_into_mesh(self, state):
        """A checkpoint's ``{"params", "opt"}`` (CPU tensors in the
        reference's layout, the whole model) as the port's parameters and
        optimizer state on the trainer's device: under a mesh, this
        rank's blocks for the current mesh, whatever mesh wrote it (the
        elastic restart)."""
        if self.sctx is None:
            return (params_from_reference(state["params"], self.cfg,
                                          self.device),
                    _to_device(state["opt"], self.device))
        whole = params_from_reference(state["params"], self.cfg, "cpu")
        params = _zip_map(lambda x, cut: cut(x).contiguous().to(self.device),
                          whole, self._cuts)
        opt = adamw.cut_state(state["opt"], stacked_view(params, self.cfg),
                              self._place, self.opt_cfg)
        return params, _to_device(opt, self.device)

    def _snapshot(self, params, opt_state):
        """The whole model's ``{"params", "opt"}`` in the reference's
        layout; under a mesh gathered from every rank's blocks (every rank
        runs it)."""
        if self.sctx is not None:
            with torch.no_grad():
                opt_state = adamw.whole_state(
                    opt_state, stacked_view(params, self.cfg), self._place,
                    self.opt_cfg)
                params = _zip_map(lambda x, cut: cut.whole(x), params,
                                  self._cuts)
        return {"params": params_to_reference(params, self.cfg),
                "opt": opt_state}

    def _save(self, step, params, opt_state, blocking):
        """Snapshot and save ``step``: under a mesh every rank gathers,
        rank 0 writes (or hands its host copy to the writer thread), and
        the others wait for it in a collective."""
        snap = self._snapshot(params, opt_state)
        if self._lead:
            self.manager.save(step, snap, blocking=blocking)
        del snap
        self._meet()

    def _meet(self):
        """Under a mesh, wait for every rank (a zero-size sum)."""
        if self.sctx is not None:
            from ..launch.mesh import seq_sum
            mesh = self.sctx.mesh
            seq_sum(torch.zeros((), device=self.device), mesh,
                    mesh.mesh_dim_names)

    def _rows(self, batch):
        """This rank's rows of a global batch (numpy) on its device."""
        out = {k: torch.from_numpy(v) for k, v in batch.items()}
        if self.sctx is not None:
            axes = self.sctx.batch_axes
            out = {k: sharding._block(v, 0, self.sctx.mesh, axes)
                   for k, v in out.items()}
        return {k: v.to(self.device) for k, v in out.items()}

    # -- loop ---------------------------------------------------------------
    def run(self, steps: Optional[int] = None):
        steps = steps if steps is not None else self.tcfg.steps
        start, restored = (self.manager.restore() if self.manager
                           else (None, None))
        if restored is not None:
            params, opt_state = self.restore_into_mesh(restored)
            start = int(start)
        else:
            params, opt_state = self.init_state()
            start = 0

        done, saved, in_step = start, start, False
        try:
            for step in range(start, steps):
                batch = self._rows(self.pipeline.batch(step))
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
                    self._save(done, params, opt_state,
                               blocking=not self.tcfg.async_ckpt)
                    saved = done
        finally:
            # a stopped run leaves a snapshot of its last whole step; one
            # stopped inside a step (the update writes the parameters in
            # place) resumes from its last periodic checkpoint instead
            if self.manager and not in_step and done != saved:
                self._save(done, params, opt_state, blocking=True)
            if self.manager:
                try:
                    self.manager.wait()
                finally:
                    # rank 0's writer is done: the others may go on
                    if not in_step:
                        self._meet()
        return params, opt_state


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, a, b) for a, b in zip(tree, other)]
    return fn(tree, other)
