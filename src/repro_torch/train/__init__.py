"""Training (port of ``train/``): the train step, sharded over a mesh or
not, the compressed multi-pod step, the trainer with checkpoints, resume
and elastic restarts, the straggler watchdog."""
from .train_step import (init_ef_state, make_compressed_train_step,
                         make_train_step)
from .trainer import StragglerWatchdog, TrainConfig, Trainer

__all__ = ["make_train_step", "make_compressed_train_step", "init_ef_state",
           "Trainer", "TrainConfig", "StragglerWatchdog"]
