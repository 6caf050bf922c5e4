"""Training (port of ``train/``): the train step, the trainer with
checkpoints and resume, the straggler watchdog.  The compressed multi-pod
step is sharded training, ROADMAP A13.3."""
from .train_step import make_train_step
from .trainer import StragglerWatchdog, TrainConfig, Trainer

__all__ = ["make_train_step", "Trainer", "TrainConfig", "StragglerWatchdog"]
