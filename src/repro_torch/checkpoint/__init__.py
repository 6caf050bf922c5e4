"""Checkpoints (port of ``checkpoint/``): atomic, keep-k, async, in the
reference's on-disk format."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
