"""Optimizer (port of ``optim/``): AdamW with f32 or blockwise int8
moments."""
from .adamw import (AdamWConfig, dequantize, global_norm, init, quantize,
                    schedule, update)

__all__ = ["AdamWConfig", "init", "update", "schedule", "global_norm",
           "quantize", "dequantize"]
