"""Assigned input-shape cells (port of ``configs/shapes.py``).

Every LM arch is paired with the same four cells:
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                 KV cache of 32k)
  long_500k    seq 524,288 global_batch 1     -> serve_step; attention
                                                 archs run under the paper's
                                                 bounded-KV DAC manager
                                                 (budget slots << seq).

The reference's ``input_specs`` (built on ``jax.ShapeDtypeStruct``) has no
counterpart here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    bounded_budget: int = 0        # decode: DAC bounded-KV slot budget


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode",
                           bounded_budget=65536),
}
