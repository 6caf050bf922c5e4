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

``input_specs`` gives each cell's model inputs as :class:`TensorSpec`
records (shape and dtype, nothing allocated); ``launch.dryrun`` makes
them fake tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


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


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, nothing allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype

    def make(self, device="cpu") -> torch.Tensor:
        """An uninitialised tensor of this spec (a fake one under a
        ``FakeTensorMode``)."""
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def input_specs(cfg, shape: "ShapeCell | str") -> dict:
    """Model-input specs for one (arch x shape) cell, the reference's
    shapes and dtypes:

    train:   {tokens | embeds, labels}
    prefill: {tokens | embeds}
    decode:  {token [B] | embed [B, d]}  (the serve state's specs are
             ``serving.serve_state_specs``: step state, not model input)

    Token ids take the dtype the port's steps are given: int32 in
    training (``data.tokens``, as the reference), int64 in serving
    (``launch.serve``; the reference's are int32).  Embeddings are bf16.

    >>> from repro_torch.configs import ARCHS
    >>> input_specs(ARCHS["deepseek-7b"], "decode_32k")["token"]
    TensorSpec(shape=(128,), dtype=torch.int64)
    """
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = cell.global_batch, cell.seq_len
    d = cfg.d_model
    bf16 = torch.bfloat16
    if cell.kind == "train":
        spec = {"labels": TensorSpec((B, S), torch.int32)}
        if cfg.embeds_input:
            spec["embeds"] = TensorSpec((B, S, d), bf16)
        else:
            spec["tokens"] = TensorSpec((B, S), torch.int32)
        return spec
    if cell.kind == "prefill":
        if cfg.embeds_input:
            return {"embeds": TensorSpec((B, S, d), bf16)}
        return {"tokens": TensorSpec((B, S), torch.int64)}
    if cell.kind == "decode":
        if cfg.embeds_input:
            return {"embed": TensorSpec((B, d), bf16)}
        return {"token": TensorSpec((B,), torch.int64)}
    raise ValueError(cell.kind)
