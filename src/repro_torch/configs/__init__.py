"""Architecture registry (port of ``configs/``): the 10 assigned archs
(+ smoke variants) and the input-shape cells.  Configs are plain data,
copied from the reference; ``tests/test_torch_isolation.py`` holds them
equal field for field."""
from . import (codeqwen15_7b, deepseek_7b, deepseek_v2_236b, gemma2_27b,
               jamba_15_large_398b, llava_next_mistral_7b, mixtral_8x22b,
               musicgen_medium, qwen15_110b, xlstm_125m)
from .shapes import SHAPES, ShapeCell, TensorSpec, input_specs

_MODULES = {
    "xlstm-125m": xlstm_125m,
    "deepseek-v2-236b": deepseek_v2_236b,
    "mixtral-8x22b": mixtral_8x22b,
    "musicgen-medium": musicgen_medium,
    "qwen1.5-110b": qwen15_110b,
    "deepseek-7b": deepseek_7b,
    "gemma2-27b": gemma2_27b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "jamba-1.5-large-398b": jamba_15_large_398b,
}

ARCHS = {name: mod.FULL for name, mod in _MODULES.items()}
SMOKE_ARCHS = {name: mod.SMOKE for name, mod in _MODULES.items()}


def get_arch(name: str, smoke: bool = False):
    table = SMOKE_ARCHS if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]


__all__ = ["ARCHS", "SMOKE_ARCHS", "SHAPES", "ShapeCell", "TensorSpec",
           "get_arch", "input_specs"]
