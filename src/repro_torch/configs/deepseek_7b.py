"""deepseek-7b [dense] — llama-arch (arXiv:2401.02954).

30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400.

Paper-technique applicability: full — standard KV cache, bounded-KV DAC on
decode.
"""
from ..models.config import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    period=(LayerSpec("attn"),),
)

SMOKE = ArchConfig(
    name="deepseek-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    period=(LayerSpec("attn"),),
)
