"""codeqwen1.5-7b [dense] — qwen1.5-arch (hf:Qwen/CodeQwen1.5-7B).

32L d_model=4096 32H (MHA kv=32) d_ff=13440 vocab=92416, QKV bias.

Paper-technique applicability: full — standard KV cache, bounded-KV DAC on
decode.
"""
from ..models.config import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    period=(LayerSpec("attn"),),
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="codeqwen1.5-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    period=(LayerSpec("attn"),),
    qkv_bias=True,
    rope_theta=1e6,
)
