"""qwen1.5-110b [dense] — QKV bias (hf:Qwen/Qwen1.5 family).

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.

Paper-technique applicability: full — standard KV cache, bounded-KV DAC on
decode; long_500k runs under the bounded budget (full attention would be
quadratic).
"""
from ..models.config import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    period=(LayerSpec("attn"),),
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen1.5-110b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    period=(LayerSpec("attn"),),
    qkv_bias=True,
    rope_theta=1e6,
)
