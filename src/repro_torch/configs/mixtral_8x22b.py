"""mixtral-8x22b [moe] — 8 experts top-2, SWA (arXiv:2401.04088).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, sliding window 4096
per the assignment.

Paper-technique applicability: bounded-KV DAC applies to every layer's KV
cache; SWA already bounds the window to 4096 — the DAC budget manages the
*retained* set beyond the window on long_500k (DAC budget > window, so the
policy decides which out-of-window entries survive).
"""
from ..models.config import ArchConfig, LayerSpec, MoESpec

FULL = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    period=(LayerSpec("attn", window=4096, moe=True),),
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384),
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="mixtral-8x22b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    period=(LayerSpec("attn", window=16, moe=True),),
    moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=128),
    rope_theta=1e6,
)
