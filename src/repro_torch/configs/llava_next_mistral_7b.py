"""llava-next-mistral-7b [vlm] — mistral backbone, anyres tiling
(hf:llava-hf/llava-v1.6-mistral-7b-hf).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.  The vision tower +
anyres patch merger is a STUB per the assignment: ``input_specs`` supplies
the merged sequence of precomputed patch+text embeddings [B, S, d].

Paper-technique applicability: full — standard KV cache, bounded-KV DAC on
decode.
"""
from ..models.config import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    period=(LayerSpec("attn"),),
    embeds_input=True,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    period=(LayerSpec("attn"),),
    embeds_input=True,
    rope_theta=1e6,
)
