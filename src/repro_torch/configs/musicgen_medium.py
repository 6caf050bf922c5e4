"""musicgen-medium [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284).

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.  The EnCodec
frontend is a STUB per the assignment: ``input_specs`` supplies precomputed
frame embeddings [B, S, d]; the backbone predicts codebook tokens over the
2048-entry vocab.

Paper-technique applicability: full — standard KV cache, bounded-KV DAC on
decode.
"""
from ..models.config import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    period=(LayerSpec("attn"),),
    embeds_input=True,
    act="gelu",
)

SMOKE = ArchConfig(
    name="musicgen-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    period=(LayerSpec("attn"),),
    embeds_input=True,
    act="gelu",
)
