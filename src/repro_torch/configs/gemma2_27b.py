"""gemma2-27b [dense] — local+global alternating, logit softcap
(arXiv:2408.00118).

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000, head_dim=128
(inner 4096 != d_model), attention softcap 50, final softcap 30, GeGLU,
local window 4096, tied embeddings.

Paper-technique applicability: local layers are already bounded by the 4096
window; the bounded-KV DAC manages the *global* layers on long_500k.
"""
from ..models.config import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=36864,
    vocab=256000,
    period=(LayerSpec("attn", window=4096), LayerSpec("attn")),
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="gemma2-27b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=128,
    vocab=256,
    period=(LayerSpec("attn", window=16), LayerSpec("attn")),
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)
