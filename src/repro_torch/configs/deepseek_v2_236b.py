"""deepseek-v2-236b [moe] — MLA + 2 shared + 160 routed top-6
(arXiv:2405.04434).

60L d_model=5120 128H d_ff=1536 (expert width) vocab=102400, MLA
kv_lora=512 (q_lora=1536, decoupled RoPE 64, nope 128, v 128).

Paper-technique applicability: bounded-KV DAC manages the (latent, k_rope)
cache — only (512+64) floats/token, so MLA *compounds* with the paper's
eviction (smallest possible per-slot cost).  long_500k runs under the
bounded budget.
"""
from ..models.config import ArchConfig, LayerSpec, MoESpec

FULL = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,
    vocab=102400,
    period=(LayerSpec("mla", moe=True),),
    moe=MoESpec(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
)

SMOKE = ArchConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=256,
    period=(LayerSpec("mla", moe=True),),
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1),
    kv_lora_rank=32,
    q_lora_rank=24,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
)
