"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
(arXiv:2403.19887).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period of 8 layers: one attention layer (index 4, as in the Jamba paper),
seven Mamba layers; the FFN alternates dense / MoE (MoE on odd layer
indices => 4 MoE layers per period).

Paper-technique applicability: the bounded-KV DAC applies to the attention
layers only (1/8 of layers); Mamba layers carry O(1) conv+ssm state.
long_500k decode is O(1) per mamba layer and O(budget) per attention layer.
"""
from ..models.config import ArchConfig, LayerSpec, MambaSpec, MoESpec


def _period():
    out = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        out.append(LayerSpec(kind, moe=(i % 2 == 1)))
    return tuple(out)


FULL = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    period=_period(),
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2, chunk=64),
)

SMOKE = ArchConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab=256,
    period=_period(),
    moe=MoESpec(n_experts=4, top_k=2, d_ff_expert=128),
    mamba=MambaSpec(d_state=8, d_conv=4, expand=2, chunk=8),
)
