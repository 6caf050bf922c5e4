"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

12L d_model=768 4H d_ff=0 vocab=50304.  Blocks alternate mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, sequential); there is
no separate FFN (d_ff=0): each block carries its own projections.

Paper-technique applicability: NONE for the bounded-KV manager — the state
is O(1) per layer already (nothing to evict).  The trace-simulator form of
DynamicAdaptiveClimb (repro.core) is architecture-independent.  long_500k
runs natively (recurrent decode).
"""
from ..models.config import ArchConfig, LayerSpec, XLSTMSpec

FULL = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    period=(LayerSpec("mlstm"), LayerSpec("slstm")),
    xlstm=XLSTMSpec(),
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="xlstm-125m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=256,
    period=(LayerSpec("mlstm"), LayerSpec("slstm")),
    xlstm=XLSTMSpec(m_chunk=8),
    tie_embeddings=True,
)
