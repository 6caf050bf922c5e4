"""Architecture configuration (port of ``models/config.py``).

An architecture is a *periodic* stack: ``period`` is a tuple of LayerSpec
describing one repeating group of layers (most archs have period length 1;
gemma2 alternates local/global attention with period 2; jamba repeats an
8-layer mamba/attention group).  The reference scans over periods with
stacked parameters; the port runs the stack as a Python loop over layers,
so the period only says which spec each layer uses.

All shapes are static and every config is hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0               # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    router_norm_topk: bool = True   # renormalize gates over the top-k


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model/16)
    chunk: int = 64                 # selective-scan chunk length


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    # mLSTM: matrix-memory cell with exponential gating, chunkwise-parallel.
    m_proj_factor: float = 2.0
    m_conv: int = 4
    m_chunk: int = 64
    # sLSTM: scalar-memory cell with hidden-to-gate recurrence (sequential).
    s_proj_factor: float = 1.3333333
    s_conv: int = 4


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period."""
    kind: str                       # attn | mla | mamba | mlstm | slstm
    window: Optional[int] = None    # sliding-window size (attn only)
    moe: bool = False               # FFN is MoE (else dense, unless d_ff==0)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                       # dense-FFN width (0 = block has no FFN)
    vocab: int
    period: Tuple[LayerSpec, ...]

    d_head: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"               # silu | gelu  (gated MLP)
    attn_softcap: float = 0.0       # 0 = off (gemma2: 50)
    final_softcap: float = 0.0      # 0 = off (gemma2: 30)
    tie_embeddings: bool = False

    moe: Optional[MoESpec] = None
    mamba: Optional[MambaSpec] = None
    xlstm: Optional[XLSTMSpec] = None

    # MLA (deepseek-v2) geometry
    kv_lora_rank: int = 0           # >0 enables MLA paths
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # modality frontend stub: model consumes precomputed embeddings
    embeds_input: bool = False

    # numerics / execution
    param_dtype: str = "bfloat16"
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.period) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"period length {len(self.period)}")
        return self.n_layers // len(self.period)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def layer_specs(self):
        """All n_layers LayerSpecs in order."""
        return [self.period[i % len(self.period)] for i in range(self.n_layers)]
