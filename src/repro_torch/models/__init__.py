"""LM substrate (port of ``models/``): dense attention decoders with the
reference's configs and parameter layouts.  MLA, MoE, SSM/xLSTM layers and
sharding are not ported yet (ROADMAP A12)."""
from .config import ArchConfig, LayerSpec, MambaSpec, MoESpec, XLSTMSpec
from .convert import (params_from_reference, serve_state_from_reference,
                      serve_state_to_numpy)
from .model import forward, init_params, param_count

__all__ = [
    "ArchConfig", "LayerSpec", "MambaSpec", "MoESpec", "XLSTMSpec",
    "forward", "init_params", "param_count", "params_from_reference",
    "serve_state_from_reference", "serve_state_to_numpy",
]
