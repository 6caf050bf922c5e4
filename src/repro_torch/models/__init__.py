"""LM substrate (port of ``models/``): the decoder stack with every layer
kind of the repo's configurations (attention, MLA, Mamba, mLSTM, sLSTM;
dense or MoE FFNs) in the reference's configs and parameter layouts.
Sharding (``models/sharding.py``) is not ported yet (ROADMAP A12.4)."""
from .config import ArchConfig, LayerSpec, MambaSpec, MoESpec, XLSTMSpec
from .convert import (params_from_reference, serve_state_from_reference,
                      serve_state_to_numpy)
from .model import forward, init_params, param_count

__all__ = [
    "ArchConfig", "LayerSpec", "MambaSpec", "MoESpec", "XLSTMSpec",
    "forward", "init_params", "param_count", "params_from_reference",
    "serve_state_from_reference", "serve_state_to_numpy",
]
