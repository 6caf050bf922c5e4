"""LM substrate (port of ``models/``): the decoder stack with every layer
kind of the repo's configurations (attention, MLA, Mamba, mLSTM, sLSTM;
dense or MoE FFNs) in the reference's configs and parameter layouts, and
the training loss ``lm_loss``; the sharding rules (``models/sharding.py``),
with the sharded serve path of every configuration."""
from .config import ArchConfig, LayerSpec, MambaSpec, MoESpec, XLSTMSpec
from .convert import (params_from_reference, params_to_reference,
                      serve_state_from_reference, serve_state_to_numpy,
                      stacked_view)
from .model import forward, init_params, lm_loss, param_count

__all__ = [
    "ArchConfig", "LayerSpec", "MambaSpec", "MoESpec", "XLSTMSpec",
    "forward", "init_params", "lm_loss", "param_count",
    "params_from_reference", "params_to_reference", "stacked_view",
    "serve_state_from_reference", "serve_state_to_numpy",
]
