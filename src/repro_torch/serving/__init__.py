"""Serving (port of ``serving/``): bounded (DynamicAdaptiveClimb-managed)
and unbounded KV-cache decode and prefill."""
from . import kv_cache
from .serve_step import (decode_step, init_serve_state, prefill,
                         serve_state_specs)

__all__ = ["kv_cache", "decode_step", "init_serve_state", "prefill",
           "serve_state_specs"]
