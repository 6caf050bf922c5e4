"""Multi-tenant shared-budget cache tier driven by DAC resize signals
(port of ``repro.tier``).

N tenant caches share one global slot budget: shrinks feed a free pool,
and saturated ``jump`` controllers draw their doublings from it through a
pluggable arbiter (``static`` / ``greedy`` / ``proportional``; the
``auction`` arbiter prices grants by byte-miss cost and pairs with the
fleet layer, :mod:`repro_torch.fleet`).

>>> import numpy as np
>>> from repro_torch.data.traces import tenants_trace
>>> tier = CacheTier("dac", n_tenants=4, budget=64, arbiter="greedy")
>>> reqs = tenants_trace(N=64, T=500, n_tenants=4, period=128, lo=8)
>>> res = replay_tier(tier, reqs, observe=True, device="cpu")
>>> res.miss_ratio.shape                          # per-tenant ratios
(4,)
>>> bool(res.obs["k"].sum(-1).max() <= 64)        # conservation
True
"""
from .arbiter import (ARBITERS, Arbiter, AuctionArbiter, GreedyArbiter,
                      ProportionalArbiter, StaticArbiter, make_arbiter)
from .tier import CacheTier, TierResult, replay_tier

__all__ = [
    "CacheTier", "TierResult", "replay_tier",
    "Arbiter", "StaticArbiter", "GreedyArbiter", "ProportionalArbiter",
    "AuctionArbiter", "ARBITERS", "make_arbiter",
]
