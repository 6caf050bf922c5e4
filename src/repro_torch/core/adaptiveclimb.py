"""AdaptiveClimb — Algorithm 1 of the paper (port of
``core/adaptiveclimb.py``).

State: lane-padded rank rows ``cache [B, lane_pad(K)]`` plus the scalars
``jump`` and ``len`` (the logical capacity K), one per lane.

  * hit at rank i:   jump = max(jump-1, 1); promote to t = max(i - jump, 0)
  * miss on key j:   jump = min(jump+1, K); evict rank K-1; insert j at
    rank K - jump
"""
from __future__ import annotations

import torch

from .policy import (PLAN_ADAPTIVECLIMB, Plan, RankPolicy, lane_scalar,
                     padded_row)

__all__ = ["AdaptiveClimb"]


def _ac_law(hit, i, scalars):
    jump, n = scalars
    jump_h = (jump - 1).clamp(min=1)
    t_h = (i - jump_h).clamp(min=0)
    jump_m = torch.minimum(jump + 1, n)
    t_m = n - jump_m
    src = torch.where(hit, i, n - 1)
    t = torch.where(hit, t_h, t_m)
    return src, t, n, (torch.where(hit, jump_h, jump_m), n)


class AdaptiveClimb(RankPolicy):
    """Algorithm 1: CLIMB with an adaptive jump distance.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("adaptiveclimb",
    ...     [0, 1, 0, 2, 0, 1, 2, 0], K=2, collect_info=False).metrics.hits)
    2
    """

    name = "adaptiveclimb"

    # jump is a pure adaptation scalar, decoupled from the rank row
    ADAPT_KEYS = ("jump",)
    SCALARS = ("jump", "len")

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"cache": padded_row(K, lanes, device),
                "jump": lane_scalar(K, lanes, device),
                "len": lane_scalar(K, lanes, device)}

    def plan(self) -> Plan:
        return Plan(PLAN_ADAPTIVECLIMB, _ac_law)
