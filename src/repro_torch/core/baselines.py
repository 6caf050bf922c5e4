"""Baseline policies of the port (from ``core/baselines.py``): Climb, the
classic rank policy, and the slot policies FIFO (the MRR baseline) and LRU.

FIFO and LRU are plain torch over the lane axis, as the reference has no
kernel for them either.  Their per-slot state matches the reference's
layout; LRU's timestamps are int64 (the reference widens them to int64
only under x64, and torch has no such switch).
"""
from __future__ import annotations

import torch

from .policy import (EMPTY, PLAN_CLIMB, Plan, Policy, RankPolicy, Request,
                     find, lane_scalar, padded_row, step_info)

__all__ = ["Climb", "FIFO", "LRU"]


class FIFO(Policy):
    """First-in-first-out ring buffer: misses overwrite the oldest
    insertion; hits touch nothing.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("fifo", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    1
    """

    name = "fifo"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"keys": torch.full((lanes, K), EMPTY, dtype=torch.int32,
                                   device=device),
                "head": lane_scalar(0, lanes, device)}

    def step(self, state, req: Request):
        keys, head = state["keys"], state["head"]
        K = keys.shape[-1]
        hit = (keys == req.key.unsqueeze(-1)).any(-1)
        at = head.long().unsqueeze(-1)
        evicted = keys.gather(-1, at).squeeze(-1)
        keys_m = keys.scatter(-1, at, req.key.to(torch.int32).unsqueeze(-1))
        return {
            "keys": torch.where(hit.unsqueeze(-1), keys, keys_m),
            "head": torch.where(hit, head, (head + 1) % K),
        }, step_info(hit, req, evicted_key=evicted)


class LRU(Policy):
    """Least-recently-used: every hit refreshes a per-slot timestamp,
    misses evict the stalest slot (empty slots, stamped -1, first).

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("lru", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    2
    """

    name = "lru"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {
            "keys": torch.full((lanes, K), EMPTY, dtype=torch.int32,
                               device=device),
            "last": torch.full((lanes, K), -1, dtype=torch.int64,
                               device=device),
            "t": torch.zeros(lanes, dtype=torch.int64, device=device),
        }

    def step(self, state, req: Request):
        keys, last, t = state["keys"], state["last"], state["t"]
        hit, i = find(keys, req.key)
        v = last.argmin(-1).to(torch.int32)   # first minimum, as jnp
        slot = torch.where(hit, i, v).long().unsqueeze(-1)
        evicted = keys.gather(-1, v.long().unsqueeze(-1)).squeeze(-1)
        keys = keys.scatter(-1, slot, req.key.to(torch.int32).unsqueeze(-1))
        last = last.scatter(-1, slot, t.unsqueeze(-1))
        return {"keys": keys, "last": last, "t": t + 1}, \
            step_info(hit, req, evicted_key=evicted)


def _climb_law(hit, i, scalars):
    (n,) = scalars
    # hit: swap one rank up; miss: replace the bottom in place
    src = torch.where(hit, i, n - 1)
    t = torch.where(hit, (i - 1).clamp(min=0), n - 1)
    return src, t, n, (n,)


class Climb(RankPolicy):
    """Classic CLIMB: a hit swaps the entry one rank up; a miss replaces
    the bottom rank in place.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("climb", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    0
    """

    name = "climb"
    SCALARS = ("len",)

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"cache": padded_row(K, lanes, device),
                "len": lane_scalar(K, lanes, device)}

    def plan(self) -> Plan:
        return Plan(PLAN_CLIMB, _climb_law)
