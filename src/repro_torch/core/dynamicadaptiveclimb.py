"""DynamicAdaptiveClimb — Algorithm 2 of the paper with dynamic resizing
(port of ``core/dynamicadaptiveclimb.py``).

The row is allocated at ``lane_pad(K * growth)``; the active size ``k`` and
the allocation bound ``kmax = K * growth`` are per-lane int32 scalars, and
ranks ``>= k`` are ``EMPTY``.  Doubling activates already-empty ranks;
halving wipes ranks ``>= k/2`` in the same fused step.  The control law
lives in :mod:`repro_torch.core.control`; the reference's module docstring
gives the line-by-line mapping and the documented interpretation choices,
which this port keeps unchanged.
"""
from __future__ import annotations

import torch

from .control import hit_update, miss_update, resize_update
from .policy import (PLAN_DAC, PLAN_DAC_BUDGETED, Plan, RankPolicy, Request,
                     lane_scalar, padded_row)

__all__ = ["DynamicAdaptiveClimb"]


class DynamicAdaptiveClimb(RankPolicy):
    """Algorithm 2: AdaptiveClimb plus the jump'-driven dynamic resizing.

    ``eps`` scales the halving threshold, ``growth`` sets the allocation
    headroom (``K_max = K * growth``), ``k_min`` floors the active size.

    >>> from repro_torch.core import Engine
    >>> res = Engine(device="cpu").replay("dac(eps=0.5,growth=4)",
    ...                                   [0, 1] * 20, K=4, observe=True)
    >>> int(res.metrics.hits)
    38
    >>> int(res.obs["k"][-1])   # hits concentrate -> the cache halved
    2
    """

    name = "dynamicadaptiveclimb"

    # adaptation scalars an admission wrapper lets advance on a rejected
    # insert (see the reference's ADAPT_KEYS note)
    ADAPT_KEYS = ("jump", "jump2", "k", "kmax")
    SCALARS = ("jump", "jump2", "k", "kmax")

    def __init__(self, eps: float = 0.5, growth: int = 4, k_min: int = 2):
        self.eps = float(eps)
        self.growth = int(growth)
        self.k_min = int(k_min)

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        """Fresh state at active size ``K`` on ``lanes`` lanes.

        >>> st = DynamicAdaptiveClimb(growth=2).init(4, device="cpu")
        >>> tuple(st["cache"].shape), int(st["k"][0]), int(st["kmax"][0])
        ((1, 128), 4, 8)
        """
        K_max = K * self.growth
        return {
            "cache": padded_row(K_max, lanes, device),
            "jump": lane_scalar(K, lanes, device),
            "jump2": lane_scalar(0, lanes, device),
            "k": lane_scalar(K, lanes, device),
            "kmax": lane_scalar(K_max, lanes, device),
        }

    def observables(self, state):
        """Per-step signals the engine collects under ``observe=True``."""
        return {"k": state["k"], "jump": state["jump"]}

    def _law(self, budgeted: bool):
        eps, k_min = self.eps, self.k_min

        def law(hit, i, scalars):
            if budgeted:
                jump, jump2, k, kmax, cap = scalars
            else:
                jump, jump2, k, kmax = scalars
            # hit path; i == 0 is the identity shift
            jump_h, jump2_h, actual_h = hit_update(jump, jump2, i, k)
            t_h = torch.where(i > 0, i - actual_h, 0)
            # miss path: evict rank k-1, insert at k - actual
            jump_m, jump2_m, actual_m = miss_update(jump, jump2, k)
            t_m = k - actual_m
            src = torch.where(hit, i, k - 1)
            t = torch.where(hit, t_h, t_m)
            jump = torch.where(hit, jump_h, jump_m)
            jump2 = torch.where(hit, jump2_h, jump2_m)
            # resize checks after every request
            k_new, jump, jump2, _, shrink = resize_update(
                jump, jump2, k, eps=eps, k_min=k_min, kmax=kmax,
                cap=cap if budgeted else None)
            wipe_from = torch.where(shrink, k_new, kmax)
            if budgeted:
                return src, t, wipe_from, (jump, jump2, k_new, kmax, cap)
            return src, t, wipe_from, (jump, jump2, k_new, kmax)

        return law

    def plan(self, budgeted: bool = False) -> Plan:
        """The Alg. 2 law as a :class:`~repro_torch.core.policy.Plan`;
        ``budgeted`` threads an arbiter's capacity cap as a fifth scalar
        (``k -> min(2k, cap, kmax)`` on a grow)."""
        return Plan(PLAN_DAC_BUDGETED if budgeted else PLAN_DAC,
                    self._law(budgeted), self.eps, self.k_min)

    def step_budgeted(self, state, req: Request):
        """Like :meth:`step`, with growth gated by ``state["cap"]``, which
        rides through the step unchanged.

        >>> pol = DynamicAdaptiveClimb(growth=2)
        >>> st = dict(pol.init(4, device="cpu"),
        ...           cap=torch.tensor([4], dtype=torch.int32))
        >>> for key in range(8):
        ...     st, _ = pol.step_budgeted(
        ...         st, Request.of([key], device="cpu"))
        >>> int(st["jump"][0]), int(st["k"][0])   # saturated at 2k, denied
        (8, 4)
        """
        return self._rank_step(state, req, self.plan(budgeted=True),
                               self.SCALARS + ("cap",))
