"""Capacity arbiters: who gets the shared budget's free slots (port of
``tier/arbiter.py``).

Each tenant's DynamicAdaptiveClimb *signals* (``jump`` saturating at
``2k`` is a grow demand, a shrink returns slots) and the arbiter turns
those signals into per-tenant capacity **caps** for the next step:
``cap == k`` denies growth, ``cap == 2k`` grants the full doubling,
``k < cap < 2k`` is a partial grant.

Arbiters are functions of the post-step tier state over the last axis::

    caps = arbiter(k, demanding, budget, n_tenants)   # [..., N] tensors

The leading axes are independent tiers (the reference's seed ``vmap``
written out); ``budget`` is a Python int or a tensor that broadcasts
against ``k``'s leading axes with a trailing axis of 1 (the fleet's
per-tier effective budget).  Every arbiter is plain torch with no host
sync, so a tier or fleet step that calls it can be captured in a CUDA
graph.  Granted headroom never exceeds the free pool ``budget - sum(k)``,
so ``sum(k) <= budget`` holds at every step.

>>> make_arbiter("greedy")
GreedyArbiter()
>>> make_arbiter("static(share=64)")
StaticArbiter(share=64)
"""
from __future__ import annotations

import torch

from ..specs import build_kwargs, parse_spec

__all__ = ["Arbiter", "StaticArbiter", "GreedyArbiter",
           "ProportionalArbiter", "AuctionArbiter", "ARBITERS",
           "make_arbiter"]


def _sum(x):
    """int32 sum over the last axis, as the reference sums its int32 sizes
    (torch would widen an integer sum to int64)."""
    return x.sum(-1, keepdim=True, dtype=torch.int32)


def _seq_sum(x):
    """float32 sum over the last axis, added left to right: the order in
    which XLA's CPU backend reduces a short row, so a floor of the result
    agrees with the reference bit for bit (``torch.sum`` sums in another
    order past eight elements)."""
    out = x[..., :1]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j:j + 1]
    return out


class Arbiter:
    """Base class: hashable, one ``__call__(k, demanding, budget,
    n_tenants, utility=None) -> caps`` method.  ``utility`` (float32, the
    shape of ``k``) is the fleet's byte-miss-cost EWMA that utility-aware
    arbiters price grants by.

    ``pooled`` marks arbiters that allocate out of the *shared* free pool;
    the static partitioner is the one non-pooled arbiter.
    ``needs_utility`` marks arbiters meaningless without the utility
    signal (the fleet replay carries it; the plain tier does not)."""

    name: str = "base"
    pooled: bool = True
    needs_utility: bool = False

    def __call__(self, k, demanding, budget, n_tenants: int, utility=None):
        raise NotImplementedError

    def _fields(self):
        return tuple(sorted(self.__dict__.items()))

    def __hash__(self):
        return hash((type(self).__name__, self._fields()))

    def __eq__(self, other):
        return type(self) is type(other) and self._fields() == other._fields()

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


def _free_pool(k, budget):
    """Unclaimed slots: the budget minus every tenant's active size."""
    return torch.clamp(budget - _sum(k), min=0)


def _demand(k, demanding, budget):
    """Requested extra slots per tenant: a saturated tenant wants to double
    (``+k``), bounded by the budget-wide array width."""
    want = torch.minimum(k, budget - k)
    return torch.where(demanding, torch.clamp(want, min=0), 0)


class StaticArbiter(Arbiter):
    """Hard partitioning: every tenant owns a fixed ``share`` (default
    ``budget // n_tenants``) and grows iff ``2k <= share``, so a static tier
    is exactly N independent DynamicAdaptiveClimb caches with
    ``K_max = share``.

    >>> arb = StaticArbiter()
    >>> k = torch.tensor([4, 8], dtype=torch.int32)
    >>> arb(k, torch.tensor([True, True]), budget=16, n_tenants=2).tolist()
    [8, 8]
    """

    name = "static"
    pooled = False

    def __init__(self, share: int = 0):
        self.share = int(share)   # 0 -> budget // n_tenants

    def __call__(self, k, demanding, budget, n_tenants: int, utility=None):
        share = self.share or budget // n_tenants
        return torch.where(2 * k <= share, 2 * k, k).to(torch.int32)


class GreedyArbiter(Arbiter):
    """First come, first served over the tenant axis: each demander in
    index order gets as much of its doubling as the remaining free pool
    covers (partial at the boundary), as a cumulative sum.

    >>> arb = GreedyArbiter()
    >>> k = torch.tensor([4, 4, 4], dtype=torch.int32)
    >>> # free pool = 18 - 12 = 6: tenant 0 gets +4, tenant 1 the last +2
    >>> arb(k, torch.tensor([True, True, True]), budget=18,
    ...     n_tenants=3).tolist()
    [8, 6, 4]
    """

    name = "greedy"

    def __call__(self, k, demanding, budget, n_tenants: int, utility=None):
        free = _free_pool(k, budget)
        demand = _demand(k, demanding, budget)
        # pool already spoken for
        before = torch.cumsum(demand, -1, dtype=torch.int32) - demand
        grant = torch.minimum(torch.clamp(free - before, min=0), demand)
        return (k + grant).to(torch.int32)


class ProportionalArbiter(Arbiter):
    """Split the free pool among demanders in proportion to their demand
    (floor division: never over-grants).

    >>> arb = ProportionalArbiter()
    >>> k = torch.tensor([4, 4, 4], dtype=torch.int32)
    >>> # free pool = 16 - 12 = 4 split over 8 demanded: +2 each
    >>> arb(k, torch.tensor([True, True, False]), budget=16,
    ...     n_tenants=3).tolist()
    [6, 6, 4]
    """

    name = "proportional"

    def __call__(self, k, demanding, budget, n_tenants: int, utility=None):
        free = _free_pool(k, budget)
        demand = _demand(k, demanding, budget)
        total = _sum(demand)
        # int32, as in the reference: free * demand stays below 2^31 for
        # budgets up to 46,340 slots
        prop = torch.where(total > 0,
                           free * demand // torch.clamp(total, min=1), 0)
        grant = torch.minimum(demand, prop)
        return (k + grant).to(torch.int32)


class AuctionArbiter(Arbiter):
    """Price capacity by value: each demander bids its recent byte-miss
    cost (``utility``), and the free pool is split in proportion to
    utility-weighted demand, floored.  Uniform utilities (including none)
    give :class:`ProportionalArbiter`'s grants bit for bit; a single
    demander gets ``min(demand, free)``.

    >>> arb = AuctionArbiter()
    >>> k = torch.tensor([4, 4, 4], dtype=torch.int32)
    >>> demanding = torch.tensor([True, True, False])
    >>> u = torch.tensor([3.0, 1.0, 0.0])
    >>> # free pool = 16 - 12 = 4; bids 3:1 -> +3 / +1
    >>> arb(k, demanding, 16, 3, utility=u).tolist()
    [7, 5, 4]
    >>> arb(k, demanding, 16, 3).tolist()    # no signal: proportional
    [6, 6, 4]
    """

    name = "auction"
    needs_utility = True

    def __call__(self, k, demanding, budget, n_tenants: int, utility=None):
        free = _free_pool(k, budget)
        demand = _demand(k, demanding, budget)
        if utility is None:
            u = torch.ones(demand.shape, dtype=torch.float32,
                           device=demand.device)
        else:
            u = utility.to(torch.float32)
        # normalize by the max bid among demanders; an all-zero market
        # (cold start) degrades to uniform weights == proportional
        umax = torch.where(demand > 0, u, 0.0).amax(-1, keepdim=True)
        u = torch.where(umax > 0, u / torch.clamp(umax, min=1e-30),
                        torch.ones_like(u))
        w = demand.to(torch.float32) * u
        total = _seq_sum(w)
        share = torch.where(
            total > 0,
            torch.floor(free.to(torch.float32) * w
                        / torch.clamp(total, min=1e-30)),
            0.0)
        grant = torch.minimum(demand, share.to(torch.int32))
        return (k + grant).to(torch.int32)


ARBITERS = {
    "static": StaticArbiter,
    "greedy": GreedyArbiter,
    "proportional": ProportionalArbiter,
    "auction": AuctionArbiter,
}


def make_arbiter(spec) -> Arbiter:
    """Build an arbiter from a spec string (registry name plus optional
    constructor kwargs, coerced like ``make_policy``); instances pass
    through.

    >>> make_arbiter("proportional")
    ProportionalArbiter()
    >>> make_arbiter("nope")
    Traceback (most recent call last):
        ...
    ValueError: unknown arbiter 'nope'; known: ['auction', 'greedy', 'proportional', 'static']
    """
    if isinstance(spec, Arbiter):
        return spec
    name, argstr = parse_spec(spec)
    if name not in ARBITERS:
        raise ValueError(
            f"unknown arbiter {name!r}; known: {sorted(ARBITERS)}")
    cls = ARBITERS[name]
    return cls(**build_kwargs("arbiter", name, cls.__init__, argstr))
