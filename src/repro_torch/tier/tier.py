"""Shared-budget multi-tenant cache tier (port of ``tier/tier.py``).

N tenant caches, one :class:`~repro_torch.core.DynamicAdaptiveClimb` each,
share one global slot budget.  Per global step every tenant serves one
request (the ``tenants(...)`` trace family interleaves the streams along
time); the tenants step together as lanes, and then the **arbiter** sets
each tenant's capacity cap for the next step from the post-step resize
signals (:mod:`repro_torch.tier.arbiter`).

``arbiter("static")`` is hard partitioning into ``budget // n_tenants``
shares, equal to N independent ``Engine.replay`` calls.  Non-resizing
policies run hard-partitioned at ``budget // n_tenants`` under ``static``.

Layout: a ``[S, T, N]`` replay (S independent tiers, the reference's seed
``vmap`` written out) keeps its policy state on ``S * N`` lanes
(tier-major) and the arbiter's view on ``[S, N]``.  On CUDA a DAC tier's
step is one launch of kernel B1 over the ``S * N`` lanes (DAC's budgeted
plan, one request each, rows ``lane_pad(budget)`` wide) plus the
arbiter's and the totals' plain torch; the time loop is the engine's CUDA
graph loop (``core/simulator.py::_replay_graphed``).  On the CPU it is the
plain loop, B1's plain version inside.

>>> import numpy as np
>>> tier = CacheTier("dac", n_tenants=2, budget=32, arbiter="greedy")
>>> reqs = np.zeros((100, 2), np.int32)           # [T, n_tenants] keys
>>> res = replay_tier(tier, reqs, device="cpu")
>>> [int(h) for h in res.metrics.hits]            # per-tenant totals
[99, 99]
>>> float(res.agg_miss_ratio) == 2 / 200
True
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import make_policy
from ..core.dynamicadaptiveclimb import DynamicAdaptiveClimb
from ..core.policy import EMPTY, Request, lane_pad
from ..core.simulator import (Metrics, _acc_step, _host, _ratio,
                              run_steps)
from .arbiter import make_arbiter

__all__ = ["CacheTier", "TierResult", "replay_tier"]


def time_mean(total, T: int):
    """``total / T`` as the reference's compiled program computes it: XLA
    turns a division by a constant into a multiply by the float32
    reciprocal, which rounds differently from a division."""
    return total * float(np.float32(1.0 / T))


class _Aggregates:
    """Per-lane and aggregate ratios over ``metrics`` (trailing lane or
    tenant axis), shared by the tier's and the fleet's results."""

    __slots__ = ()

    @property
    def hit_ratio(self):
        return _ratio(self.metrics.hits, self.metrics.requests)

    @property
    def miss_ratio(self):
        m = self.metrics
        return _ratio(_host(m.requests) - _host(m.hits), m.requests)

    @property
    def byte_miss_ratio(self):
        return _ratio(self.metrics.bytes_missed, self.metrics.bytes_total)

    @property
    def penalty_ratio(self):
        return _ratio(self.metrics.penalty, self.metrics.cost_total)

    # -- aggregates (sum over the last axis, then the ratio) ----------------
    @staticmethod
    def _agg(num, den):
        return _ratio(np.asarray(_host(num), dtype=np.float64).sum(axis=-1),
                      np.asarray(_host(den), dtype=np.float64).sum(axis=-1))

    @property
    def agg_miss_ratio(self):
        """Request-weighted aggregate: total misses / total requests."""
        m = self.metrics
        return self._agg(_host(m.requests) - _host(m.hits), m.requests)

    @property
    def agg_byte_miss_ratio(self):
        """Byte-weighted aggregate: total bytes missed / total bytes."""
        return self._agg(self.metrics.bytes_missed, self.metrics.bytes_total)

    @property
    def agg_penalty_ratio(self):
        """Cost-weighted aggregate: total penalty / total cost."""
        return self._agg(self.metrics.penalty, self.metrics.cost_total)


class _TierFields(NamedTuple):
    metrics: Metrics
    avg_k: Any
    obs: Any


class TierResult(_TierFields, _Aggregates):
    """Per-tenant replay totals plus the tier's occupancy trace.

    ``metrics`` leaves carry a trailing tenant axis (``[N]``, or ``[S, N]``
    for a seed-batched replay); ``avg_k`` is each tenant's time-mean active
    size; ``obs`` is ``{"k": [T, N]}`` (``[S, T, N]``) under
    ``observe=True``, else ``None``.  Counts are int64.
    """

    __slots__ = ()


class CacheTier:
    """Description of one tier: policy x n_tenants x budget x arbiter,
    hashable.  ``policy`` / ``arbiter`` accept spec strings or instances;
    ``k0`` is each tenant's initial active size (default: the static share
    divided by the policy's ``growth``).

    >>> CacheTier("dac(growth=2)", n_tenants=4, budget=64, arbiter="static")
    CacheTier(dynamicadaptiveclimb, n_tenants=4, budget=64, arbiter=static, k0=8)
    """

    def __init__(self, policy="dac", n_tenants: int = 4, budget: int = 256,
                 arbiter="greedy", k0: int | None = None):
        self.policy = make_policy(policy)
        self.arbiter = make_arbiter(arbiter)
        self.n_tenants = int(n_tenants)
        self.budget = int(budget)
        self.resizable = isinstance(self.policy, DynamicAdaptiveClimb)
        if self.n_tenants < 1:
            raise ValueError("n_tenants must be >= 1")
        share = self.budget // self.n_tenants
        if share < 1:
            raise ValueError(
                f"budget {self.budget} too small for {self.n_tenants} tenants")
        if not self.resizable and self.arbiter.name != "static":
            raise ValueError(
                f"policy {self.policy.name!r} emits no resize signals; only "
                "arbiter('static') is meaningful for it")
        if self.arbiter.needs_utility:
            raise ValueError(
                f"arbiter {self.arbiter.name!r} prices capacity by the "
                "byte-miss-cost utility signal, which only the fleet "
                "replay carries — use repro_torch.fleet.FleetTier")
        # an explicit static share above the fair partition would let the
        # tenants jointly exceed the budget
        if (self.arbiter.name == "static"
                and getattr(self.arbiter, "share", 0) * self.n_tenants
                > self.budget):
            raise ValueError(
                f"static share {self.arbiter.share} x {self.n_tenants} "
                f"tenants exceeds the budget {self.budget}")
        if k0 is None:
            k0 = (max(self.policy.k_min, share // self.policy.growth)
                  if self.resizable else share)
        self.k0 = int(k0)
        if self.k0 * self.n_tenants > self.budget:
            raise ValueError(
                f"initial sizes exceed the budget: {self.n_tenants} x "
                f"{self.k0} > {self.budget}")

    @property
    def share(self) -> int:
        """The static per-tenant partition, ``budget // n_tenants``."""
        return self.budget // self.n_tenants

    # -- state --------------------------------------------------------------
    def init(self, tiers: int = 1, device="cuda") -> dict:
        """Tenant state on ``tiers * n_tenants`` lanes (tier-major).
        Resizable tenants get budget-wide rank rows (one tenant may absorb
        the whole budget) plus the arbiter's initial caps."""
        n = self.n_tenants
        lanes = tiers * n
        if not self.resizable:
            return self.policy.init(self.share, lanes=lanes, device=device)

        def full(v):
            return torch.full((lanes,), v, dtype=torch.int32, device=device)

        k0 = torch.full((tiers, n), self.k0, dtype=torch.int32,
                        device=device)
        demanding = torch.zeros((tiers, n), dtype=torch.bool, device=device)
        return {
            # the allocation bound each tenant's law sees is the logical
            # budget (kmax), not the padded row width
            "cache": torch.full((lanes, lane_pad(self.budget)), EMPTY,
                                dtype=torch.int32, device=device),
            "jump": full(self.k0),
            "jump2": full(0),
            "k": full(self.k0),
            "kmax": full(self.budget),
            "cap": self.arbiter(k0, demanding, self.budget, n).reshape(-1),
        }

    # -- one tier step -------------------------------------------------------
    def step(self, state: dict, req: Request):
        """Advance every tenant one request (``req`` leaves ``[S, N]``),
        then re-arbitrate the caps from the post-step resize signals.
        Returns ``(state, info, k)`` with ``[S, N]`` info and sizes."""
        S, n = req.key.shape
        flat = Request(*(x.reshape(-1) for x in req))
        if not self.resizable:
            state, info = self.policy.step(state, flat)
            k = torch.full((S, n), self.share, dtype=torch.int32,
                           device=req.key.device)
        else:
            state, info = self.policy.step_budgeted(state, flat)
            k = state["k"].view(S, n)
            demanding = state["jump"].view(S, n) >= 2 * k
            state = dict(state, cap=self.arbiter(
                k, demanding, self.budget, n).reshape(-1))
        info = type(info)(*(x.view(S, n) for x in info))
        return state, info, k

    # -- hashability ----------------------------------------------------------
    def _fields(self):
        return (self.policy, self.arbiter, self.n_tenants, self.budget,
                self.k0)

    def __hash__(self):
        return hash((type(self).__name__, self._fields()))

    def __eq__(self, other):
        return type(self) is type(other) and self._fields() == other._fields()

    def __repr__(self):
        return (f"CacheTier({self.policy.name}, n_tenants={self.n_tenants}, "
                f"budget={self.budget}, arbiter={self.arbiter.name}, "
                f"k0={self.k0})")


def _zero_acc(shape, device) -> Metrics:
    zi = torch.zeros(shape, dtype=torch.int64, device=device)
    zf = torch.zeros(shape, dtype=torch.float32, device=device)
    return Metrics(zi, zi, zf, zf, zf, zf)


def _scan_tier(tier: CacheTier, reqs: Request, observe: bool,
               chunk) -> TierResult:
    """Replay ``[S, T, N]`` streams metrics-only: per-tenant ``Metrics``
    and the running ``k`` sum ride in the carry, one step a column."""
    S, T, n = reqs.key.shape
    dev = reqs.key.device

    def run(block, carry, sinks, at):
        st, acc, ksum = carry
        for s in range(block.key.shape[1]):
            req = Request(*(x[:, s] for x in block))
            st, info, k = tier.step(st, req)
            acc = _acc_step(acc, req, info)
            ksum = ksum + k.to(torch.float32)
            if sinks is not None:
                sinks["k"][:, at + s] = k
        return st, acc, ksum

    carry = (tier.init(S, dev), _zero_acc((S, n), dev),
             torch.zeros((S, n), dtype=torch.float32, device=dev))
    sinks = ({"k": torch.empty((S, T, n), dtype=torch.int32, device=dev)}
             if observe else None)
    _, acc, ksum = run_steps(run, reqs, carry, sinks, chunk)
    return TierResult(metrics=acc, avg_k=time_mean(ksum, T), obs=sinks)


def _lanes_in(requests, sizes, costs, device, n: int, what: str):
    """The ``[S, T, N]`` request block of a ``[T, N]`` or ``[S, T, N]``
    input (``N == n``), and whether it was a single stream."""
    reqs = Request.of(requests, sizes, costs, device=device)
    shape = tuple(reqs.key.shape)
    if len(shape) == 2:
        if shape[1] != n:
            raise ValueError(
                f"requests [T, N] must have N == {what} ({n}), got {shape}")
        return Request(*(x.unsqueeze(0) for x in reqs)), True
    if len(shape) == 3:
        if shape[2] != n:
            raise ValueError(
                f"requests [S, T, N] must have N == {what} ({n}), got "
                f"{shape}")
        return reqs, False
    raise ValueError(
        f"requests must be [T, N] or [S, T, N], got shape {shape}")


def _first(tree):
    """Drop the leading tier axis of every tensor in a result."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_first(v) for v in tree))
    return tree[0]


def replay_tier(tier: CacheTier, requests, *, sizes=None, costs=None,
                observe: bool = False, device="cuda",
                chunk: int | None = None) -> TierResult:
    """Replay an interleaved multi-tenant request stream through ``tier``
    on ``device``.

    ``requests``: a :class:`~repro_torch.core.Request` (or bare keys, with
    ``sizes``/``costs`` broadcast per ``Request.of``) of shape ``[T, N]``
    (one request per tenant at each of the T global steps) or
    ``[S, T, N]`` for S independent streams.  Metrics are reduced per
    tenant as the replay goes, each tenant's time-mean active size comes
    back as ``avg_k``, and ``observe=True`` adds the per-step occupancy
    ``obs["k"]``.  ``chunk`` sets the steps per CUDA graph on CUDA
    (default ``GRAPH_CHUNK``; 0 runs the eager loop)."""
    reqs, single = _lanes_in(requests, sizes, costs, device,
                             tier.n_tenants, "n_tenants")
    res = _scan_tier(tier, reqs, observe, chunk)
    return _first(res) if single else res
