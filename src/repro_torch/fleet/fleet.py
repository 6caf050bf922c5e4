"""Dynamic multi-tenant fleet: tenant lifecycle + auction arbitration in
one step loop (port of ``fleet/fleet.py``, on one device).

:class:`FleetTier` keeps the tier's fixed-shape discipline (``n_lanes``
lane slots allocated up front) and moves the lifecycle inside the loop
through an ``alive`` mask driven by the trace itself: the ``fleet(...)``
trace family marks an idle lane with key ``-1``.  Per step, in order:

1. **departures**: lanes whose key flipped to ``-1`` zero their active
   size, cap and controller scalars (their slots fall back into the pool);
2. **admission**: lanes whose key flipped from ``-1`` get ``k_min`` plus
   whatever headroom toward ``k0`` the pool covers (cumulative-sum grants),
   with ``k_min`` reserved for every idle lane;
3. **policy step**: every lane advances one ``step_budgeted`` (dead lanes
   run on neutral inputs, key 0 and ``k`` floored at ``k_min``, and their
   outputs are discarded); on CUDA that is one launch of kernel B1 over
   all lanes;
4. **telemetry**: per-lane Metrics, the byte-miss-cost EWMA (``utility``)
   and the penalty histogram;
5. **arbitration**: the arbiter prices the next step's caps from ``(k,
   demanding, budget, utility)``.

``sum(k) + k_min * n_idle <= budget`` holds at every step.  On CUDA the
time loop is the engine's CUDA graph loop
(``core/simulator.py::_replay_graphed``).  The reference's sharded replay
(``mesh=``) is ROADMAP A13 and not ported: ``mesh=`` raises.

>>> from repro_torch.data.traces import fleet_trace
>>> keys = fleet_trace(N=64, T=600, n_lanes=4, rate=0.05,
...                    mean_session=150, seed=0)
>>> fl = FleetTier("dac(k_min=4)", n_lanes=4, budget=64, arbiter="auction")
>>> res = replay_fleet(fl, keys, observe=True, device="cpu")
>>> bool(res.obs["k"].sum(-1).max() <= 64)                   # conservation
True
>>> tuple(res.metrics.hits.shape)                            # per-lane
(4,)
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core import make_policy
from ..core.dynamicadaptiveclimb import DynamicAdaptiveClimb
from ..core.policy import EMPTY, Request, lane_pad
from ..core.simulator import Metrics, _host, run_steps
from ..tier.arbiter import make_arbiter
from ..tier.tier import _Aggregates, _first, _lanes_in, _zero_acc, time_mean
from . import telemetry

__all__ = ["FleetTier", "FleetResult", "replay_fleet"]


class _FleetFields(NamedTuple):
    metrics: Metrics
    avg_k: Any
    alive_frac: Any
    hist: Any
    obs: Any


class FleetResult(_FleetFields, _Aggregates):
    """Per-lane fleet replay totals plus the SLO telemetry.

    ``metrics`` leaves carry a trailing lane axis (``[N]``, or ``[S, N]``);
    idle steps count nothing (``requests`` is each lane's *served* request
    count).  ``avg_k`` is the time-mean active size over all T steps (0
    while idle), ``alive_frac`` the fraction of steps the lane hosted a
    tenant, ``hist`` the ``[..., N, BINS]`` penalty histogram, and ``obs``
    is ``{"k": [T, N], "alive": [T, N]}`` under ``observe=True``.
    """

    __slots__ = ()

    def penalty_quantile(self, q: float):
        """Per-lane penalty quantile (bucket upper edge), ``[..., N]``."""
        return telemetry.penalty_quantile(self.hist, q)

    def agg_penalty_quantile(self, q: float):
        """Fleet-wide penalty quantile over all served requests."""
        return telemetry.penalty_quantile(
            np.asarray(_host(self.hist), np.float64).sum(axis=-2),
            q)

    @property
    def jain(self):
        """Jain fairness of mean-occupancy-while-alive across the lanes
        that ever hosted a tenant."""
        af = np.asarray(_host(self.alive_frac), np.float64)
        k = np.asarray(_host(self.avg_k), np.float64)
        occ = np.divide(k, af, out=np.zeros_like(k), where=af > 0)
        return telemetry.jain_index(occ, mask=af > 0)


class FleetTier:
    """Description of one fleet: policy x n_lanes x budget x arbiter,
    hashable.

    ``n_lanes`` bounds the concurrent tenants; ``budget`` is the global
    slot pool.  Resizable fleets (DAC) require ``budget >= n_lanes *
    k_min``.  ``k0`` is the admission target; ``util_decay`` sets the
    byte-miss-cost EWMA the auction arbiter prices by.  Non-resizing
    policies pair with the static arbiter only.

    >>> FleetTier("dac(k_min=4)", n_lanes=8, budget=128, arbiter="auction")
    FleetTier(dynamicadaptiveclimb, n_lanes=8, budget=128, arbiter=auction, k0=4, util_decay=0.98)
    """

    def __init__(self, policy="dac", n_lanes: int = 8, budget: int = 256,
                 arbiter="auction", k0: int | None = None,
                 util_decay: float = 0.98):
        self.policy = make_policy(policy)
        self.arbiter = make_arbiter(arbiter)
        self.n_lanes = int(n_lanes)
        self.budget = int(budget)
        self.util_decay = float(util_decay)
        self.resizable = isinstance(self.policy, DynamicAdaptiveClimb)
        if self.n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        if self.budget // self.n_lanes < 1:
            raise ValueError(
                f"budget {self.budget} too small for {self.n_lanes} lanes")
        if not self.resizable and self.arbiter.name != "static":
            raise ValueError(
                f"policy {self.policy.name!r} emits no resize signals; only "
                "arbiter('static') is meaningful for it")
        if self.resizable and self.share < self.policy.k_min:
            raise ValueError(
                f"budget {self.budget} cannot float {self.n_lanes} lanes at "
                f"the k_min={self.policy.k_min} floor — admission reserves "
                "k_min per lane so a full fleet never over-commits")
        if k0 is None:
            k0 = (max(self.policy.k_min, self.share // self.policy.growth)
                  if self.resizable else self.share)
        self.k0 = int(k0)
        if self.resizable and not (self.policy.k_min <= self.k0
                                   <= self.budget):
            raise ValueError(
                f"k0 must lie in [k_min={self.policy.k_min}, "
                f"budget={self.budget}], got {self.k0}")

    @property
    def share(self) -> int:
        """The static per-lane partition, ``budget // n_lanes``."""
        return self.budget // self.n_lanes

    @property
    def k_min(self) -> int:
        """Per-lane floor the admission path reserves (0 when the policy
        has no resize floor)."""
        return self.policy.k_min if self.resizable else 0

    # -- state --------------------------------------------------------------
    def init(self, fleets: int = 1, device="cuda") -> dict:
        """Fresh state of ``fleets`` fleets: the policy state ``p`` on
        ``fleets * n_lanes`` lanes (fleet-major), ``alive`` and ``util`` on
        ``[fleets, n_lanes]``.  All lanes start idle: ``k = cap = 0``,
        caches EMPTY, no utility."""
        n = self.n_lanes
        lanes = fleets * n
        if self.resizable:
            def full(v):
                return torch.full((lanes,), v, dtype=torch.int32,
                                  device=device)

            p = {
                "cache": torch.full((lanes, lane_pad(self.budget)), EMPTY,
                                    dtype=torch.int32, device=device),
                "jump": full(0), "jump2": full(0), "k": full(0),
                "kmax": full(self.budget), "cap": full(0),
            }
        else:
            p = self.policy.init(self.share, lanes=lanes, device=device)
        return {"p": p,
                "alive": torch.zeros((fleets, n), dtype=torch.bool,
                                     device=device),
                "util": torch.zeros((fleets, n), dtype=torch.float32,
                                    device=device)}

    def _fields(self):
        return (self.policy, self.arbiter, self.n_lanes, self.budget,
                self.k0, self.util_decay)

    def __hash__(self):
        return hash((type(self).__name__, self._fields()))

    def __eq__(self, other):
        return type(self) is type(other) and self._fields() == other._fields()

    def __repr__(self):
        return (f"FleetTier({self.policy.name}, n_lanes={self.n_lanes}, "
                f"budget={self.budget}, arbiter={self.arbiter.name}, "
                f"k0={self.k0}, util_decay={self.util_decay})")


def _tree_where(mask, a, b):
    """Leaf-wise ``where`` over nested dicts of ``[lanes, ...]`` tensors,
    the ``[lanes]`` mask broadcast over trailing dims."""
    if isinstance(a, dict):
        return {k: _tree_where(mask, a[k], b[k]) for k in a}
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _count(mask):
    return mask.sum(-1, keepdim=True)


def _fleet_step(tier: FleetTier, st: dict, req: Request, fresh=None):
    """One fleet step (lifecycle + policy + arbitration) for ``[S, N]``
    requests.  ``fresh`` is a non-resizable policy's initial state on all
    lanes (an arrival resets its lane to it).  Returns ``(st, (hit,
    bytes_missed, penalty, k, alive))``, every output ``[S, N]`` and
    masked to live lanes."""
    S, n = req.key.shape
    p, alive_prev, util = st["p"], st["alive"], st["util"]
    alive = req.key >= 0
    arrive = alive & ~alive_prev
    depart = alive_prev & ~alive
    flat_alive = alive.reshape(-1)
    safe_req = Request(key=torch.where(alive, req.key, 0).reshape(-1),
                       size=req.size.reshape(-1), cost=req.cost.reshape(-1))
    budget = tier.budget

    def view(x):
        return x.view(S, n)

    if tier.resizable:
        k_min = tier.policy.k_min
        # 1. departures: zero the lane's claim; its slots are free by not
        #    being counted
        k = torch.where(depart, 0, view(p["k"]))
        cap = torch.where(depart, 0, view(p["cap"]))
        util = torch.where(depart | arrive, 0.0, util)

        # 2. admission: k_min guaranteed (reserved for every idle lane),
        #    plus pool headroom toward k0, granted in lane order
        if tier.arbiter.pooled:
            outstanding = _count(torch.where(
                alive_prev & alive, torch.clamp(cap - k, min=0), 0))
            reserve = k_min * (_count(~alive) + _count(arrive))
            pool = torch.clamp(
                budget - _count(k) - reserve - outstanding, min=0)
            want = torch.where(arrive, tier.k0 - k_min, 0)
            before = torch.cumsum(want, -1) - want
            k_admit = (k_min + torch.minimum(
                torch.clamp(pool - before, min=0), want)).to(torch.int32)
        else:
            k_admit = torch.full_like(k, min(tier.k0, tier.share))
        cache = torch.where(arrive.reshape(-1, 1), EMPTY, p["cache"])
        jump = torch.where(arrive, k_admit,
                           torch.where(depart, 0, view(p["jump"])))
        jump2 = torch.where(arrive | depart, 0, view(p["jump2"]))
        k = torch.where(arrive, k_admit, k)
        cap = torch.where(arrive, k_admit, cap)

        # 3. step every lane; dead lanes run on neutral inputs (key 0, k
        #    floored at k_min) and their outputs are discarded
        safe = {"cache": cache, "jump": jump.reshape(-1),
                "jump2": jump2.reshape(-1),
                "k": torch.clamp(k, min=k_min).reshape(-1),
                "kmax": p["kmax"], "cap": cap.reshape(-1)}
        new_p, info = tier.policy.step_budgeted(safe, safe_req)
        cache = torch.where(flat_alive.unsqueeze(-1), new_p["cache"], cache)
        jump = torch.where(alive, view(new_p["jump"]), jump)
        jump2 = torch.where(alive, view(new_p["jump2"]), jump2)
        k = torch.where(alive, view(new_p["k"]), k)
    else:
        # non-resizable: every lane owns the static share; an arrival
        # resets the lane to a fresh policy state
        pstate = _tree_where(arrive.reshape(-1), fresh, p)
        util = torch.where(depart | arrive, 0.0, util)
        new_p, info = tier.policy.step(pstate, safe_req)
        p = _tree_where(flat_alive, new_p, pstate)
        k = torch.where(alive, tier.share, 0).to(torch.int32)

    # 4. telemetry: masked step outputs + the byte-miss-cost EWMA the
    #    auction arbiter prices capacity by (two products and a sum, each
    #    rounded, as the reference computes them)
    hit = view(info.hit) & alive
    bm = torch.where(alive, view(info.bytes_missed).to(torch.float32), 0.0)
    pen = torch.where(alive, view(info.penalty), 0.0)
    d = float(np.float32(tier.util_decay))
    util = torch.where(alive, util * d + pen * float(np.float32(1.0) - d),
                       util)

    # 5. next step's capacity caps
    if tier.resizable:
        demanding = (jump >= 2 * k) & alive
        if tier.arbiter.pooled:
            # idle lanes keep their k_min admission reserve out of the
            # arbitrated pool
            budget_eff = budget - k_min * _count(~alive)
            caps = tier.arbiter(k, demanding, budget_eff, n, utility=util)
        else:
            caps = tier.arbiter(k, demanding, budget, n)
        cap = torch.where(alive, caps, 0).to(torch.int32)
        p = {"cache": cache, "jump": jump.reshape(-1),
             "jump2": jump2.reshape(-1), "k": k.reshape(-1),
             "kmax": p["kmax"], "cap": cap.reshape(-1)}

    st = {"p": p, "alive": alive, "util": util}
    return st, (hit, bm, pen, k, alive)


def _acc_fleet(acc: Metrics, req: Request, hit, bm, pen, alive) -> Metrics:
    """Like the engine's ``_acc_step``, but idle lanes count nothing:
    ``requests`` advances only where a tenant served a request."""
    af = alive.to(torch.float32)
    return Metrics(
        requests=acc.requests + alive,
        hits=acc.hits + hit,
        bytes_total=acc.bytes_total + req.size.to(torch.float32) * af,
        bytes_missed=acc.bytes_missed + bm,
        cost_total=acc.cost_total + req.cost * af,
        penalty=acc.penalty + pen,
    )


def _scan_fleet(tier: FleetTier, reqs: Request, observe: bool,
                chunk) -> FleetResult:
    """Metrics-in-carry replay of ``[S, T, N]`` fleet streams."""
    S, T, n = reqs.key.shape
    dev = reqs.key.device
    fresh = (None if tier.resizable else
             tier.policy.init(tier.share, lanes=S * n, device=dev))

    def run(block, carry, sinks, at):
        st, acc, ksum, asum, hist = carry
        for s in range(block.key.shape[1]):
            req = Request(*(x[:, s] for x in block))
            st, (hit, bm, pen, k, alive) = _fleet_step(tier, st, req, fresh)
            acc = _acc_fleet(acc, req, hit, bm, pen, alive)
            bucket = telemetry.penalty_bucket(pen).long().unsqueeze(-1)
            hist = hist.scatter_add(-1, bucket,
                                    alive.to(torch.int32).unsqueeze(-1))
            ksum = ksum + k.to(torch.float32)
            asum = asum + alive.to(torch.float32)
            if sinks is not None:
                sinks["k"][:, at + s] = k
                sinks["alive"][:, at + s] = alive
        return st, acc, ksum, asum, hist

    zf = torch.zeros((S, n), dtype=torch.float32, device=dev)
    carry = (tier.init(S, dev), _zero_acc((S, n), dev), zf, zf,
             torch.zeros((S, n, telemetry.BINS), dtype=torch.int32,
                         device=dev))
    sinks = None
    if observe:
        sinks = {"k": torch.empty((S, T, n), dtype=torch.int32, device=dev),
                 "alive": torch.empty((S, T, n), dtype=torch.bool,
                                      device=dev)}
    _, acc, ksum, asum, hist = run_steps(run, reqs, carry, sinks, chunk)
    return FleetResult(metrics=acc, avg_k=time_mean(ksum, T),
                       alive_frac=time_mean(asum, T), hist=hist, obs=sinks)


def replay_fleet(tier: FleetTier, requests, *, sizes=None, costs=None,
                 observe: bool = False, mesh=None, device="cuda",
                 chunk: int | None = None) -> FleetResult:
    """Replay a dynamic-fleet request stream through ``tier`` on
    ``device``.

    ``requests``: a :class:`~repro_torch.core.Request` (or bare keys, with
    ``sizes``/``costs`` broadcast per ``Request.of``) of shape ``[T, N]``
    (key ``-1`` marks a lane with no tenant that step) or ``[S, T, N]``
    for S independent fleets.  Sizes and costs at idle positions are
    ignored.  ``chunk`` sets the steps per CUDA graph on CUDA (default
    ``GRAPH_CHUNK``; 0 runs the eager loop).  ``mesh=`` (the reference's
    lane sharding with a ``psum`` budget re-deal) is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "replay_fleet(mesh=...): the sharded fleet is not ported yet "
            "(ROADMAP A13: multi-GPU)")
    reqs, single = _lanes_in(requests, sizes, costs, device, tier.n_lanes,
                             "n_lanes")
    res = _scan_fleet(tier, reqs, observe, chunk)
    return _first(res) if single else res
