"""Policy interface + shared batched primitives (port of ``core/policy.py``).

A cache is a rank-ordered ``int32`` row (index 0 = top of the cache);
:data:`EMPTY` (-1) marks unused ranks.  Rows are **lane-padded** to
``W = lane_pad(K)`` exactly as in the reference, so port and reference
states compare element by element and the reference's padding invariants
hold unchanged:

  * ranks ``>= k`` (the active length) are ``EMPTY`` after every step;
  * ``find``/``promote``/``rank_step`` give the same answer on the padded
    and the tight row (``t <= src`` keeps rank 0 out of the shifted range,
    and a wipe only clears already-``EMPTY`` padding ranks).

Every state tensor carries a leading lane axis ``[B, ...]``: the
reference's ``vmap`` is written out, so one ``step`` advances ``B``
independent caches, each with its own control scalars.

``rank_step`` is the one entry point of the three rank policies (Climb,
AdaptiveClimb, DynamicAdaptiveClimb).  Its control law is a :class:`Plan`:
the torch ``law`` (the plain version, run for CPU tensors) plus the plan id
and launch arguments the CUDA kernel's ``switch`` evaluates for CUDA
tensors (``repro_torch/kernels/csrc/policy_step.cu``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

EMPTY = -1

# rank rows are padded to a multiple of LANE, as in the reference, so that
# states keep the reference's shapes
LANE = 128

# plan ids of the kernel's switch (kernels/csrc/policy_step.cu)
PLAN_CLIMB = 0
PLAN_ADAPTIVECLIMB = 1
PLAN_DAC = 2
PLAN_DAC_BUDGETED = 3


def lane_pad(n: int) -> int:
    """Padded rank-row width for logical capacity ``n``: the smallest
    multiple of :data:`LANE` that holds ``n`` (at least one full lane).

    >>> lane_pad(1), lane_pad(128), lane_pad(129), lane_pad(1000)
    (128, 128, 256, 1024)
    """
    if n < 0:
        raise ValueError(f"capacity must be non-negative, got {n}")
    return max(LANE, -(-int(n) // LANE) * LANE)


def padded_row(n: int, lanes: int = 1, device="cuda") -> torch.Tensor:
    """Fresh all-``EMPTY`` rank rows ``[lanes, lane_pad(n)]``.

    >>> row = padded_row(5, device="cpu")
    >>> tuple(row.shape), int(row[0, 0])
    ((1, 128), -1)
    """
    return torch.full((lanes, lane_pad(n)), EMPTY, dtype=torch.int32,
                      device=device)


def lane_scalar(value: int, lanes: int, device) -> torch.Tensor:
    """One int32 control scalar per lane, ``[lanes]``."""
    return torch.full((lanes,), int(value), dtype=torch.int32, device=device)


class Request(NamedTuple):
    """One request per lane (or a ``[B, T]`` block): object key + size +
    miss cost, as int32 / int32 / float32 tensors of one shape."""

    key: torch.Tensor
    size: torch.Tensor
    cost: torch.Tensor

    @classmethod
    def of(cls, keys, sizes=None, costs=None, *, device="cuda") -> "Request":
        """Build a ``Request`` on ``device`` from keys, broadcasting
        ``sizes``/``costs`` (scalars or per-key arrays; default 1 / 1.0).

        >>> r = Request.of([3, 1, 3], sizes=4096, device="cpu")
        >>> tuple(r.key.shape), int(r.size[0]), float(r.cost[0])
        ((3,), 4096, 1.0)
        """
        if isinstance(keys, Request):
            if sizes is not None or costs is not None:
                raise ValueError("pass sizes/costs inside the Request")
            return cls(*(x.to(device) for x in keys))
        key = torch.as_tensor(np.asarray(keys) if not torch.is_tensor(keys)
                              else keys, device=device).to(torch.int32)
        # sizes are int32 on the device; reject values that would wrap (an
        # object >= 2 GiB corrupts every byte-miss metric)
        if sizes is not None:
            host = (sizes.cpu().numpy() if torch.is_tensor(sizes)
                    else np.asarray(sizes))
            smax = np.max(host) if host.size else 0
            if smax > np.iinfo(np.int32).max:
                raise ValueError(
                    f"sizes exceed int32 range (max {smax}); rescale to "
                    "coarser units (KiB/pages) before building Requests")
            sizes = host.astype(np.int32)
        size = torch.as_tensor(1 if sizes is None else sizes,
                               dtype=torch.int32, device=device)
        if costs is not None and not torch.is_tensor(costs):
            costs = np.asarray(costs, dtype=np.float32)
        cost = torch.as_tensor(1.0 if costs is None else costs,
                               dtype=torch.float32, device=device)
        return cls(key=key, size=size.expand(key.shape).contiguous(),
                   cost=cost.expand(key.shape).contiguous())


class StepInfo(NamedTuple):
    """Per-request policy output (stacked along time by the engine)."""

    hit: torch.Tensor           # bool
    evicted_key: torch.Tensor   # int32; EMPTY when nothing left residency
    bytes_missed: torch.Tensor  # int32; == request size on miss, else 0
    penalty: torch.Tensor       # float32; == request cost on miss, else 0


def step_info(hit, req: Request, evicted_key=None) -> StepInfo:
    """Assemble a ``StepInfo``: evictions only happen on misses, and a miss
    charges the request's full size and cost.

    >>> req = Request.of([7], sizes=100, device="cpu")
    >>> info = step_info(torch.tensor([False]), req)
    >>> int(info.bytes_missed[0]), float(info.penalty[0])
    (100, 1.0)
    """
    hit = torch.as_tensor(hit, dtype=torch.bool, device=req.key.device)
    if evicted_key is None:
        evicted_key = torch.full_like(req.key, EMPTY)
    return StepInfo(
        hit=hit,
        evicted_key=torch.where(hit, EMPTY, evicted_key.to(torch.int32)),
        bytes_missed=torch.where(hit, 0, req.size).to(torch.int32),
        penalty=torch.where(hit, 0.0, req.cost).to(torch.float32),
    )


class Policy:
    """Base class for all replacement policies; subclasses implement
    ``init(K, lanes, device) -> state`` and
    ``step(state, req) -> (state, StepInfo)`` over ``[B]`` lanes.
    Instances are hashable and comparable by their constructor fields.

    >>> from repro_torch.core import make_policy
    >>> make_policy("lru") == make_policy("lru")
    True
    >>> make_policy("dac(eps=0.25)") == make_policy("dac")
    False
    """

    name: str = "base"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        raise NotImplementedError

    def step(self, state: dict, req: Request):
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


class Plan(NamedTuple):
    """A rank policy's O(1) control law in its two forms.

    ``law(hit, i, scalars) -> (src, t, wipe_from, new_scalars)`` is the
    torch version over ``[B]`` tensors (the plain version); ``pid``,
    ``eps`` and ``k_min`` select and parameterise the same law in the CUDA
    kernel's ``switch``.
    """

    pid: int
    law: Callable
    eps: float = 0.0
    k_min: int = 0


class RankPolicy(Policy):
    """A policy whose whole step is one :func:`rank_step` over the state's
    ``cache`` row and the int32 control scalars named in ``SCALARS``
    (in the plan's order).  Subclasses provide :meth:`plan`."""

    SCALARS: tuple = ()

    def plan(self) -> Plan:
        raise NotImplementedError

    def _rank_step(self, state, req: Request, plan: Plan, names):
        cache, new_sc, hit, evicted = rank_step(
            state["cache"], req.key, tuple(state[n] for n in names), plan)
        new_state = dict(state, cache=cache)
        new_state.update(zip(names, new_sc))
        return new_state, step_info(hit, req, evicted_key=evicted)

    def step(self, state, req: Request):
        return self._rank_step(state, req, self.plan(), self.SCALARS)


# ---------------------------------------------------------------------------
# shared batched primitives (last axis = ranks, leading axes = lanes)
# ---------------------------------------------------------------------------

def find(cache: torch.Tensor, key: torch.Tensor):
    """Return ``(found, rank)`` of ``key`` in each rank-ordered row of
    ``cache``; ``rank`` is 0 where the key is absent (like ``argmax``).
    The whole row is scanned, padding included, as in the reference: the
    key ``EMPTY`` "hits" the first empty rank.

    >>> hit, i = find(torch.tensor([[5, 3, 9]]), torch.tensor([3]))
    >>> bool(hit[0]), int(i[0])
    (True, 1)
    """
    eq = cache == key.unsqueeze(-1)
    return eq.any(-1), eq.to(torch.uint8).argmax(-1).to(torch.int32)


def _ranks(cache):
    return torch.arange(cache.shape[-1], dtype=torch.int32,
                        device=cache.device)


def promote(cache, i, t, key):
    """Move ``key`` (at rank ``i``) to rank ``t`` (``t <= i``), shifting
    ranks ``[t, i-1]`` down one; with ``i`` the eviction rank this is the
    miss insertion (the old occupant of rank ``i`` leaves the row).

    >>> promote(torch.tensor([[5, 3, 9]]), torch.tensor([2]),
    ...         torch.tensor([0]), torch.tensor([9])).tolist()
    [[9, 5, 3]]
    """
    r = _ranks(cache)
    i, t, key = (x.unsqueeze(-1) for x in (i, t, key))
    rolled = torch.roll(cache, 1, dims=-1)    # rolled[r] = cache[r-1]
    return torch.where(r == t, key.to(cache.dtype),
                       torch.where((r > t) & (r <= i), rolled, cache))


def demote(cache, i, t, key):
    """Move ``key`` from rank ``i`` down to rank ``t`` (``t >= i``); ranks
    ``[i+1, t]`` shift up one.

    >>> demote(torch.tensor([[5, 3, 9]]), torch.tensor([0]),
    ...        torch.tensor([2]), torch.tensor([5])).tolist()
    [[3, 9, 5]]
    """
    r = _ranks(cache)
    i, t, key = (x.unsqueeze(-1) for x in (i, t, key))
    rolled = torch.roll(cache, -1, dims=-1)   # rolled[r] = cache[r+1]
    return torch.where(r == t, key.to(cache.dtype),
                       torch.where((r >= i) & (r < t), rolled, cache))


def rank_step(cache, key, scalars: tuple, plan: Plan):
    """One fused step of a rank-array policy over ``[B]`` lanes.

    ``cache [B, K]`` int32 rows, ``key [B]``, ``scalars`` a tuple of
    ``[B]`` int32 control scalars.  The plan picks, from the find result,
    the shift source rank ``src`` (the eviction rank on a miss), the
    insertion rank ``t`` (``t <= src``), a wipe boundary ``wipe_from``
    (ranks ``>= wipe_from`` become ``EMPTY``) and the new scalars.

    Returns ``(new_cache, new_scalars, hit, evicted)``; ``evicted`` is the
    pre-update occupant of rank ``src``.  On CPU tensors this runs the
    plain torch version (the reference's jnp branch); on CUDA tensors it
    launches the hand-written kernel
    (:func:`repro_torch.kernels.policy_step.policy_step_batched`).

    >>> def law(hit, i, scalars):
    ...     src = torch.where(hit, i, 2)
    ...     t = torch.where(hit, (i - 1).clamp(min=0), 2)
    ...     return src, t, torch.full_like(i, 3), scalars
    >>> plan = Plan(PLAN_CLIMB, law)
    >>> new, _, hit, ev = rank_step(torch.tensor([[5, 3, 9]], dtype=torch.int32),
    ...                             torch.tensor([7]), (), plan)
    >>> new.tolist(), bool(hit[0]), int(ev[0])
    ([[5, 3, 7]], False, 9)
    """
    from ..kernels.policy_step import policy_step_batched
    return policy_step_batched(cache, key, scalars, plan)
