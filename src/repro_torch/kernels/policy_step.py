"""Fused rank-policy step: the CUDA kernel's wrappers and their plain
PyTorch versions.

Replaces the TPU kernel ``src/repro/kernels/policy_step.py``
(``fused_policy_step`` :269, launched by ``_batched_call`` through
``pl.pallas_call`` at :247).  The kernel is hand-written CUDA C++ for
``sm_90a`` in ``csrc/policy_step.cu``, built by :mod:`._build` and called
through ``ctypes``.  Its one entry point serves two wrappers:

* :func:`policy_replay` — ``T`` steps over a ``[B, T]`` request block with
  the time loop inside the kernel, one launch per replay; the engine's
  replacement for ``lax.scan``;
* :func:`policy_step_batched` — one step on ``B`` lanes, the body of
  :func:`repro_torch.core.policy.rank_step` on CUDA tensors: a replay of
  one request.

On CPU tensors each wrapper runs its plain version (:func:`step_plain`,
:func:`replay_plain`), which mirrors the reference's jnp branch
(``core/policy.py:326-332``) and is the kernel's oracle on the card.  On a
CUDA tensor a wrapper launches the kernel or raises.

Bound on an H100: integer compares and moves.  The replay writes three
counts per lane (``work``): ranks scanned (``m + 1`` on a hit, all ``W``
on a miss), moved (``src - t``) and wiped (``W - wipe_from``).  The
kernel's find stops at the live width (``n``, or DAC's ``k``), past which
every rank is ``EMPTY``, so on a miss it scans fewer ranks than the count
says, and it skips wipes of ranks that are ``EMPTY`` already;
``chip_smoke.py`` reckons a run's bound from the ranks its data needs, on
that live width.  Each step's phases depend on each other, so at the main path's
widths a step is latency bound.  The kernel's size dispatch
(:func:`replay_path`) runs narrow rows one warp per lane with no block
barrier, the top 128 ranks in registers, and wider rows one block per
lane, the row in shared memory up to 200 KiB and in device memory past it.
The source's header gives the design.

``LAUNCHES`` counts launches of the kernel: :func:`policy_replay` adds one
where it launches, and nowhere else.  Inside a CUDA graph capture (the
engine's graph loop, ``core/simulator.py``) the launch is recorded once
and replayed with the graph, so it counts once, at capture.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.policy import EMPTY, Plan, find, lane_pad, promote
from . import _build

__all__ = ["policy_step_batched", "policy_replay", "replay_path",
           "step_plain", "replay_plain", "ReplayOut", "LAUNCHES"]

LAUNCHES = 0
# the kernel's paths, by the code policy_replay_path returns
PATHS = ("warp", "block, row in shared memory", "block, row in device memory")

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("policy_step")
    lib.policy_replay.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  ctypes.c_float, _I, _P, _P, _P, _P, _P, _P,
                                  _P]
    lib.policy_replay.restype = _I
    lib.policy_replay_path.argtypes = [_I, _I]
    lib.policy_replay_path.restype = _I
    return lib


class ReplayOut(NamedTuple):
    """What a replay of ``T`` steps on ``B`` lanes returns."""

    cache: torch.Tensor           # [B, K] int32 rows after the last step
    scalars: torch.Tensor         # [B, n] int32 control scalars
    hit: torch.Tensor | None      # [B, T] bool, when collect_info
    evicted: torch.Tensor | None  # [B, T] int32 (EMPTY on hits)
    obs: torch.Tensor | None      # [B, T, n] scalars after each step
    counts: torch.Tensor          # [B, 2] int64: requests, hits
    sums: torch.Tensor            # [B, 4] float32: bytes_total,
    #                               bytes_missed, cost_total, penalty
    work: torch.Tensor            # [B, 3] int64: ranks scanned, moved, wiped


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _step(cache, key, scalars, plan: Plan):
    hit, i = find(cache, key)
    src, t, wipe_from, new_sc = plan.law(hit, i, tuple(scalars))
    evicted = cache.gather(-1, src.long().unsqueeze(-1)).squeeze(-1)
    new = promote(cache, src, t, key)
    r = torch.arange(cache.shape[-1], dtype=torch.int32, device=cache.device)
    new = torch.where(r >= wipe_from.unsqueeze(-1), EMPTY, new)
    return new, tuple(new_sc), hit, evicted, (i, src, t, wipe_from)


def step_plain(cache, key, scalars, plan: Plan):
    """Plain torch version of one step: ``(new_cache, new_scalars, hit,
    evicted)``, ``evicted`` being the pre-update occupant of rank ``src``."""
    return _step(cache, key, scalars, plan)[:4]


def replay_plain(cache, scalars, keys, sizes, costs, plan: Plan, *,
                 collect_info: bool, observe: bool) -> ReplayOut:
    """Plain torch version of :func:`policy_replay`: a Python loop of
    :func:`step_plain`, with the totals summed in float32 in the
    reference's order (``simulator.py::_acc_step``)."""
    B, T = keys.shape
    W = cache.shape[-1]
    sc = tuple(scalars.unbind(-1))
    zf = torch.zeros(B, dtype=torch.float32, device=cache.device)
    zi = torch.zeros(B, dtype=torch.int64, device=cache.device)
    hits, bt, bm, ct, pen = zi, zf, zf, zf, zf
    scanned, moved, wiped = zi, zi, zi
    hit_l, ev_l, obs_l = [], [], []
    for s in range(T):
        size, cost = sizes[:, s], costs[:, s]
        cache, sc, hit, ev, (i, src, t, wipe) = _step(cache, keys[:, s], sc,
                                                      plan)
        hits = hits + hit.to(torch.int64)
        bt = bt + size.to(torch.float32)
        bm = bm + torch.where(hit, 0, size).to(torch.float32)
        ct = ct + cost
        pen = pen + torch.where(hit, 0.0, cost)
        scanned = scanned + torch.where(hit, i.to(torch.int64) + 1, W)
        moved = moved + (src - t).to(torch.int64)
        wiped = wiped + (W - wipe.clamp(0, W)).to(torch.int64)
        if collect_info:
            hit_l.append(hit)
            ev_l.append(torch.where(hit, EMPTY, ev))
        if observe:
            obs_l.append(torch.stack(sc, -1))
    stack = (lambda xs, shape, dt: torch.stack(xs, 1) if xs else
             torch.empty(shape, dtype=dt, device=cache.device))
    n = scalars.shape[-1]
    return ReplayOut(
        cache=cache,
        scalars=torch.stack(sc, -1) if n else scalars.clone(),
        hit=stack(hit_l, (B, 0), torch.bool) if collect_info else None,
        evicted=stack(ev_l, (B, 0), torch.int32) if collect_info else None,
        obs=stack(obs_l, (B, 0, n), torch.int32) if observe else None,
        counts=torch.stack([torch.full_like(hits, T), hits], -1),
        sums=torch.stack([bt, bm, ct, pen], -1),
        work=torch.stack([scanned, moved, wiped], -1),
    )


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(x):
    return ctypes.c_void_p(x.data_ptr()) if x is not None else None


def _check_cuda(cache, *tensors):
    if cache.dim() != 2 or cache.dtype != torch.int32:
        raise ValueError(
            f"cache must be int32 [B, W], got {cache.dtype} "
            f"{tuple(cache.shape)}")
    for x in tensors:
        if x.device != cache.device:
            raise ValueError(
                f"all tensors must be on {cache.device}, got {x.device}")


def _pad(cache):
    K = cache.shape[-1]
    W = lane_pad(K)
    if W == K:
        return cache.contiguous().clone()
    pad = torch.full((cache.shape[0], W - K), EMPTY, dtype=torch.int32,
                     device=cache.device)
    return torch.cat([cache, pad], -1)


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def policy_step_batched(cache, key, scalars, plan: Plan):
    """One rank-policy step on ``B`` lanes: ``cache [B, K]`` int32, ``key
    [B]``, ``scalars`` a tuple of ``[B]`` int32.  Returns ``(new_cache,
    new_scalars, hit, evicted)``, ``evicted`` being the pre-update occupant
    of rank ``src``.

    On the card this is :func:`policy_replay` of one request.  On a hit
    ``src`` is the find's rank, whose occupant is the key itself, so
    ``evicted`` is the key there and the replay's evicted key elsewhere."""
    if cache.device.type == "cpu":
        return step_plain(cache, key, scalars, plan)
    B = cache.shape[0]
    sc = (torch.stack([s.to(torch.int32) for s in scalars], -1)
          if scalars else torch.empty((B, 0), dtype=torch.int32,
                                      device=cache.device))
    keys = key.to(torch.int32).reshape(B, 1)
    zeros = torch.zeros((B, 1), dtype=torch.int32, device=cache.device)
    return step_from_replay(policy_replay(cache, sc, keys, zeros,
                                          zeros.float(), plan,
                                          collect_info=True), keys)


def step_from_replay(out: ReplayOut, keys):
    """A replay of one request (``keys [B, 1]``, ``collect_info``) as a
    step's ``(new_cache, new_scalars, hit, evicted)``: the replay's evicted
    key is EMPTY on a hit, where the occupant of rank ``src`` is the key."""
    hit = out.hit[:, 0]
    evicted = torch.where(hit, keys[:, 0], out.evicted[:, 0])
    return out.cache, tuple(out.scalars.unbind(-1)), hit, evicted


def replay_path(W: int, plan: Plan) -> str:
    """Which of the kernel's paths (:data:`PATHS`) a replay of rows of
    ``W`` ranks (a multiple of 128) takes under ``plan``: the size
    dispatch of ``csrc/policy_step.cu``, asked of the built library."""
    code = _lib().policy_replay_path(W, plan.pid)
    if code < 0:
        raise ValueError(f"no path for W={W}, plan id {plan.pid}")
    return PATHS[code]


def policy_replay(cache, scalars, keys, sizes, costs, plan: Plan, *,
                  collect_info: bool = True,
                  observe: bool = False) -> ReplayOut:
    """``T`` rank-policy steps on ``B`` lanes in one launch.

    ``cache [B, K]`` int32 rows, ``scalars [B, n]`` int32, ``keys`` /
    ``sizes`` / ``costs`` ``[B, T]`` (int32, int32, float32).  Per-step
    hit bits and evicted keys come back under ``collect_info``, the
    scalars after each step under ``observe``; per-lane totals always."""
    global LAUNCHES
    if cache.device.type == "cpu":
        return replay_plain(cache, scalars, keys, sizes, costs, plan,
                            collect_info=collect_info, observe=observe)
    if cache.device.type != "cuda":
        raise ValueError(f"no kernel for device {cache.device}")
    _check_cuda(cache, scalars, keys, sizes, costs)
    B, K = cache.shape
    T = keys.shape[-1]
    if keys.shape != (B, T) or sizes.shape != (B, T) or \
            costs.shape != (B, T) or scalars.shape[0] != B:
        raise ValueError(
            f"shape mismatch: cache {tuple(cache.shape)}, scalars "
            f"{tuple(scalars.shape)}, keys {tuple(keys.shape)}")
    row = _pad(cache)
    n = scalars.shape[-1]
    sc = scalars.to(torch.int32).contiguous().clone()
    keys = keys.to(torch.int32).contiguous()
    sizes = sizes.to(torch.int32).contiguous()
    costs = costs.to(torch.float32).contiguous()
    dev = cache.device

    def empty(shape, dt, want=True):
        return torch.empty(shape, dtype=dt, device=dev) if want else None

    hit = empty((B, T), torch.bool, collect_info)
    ev = empty((B, T), torch.int32, collect_info)
    obs = empty((B, T, n), torch.int32, observe)
    counts = empty((B, 2), torch.int64)
    sums = empty((B, 4), torch.float32)
    work = empty((B, 3), torch.int64)
    status = _lib().policy_replay(
        _ptr(row), _ptr(sc), _ptr(keys), _ptr(sizes), _ptr(costs), B,
        row.shape[1], T, n, plan.pid, float(np.float32(plan.eps)),
        plan.k_min, _ptr(hit), _ptr(ev), _ptr(obs), _ptr(counts),
        _ptr(sums), _ptr(work), _stream(dev))
    _build.check(status, "policy_replay")
    LAUNCHES += 1
    return ReplayOut(cache=row[:, :K], scalars=sc, hit=hit, evicted=ev,
                     obs=obs, counts=counts, sums=sums, work=work)
