"""Baseline policies of the port (from ``core/baselines.py``): Climb, the
classic rank policy, and the slot policies FIFO (the MRR baseline), LRU,
BLRU, LFU, Clock, Sieve, TwoQ, ARC, TinyLFU and Hyperbolic.

The slot policies are plain torch over the lane axis ``[B, ...]``, as the
reference has no kernel for them either.  Each step is branch-free, as the
reference's is: no Python ``if`` on a tensor, no ``.item()``, no shape that
depends on the data, so that a chunk of steps can be captured in one CUDA
graph (``core/simulator.py``).  Every tie breaks toward the first minimum
(``torch.argmin``, as ``jnp.argmin``).  Per-slot state matches the
reference's layout (key names, shapes, int32 dtypes); LRU's and BLRU's
timestamps are int64 (the reference widens them to int64 only under x64,
and torch has no such switch).
"""
from __future__ import annotations

import torch

from .policy import (EMPTY, PLAN_CLIMB, Plan, Policy, RankPolicy, Request,
                     lane_scalar, padded_row, step_info)

__all__ = ["Climb", "FIFO", "LRU", "BLRU", "LFU", "Clock", "Sieve", "TwoQ",
           "ARC", "TinyLFU", "Hyperbolic"]

INF32 = 2**31 - 1


# ---------------------------------------------------------------------------
# batched forms of the reference's ``x[i]``, ``x.at[i].set(v)`` and
# ``jnp.where(c, a, b)``: ``x`` is ``[B, n]``, ``i``/``v``/``c`` are ``[B]``.
# On the card a step's time is its kernel count (each a graph node), so
# slot indices stay int64 as the reductions return them.

def _ix(i):
    return i.long().unsqueeze(-1)


def _get(x, i):
    return x.gather(-1, _ix(i)).squeeze(-1)


def _set(x, i, v):
    if torch.is_tensor(v):
        return x.scatter(-1, _ix(i), v.to(x.dtype).unsqueeze(-1))
    return x.scatter(-1, _ix(i), v)


def _add(x, i, v):
    return _set(x, i, _get(x, i) + v)


def _sel(c, a, b):
    """``jnp.where`` of a per-lane condition over ``[B, ...]`` values."""
    if a.dim() > c.dim():
        c = c.view(c.shape + (1,) * (a.dim() - c.dim()))
    return torch.where(c, a, b)


def _argmin(x):
    return x.argmin(-1)


def _first_true(mask):
    """``(any, first index where mask holds, else 0)``, as ``jnp.any`` and
    ``jnp.argmax``.  On the card one ``max`` (values and first maximal
    index) gives both; on the CPU ``max`` with indices opens a thread pool
    for any size, which costs far more than two plain reductions when
    several processes share the cores."""
    if mask.is_cuda:
        return mask.max(-1)
    return mask.any(-1), mask.to(torch.uint8).argmax(-1)


def _find(keys, key):
    """``(found, slot)`` of ``key`` in each lane's slots (slot 0 when
    absent), as the reference's ``find``."""
    return _first_true(keys == key.unsqueeze(-1))


def _first_empty(keys):
    """Index of the first EMPTY slot, else 0 (caller checks has_empty)."""
    return _first_true(keys == EMPTY)


def _min(x):
    return x.amin(-1)


def _slots(lanes, K, device, fill=EMPTY):
    return torch.full((lanes, K), fill, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------

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
        return {"keys": _slots(lanes, K, device),
                "head": lane_scalar(0, lanes, device)}

    def step(self, state, req: Request):
        keys, head = state["keys"], state["head"]
        hit = (keys == req.key.unsqueeze(-1)).any(-1)
        at = head.long()
        return {
            "keys": _sel(hit, keys, _set(keys, at, req.key)),
            "head": torch.where(hit, head, (head + 1) % keys.shape[-1]),
        }, step_info(hit, req, evicted_key=_get(keys, at))


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
            "keys": _slots(lanes, K, device),
            "last": torch.full((lanes, K), -1, dtype=torch.int64,
                               device=device),
            "t": torch.zeros(lanes, dtype=torch.int64, device=device),
        }

    def step(self, state, req: Request):
        keys, last, t = state["keys"], state["last"], state["t"]
        hit, i = _find(keys, req.key)
        v = _argmin(last)                     # empties (-1) evicted first
        slot = torch.where(hit, i, v)
        return {"keys": _set(keys, slot, req.key),
                "last": _set(last, slot, t), "t": t + 1}, \
            step_info(hit, req, evicted_key=_get(keys, v))


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


class BLRU(Policy):
    """LRU with buffered (lazy) promotion: a hit refreshes recency only
    if the entry's recorded recency is older than ``K // lag_div``
    requests (Yang et al.'s B-LRU churn reduction).

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("blru", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    2
    """

    name = "blru"

    def __init__(self, lag_div: int = 8):
        self.lag_div = int(lag_div)

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return LRU().init(K, lanes, device)

    def step(self, state, req: Request):
        keys, last, t = state["keys"], state["last"], state["t"]
        lag = max(1, keys.shape[-1] // self.lag_div)
        hit, i = _find(keys, req.key)
        v = _argmin(last)
        # on a miss i = 0, and last[0] is read all the same (as the
        # reference does); the miss updates regardless
        do_update = (~hit) | (t - _get(last, i) > lag)
        slot = torch.where(hit, i, v)
        evicted = _get(keys, v)
        keys = _set(keys, slot, req.key)
        last = _sel(do_update, _set(last, slot, t), last)
        return {"keys": keys, "last": last, "t": t + 1}, \
            step_info(hit, req, evicted_key=evicted)


class LFU(Policy):
    """Least-frequently-used over in-cache counts (history lost on
    eviction); ties break toward the lowest slot index.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("lfu", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    3
    """

    name = "lfu"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"keys": _slots(lanes, K, device),
                "cnt": _slots(lanes, K, device, fill=0)}

    def step(self, state, req: Request):
        keys, cnt = state["keys"], state["cnt"]
        hit, i = _find(keys, req.key)
        v = _argmin(cnt)            # empties (cnt = 0) evicted first
        slot = torch.where(hit, i, v)
        evicted = _get(keys, v)
        keys = _set(keys, slot, req.key)
        cnt = _sel(hit, _add(cnt, slot, 1), _set(cnt, slot, 1))
        return {"keys": keys, "cnt": cnt}, \
            step_info(hit, req, evicted_key=evicted)


class Clock(Policy):
    """Second-chance CLOCK: the hand sweeps past referenced slots,
    clearing their bits, and evicts the first unreferenced one.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("clock", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    2
    """

    name = "clock"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"keys": _slots(lanes, K, device),
                "ref": torch.zeros((lanes, K), dtype=torch.bool,
                                   device=device),
                "hand": lane_scalar(0, lanes, device)}

    def step(self, state, req: Request):
        keys, ref, hand = state["keys"], state["ref"], state["hand"]
        K = keys.shape[-1]
        hit, i = _find(keys, req.key)
        # victim: the first slot at or after the hand with its bit clear
        # (or empty); all referenced: a full sweep clears, victim = hand
        idx = torch.arange(K, dtype=torch.int32, device=keys.device)
        offset = (idx - hand.unsqueeze(-1)) % K
        evictable = (~ref) | (keys == EMPTY)
        vo = _min(torch.where(evictable, offset, K))
        none = vo == K
        victim = torch.where(none, hand, (hand + vo) % K)
        passed = offset < torch.where(none, K, vo).unsqueeze(-1)
        ref_m = _set(ref & ~passed, victim, False)
        keys_m = _set(keys, victim, req.key)
        return {
            "keys": _sel(hit, keys, keys_m),
            "ref": _sel(hit, _set(ref, i, True), ref_m),
            "hand": torch.where(hit, hand, (victim + 1) % K),
        }, step_info(hit, req, evicted_key=_get(keys, victim))


class Sieve(Policy):
    """SIEVE (Yang et al. 2023): FIFO order, visited bits, hand sweeps
    from tail (oldest) toward head clearing visited bits; survivors do
    not move.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("sieve", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    3
    """

    name = "sieve"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"keys": _slots(lanes, K, device),
                "vis": torch.zeros((lanes, K), dtype=torch.bool,
                                   device=device),
                "seq": _slots(lanes, K, device, fill=0),
                "hand_seq": lane_scalar(0, lanes, device),
                "ctr": lane_scalar(0, lanes, device)}

    def step(self, state, req: Request):
        keys, vis, seq = state["keys"], state["vis"], state["seq"]
        hand_seq, ctr = state["hand_seq"], state["ctr"]
        hit, i = _find(keys, req.key)
        has_empty, e = _first_empty(keys)

        # the eviction scan in closed form (cache full)
        unv = ~vis
        ge = seq >= hand_seq.unsqueeze(-1)
        c1 = unv & ge
        c2 = unv & ~ge
        v1 = _min(torch.where(c1, seq, INF32))
        v2 = _min(torch.where(c2, seq, INF32))
        # all visited: a full sweep, evict the start
        v3 = torch.where(ge.any(-1), _min(torch.where(ge, seq, INF32)),
                         _min(seq))
        case1 = c1.any(-1)
        case2 = (~case1) & c2.any(-1)
        victim_seq = torch.where(case1, v1, torch.where(case2, v2, v3))
        cleared = _sel(
            case1, vis & ge & (seq < v1.unsqueeze(-1)),
            _sel(case2, (vis & ge) | (vis & ~ge & (seq < v2.unsqueeze(-1))),
                 torch.ones_like(vis)))
        victim = _first_true(seq == victim_seq.unsqueeze(-1))[1]

        slot = torch.where(has_empty, e, victim)
        keys_m = _set(keys, slot, req.key)
        vis_m = _set(_sel(has_empty, vis, vis & ~cleared), slot, False)
        seq_m = _set(seq, slot, ctr)
        hand_m = torch.where(has_empty, hand_seq, victim_seq + 1)
        return {
            "keys": _sel(hit, keys, keys_m),
            "vis": _sel(hit, _set(vis, i, True), vis_m),
            "seq": _sel(hit, seq, seq_m),
            "hand_seq": torch.where(hit, hand_seq, hand_m),
            "ctr": torch.where(hit, ctr, ctr + 1),
        }, step_info(hit, req, evicted_key=torch.where(
            has_empty, EMPTY, _get(keys, victim)))


class TwoQ(Policy):
    """Full 2Q: A1in FIFO (``K/4``), A1out ghost keys (``K/2``), Am LRU
    (the rest); a ghost hit promotes straight into Am.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("twoq", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    2
    """

    name = "twoq"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        kin = max(1, K // 4)
        kout = max(1, K // 2)
        km = max(1, K - kin)
        return {
            "in_keys": _slots(lanes, kin, device),
            "in_seq": _slots(lanes, kin, device, fill=-1),
            "out_keys": _slots(lanes, kout, device),
            "out_seq": _slots(lanes, kout, device, fill=-1),
            "am_keys": _slots(lanes, km, device),
            "am_last": _slots(lanes, km, device, fill=-1),
            "t": lane_scalar(0, lanes, device),
        }

    def step(self, state, req: Request):
        key, s = req.key, state
        t = s["t"]
        in_am, i_am = _find(s["am_keys"], key)
        in_a1, _ = _find(s["in_keys"], key)
        in_out, i_out = _find(s["out_keys"], key)
        hit = in_am | in_a1

        # hit in Am: refresh recency
        am_last_h = _set(s["am_last"], i_am, t)

        # miss reclaimed from A1out: drop the ghost, insert into Am (evict
        # its LRU)
        out_keys_r = _set(s["out_keys"], i_out, EMPTY)
        out_seq_r = _set(s["out_seq"], i_out, -1)
        am_slot = _argmin(s["am_last"])
        am_evicted = _get(s["am_keys"], am_slot)     # EMPTY while Am has room
        am_keys_r = _set(s["am_keys"], am_slot, key)
        am_last_r = _set(s["am_last"], am_slot, t)

        # cold miss: insert into A1in; its displaced LRU becomes a ghost
        in_has_empty, in_e = _first_empty(s["in_keys"])
        in_slot = torch.where(in_has_empty, in_e, _argmin(s["in_seq"]))
        displaced = _get(s["in_keys"], in_slot)     # EMPTY if there was room
        in_keys_c = _set(s["in_keys"], in_slot, key)
        in_seq_c = _set(s["in_seq"], in_slot, t)
        out_has_empty, out_e = _first_empty(s["out_keys"])
        out_slot = torch.where(out_has_empty, out_e, _argmin(s["out_seq"]))
        push_ghost = displaced != EMPTY
        out_keys_c = _sel(push_ghost,
                          _set(s["out_keys"], out_slot, displaced),
                          s["out_keys"])
        out_seq_c = _sel(push_ghost, _set(s["out_seq"], out_slot, t),
                         s["out_seq"])

        reclaim = (~hit) & in_out
        cold = (~hit) & (~in_out)
        # residency = A1in + Am; a displaced A1in entry becomes a ghost, so
        # it leaves residency and counts as evicted
        evicted = torch.where(reclaim, am_evicted,
                              torch.where(cold, displaced, EMPTY))
        return {
            "in_keys": _sel(cold, in_keys_c, s["in_keys"]),
            "in_seq": _sel(cold, in_seq_c, s["in_seq"]),
            "out_keys": _sel(reclaim, out_keys_r,
                             _sel(cold, out_keys_c, s["out_keys"])),
            "out_seq": _sel(reclaim, out_seq_r,
                            _sel(cold, out_seq_c, s["out_seq"])),
            "am_keys": _sel(reclaim, am_keys_r, s["am_keys"]),
            "am_last": _sel(in_am, am_last_h,
                            _sel(reclaim, am_last_r, s["am_last"])),
            "t": t + 1,
        }, step_info(hit, req, evicted_key=evicted)


class ARC(Policy):
    """Adaptive Replacement Cache (Megiddo & Modha 2003, Fig. 4): T1/T2
    with B1/B2 ghost lists and the adaptive target ``p``.

    The reference evaluates each of Fig. 4's cases on a copy of the whole
    state and selects one per lane.  Here the same law is written per list:
    in every case each of T1, T2, B1 and B2 loses at most one entry (a hit,
    a ghost hit or an LRU entry) and then gains at most one (the key, or
    the key REPLACE demotes), so a step is one drop and one put per list,
    in the reference's order, with the same slots chosen.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("arc", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    3
    """

    name = "arc"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        out = {}
        for lst in ("t1", "t2", "b1", "b2"):
            out[lst + "k"] = _slots(lanes, K, device)
            out[lst + "t"] = _slots(lanes, K, device, fill=-1)
        out["p"] = lane_scalar(0, lanes, device)
        out["t"] = lane_scalar(0, lanes, device)
        return out

    @staticmethod
    def _lru(keys, ts):
        """(size, slot of the least recent entry) of each lane's list."""
        empty = keys == EMPTY
        return ((~empty).sum(-1, dtype=torch.int32),
                _argmin(torch.where(empty, INF32, ts)))

    @staticmethod
    def _drop(keys, ts, mask, i):
        """Empty slot ``i`` where ``mask`` holds."""
        return (_sel(mask, _set(keys, i, EMPTY), keys),
                _sel(mask, _set(ts, i, -1), ts))

    @staticmethod
    def _put(keys, ts, mask, key, t):
        """Insert ``key`` at MRU where ``mask`` holds: into the first empty
        slot, else over the LRU entry (the reference's ``_ins_mru``)."""
        empty = keys == EMPTY
        has_empty, e = _first_true(empty)
        slot = torch.where(has_empty, e, _argmin(torch.where(empty, INF32,
                                                             ts)))
        return (_sel(mask, _set(keys, slot, key), keys),
                _sel(mask, _set(ts, slot, t), ts))

    def step(self, state, req: Request):
        key, s = req.key, state
        t, p = s["t"], s["p"]
        K = s["t1k"].shape[-1]
        in_t1, i_t1 = _find(s["t1k"], key)
        in_t2, i_t2 = _find(s["t2k"], key)
        in_b1, i_b1 = _find(s["b1k"], key)
        in_b2, i_b2 = _find(s["b2k"], key)
        n_t1, lru_t1 = self._lru(s["t1k"], s["t1t"])
        n_t2, lru_t2 = self._lru(s["t2k"], s["t2t"])
        n_b1, lru_b1 = self._lru(s["b1k"], s["b1t"])
        n_b2, lru_b2 = self._lru(s["b2k"], s["b2t"])

        # the case: I hit in T1 or T2, II ghost hit in B1, III in B2, IV
        # a true miss (A: L1 == K, with A1 |T1| < K and A2 |T1| == K; B:
        # L1 < K and |T1| + |T2| + |B1| + |B2| >= K)
        hit = in_t1 | in_t2
        ghost1 = in_b1 & ~hit
        ghost2 = in_b2 & ~hit & ~in_b1
        miss = ~(hit | in_b1 | in_b2)
        L1 = n_t1 + n_b1
        total = L1 + n_t2 + n_b2
        condA = miss & (L1 == K)
        A1 = condA & (n_t1 < K)
        A2 = condA & (n_t1 >= K)
        condB = miss & (L1 < K) & (total >= K)

        delta1 = torch.clamp(n_b2 // torch.clamp(n_b1, min=1), min=1)
        delta2 = torch.clamp(n_b1 // torch.clamp(n_b2, min=1), min=1)
        p = torch.where(ghost1, torch.clamp(p + delta1, max=K),
                        torch.where(ghost2, torch.clamp(p - delta2, min=0),
                                    p))

        # REPLACE (cases II, III, IV-A1, IV-B) on T1 and T2 as they stand
        # (no case that replaces touches them first), with the new p
        replace = ghost1 | ghost2 | A1 | condB
        use_t1 = (n_t1 >= 1) & ((ghost2 & (n_t1 == p)) | (n_t1 > p))
        use_t1 = torch.where(n_t2 == 0, True, use_t1)
        use_t1 = torch.where(n_t1 == 0, False, use_t1)
        mov1 = torch.where(n_t1 > 0, _get(s["t1k"], lru_t1), EMPTY)
        mov2 = torch.where(n_t2 > 0, _get(s["t2k"], lru_t2), EMPTY)
        dem1 = replace & use_t1         # T1's LRU moves to B1
        dem2 = replace & ~use_t1        # T2's LRU moves to B2

        hit1, hit2 = hit & in_t1, hit & in_t2
        t1k, t1t = self._drop(s["t1k"], s["t1t"], hit1 | A2 | dem1,
                              torch.where(hit1, i_t1, lru_t1))
        t2k, t2t = self._drop(s["t2k"], s["t2t"], hit2 | (dem2 & (n_t2 > 0)),
                              torch.where(hit2, i_t2, lru_t2))
        b1k, b1t = self._drop(s["b1k"], s["b1t"], ghost1 | (A1 & (n_b1 > 0)),
                              torch.where(ghost1, i_b1, lru_b1))
        b2k, b2t = self._drop(
            s["b2k"], s["b2t"],
            ghost2 | (condB & (total == 2 * K) & (n_b2 > 0)),
            torch.where(ghost2, i_b2, lru_b2))
        b1k, b1t = self._put(b1k, b1t, dem1 & (mov1 != EMPTY), mov1, t)
        b2k, b2t = self._put(b2k, b2t, dem2 & (mov2 != EMPTY), mov2, t)
        t2k, t2t = self._put(t2k, t2t, ~miss, key, t)
        t1k, t1t = self._put(t1k, t1t, miss, key, t)

        evicted = torch.where(replace, torch.where(use_t1, mov1, mov2),
                              torch.where(A2, mov1, EMPTY))
        return {"t1k": t1k, "t1t": t1t, "t2k": t2k, "t2t": t2t,
                "b1k": b1k, "b1t": b1t, "b2k": b2k, "b2t": b2t,
                "p": p, "t": t + 1}, step_info(hit, req, evicted_key=evicted)


# multiply-shift constants of TinyLFU's hash rows (the reference's uint32s)
_HASH_A = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_U32 = 0xFFFFFFFF


def sketch_columns(key, rows: int, W: int):
    """``[B]`` keys -> ``[B, rows]`` count-min columns: the reference's
    uint32 multiply-shift (TinyLFU's, and the admission layer's), in int64
    held to 32 bits after the add and the multiply (so EMPTY, 0xFFFFFFFF
    as uint32, hashes as 0).  Every product stays below 2^63: the operand
    is at most 2^31 after the add, each constant below 2^32."""
    x = (key.to(torch.int64) + 1) & _U32
    # the constants enter as scalars: a tensor built from them here would
    # be a host-to-device copy inside the step
    x = torch.stack([(x * a) & _U32 for a in _HASH_A[:rows]], -1)
    x = x ^ (x >> 15)
    return x & (W - 1)


class TinyLFU(Policy):
    """LRU eviction + count-min-sketch admission filter with periodic
    halving (window ``window_factor * K``).

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("tinylfu", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    4
    """

    name = "tinylfu"

    def __init__(self, rows: int = 4, width_factor: int = 16,
                 window_factor: int = 8):
        self.rows = int(rows)
        self.width_factor = int(width_factor)
        self.window_factor = int(window_factor)

    def _width(self, K):
        w = 1
        while w < K * self.width_factor:
            w *= 2
        return w

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {
            "keys": _slots(lanes, K, device),
            "last": _slots(lanes, K, device, fill=-1),
            "sketch": torch.zeros((lanes, self.rows, self._width(K)),
                                  dtype=torch.int32, device=device),
            "adds": lane_scalar(0, lanes, device),
            "t": lane_scalar(0, lanes, device),
        }

    def _hash(self, key, W):
        return sketch_columns(key, self.rows, W)

    @staticmethod
    def _estimate(sketch, h):
        """Count-min estimate from a key's ``[B, rows, 1]`` columns."""
        return _min(sketch.gather(-1, h).squeeze(-1))

    def step(self, state, req: Request):
        keys, last, sketch = state["keys"], state["last"], state["sketch"]
        adds, t = state["adds"], state["t"]
        K = keys.shape[-1]
        W = sketch.shape[-1]
        hit, i = _find(keys, req.key)

        # count every request in the sketch (each row's column once);
        # halve when the window expires
        h = self._hash(req.key, W).unsqueeze(-1)
        sketch = sketch.scatter(-1, h, sketch.gather(-1, h) + 1)
        adds = adds + 1
        expire = adds >= self.window_factor * K
        sketch = _sel(expire, sketch // 2, sketch)
        adds = torch.where(expire, 0, adds)

        has_empty, e = _first_empty(keys)
        v = _argmin(last)
        victim_key = _get(keys, v)
        admit = has_empty | (self._estimate(sketch, h) > self._estimate(
            sketch, self._hash(victim_key, W).unsqueeze(-1)))
        slot = torch.where(has_empty, e, v)

        keys_m = _sel(admit, _set(keys, slot, req.key), keys)
        last_m = _sel(admit, _set(last, slot, t), last)
        # a rejected candidate evicts nothing (the admission filter bounces
        # the request, the victim stays resident)
        evicted = torch.where(admit & ~has_empty, victim_key, EMPTY)
        return {
            "keys": _sel(hit, keys, keys_m),
            "last": _sel(hit, _set(last, i, t), last_m),
            "sketch": sketch, "adds": adds, "t": t + 1,
        }, step_info(hit, req, evicted_key=evicted)


class Hyperbolic(Policy):
    """Hyperbolic caching: evict the minimum frequency/age priority
    (exact, unsampled).

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("hyperbolic",
    ...     [0, 1, 0, 2, 0, 1, 2, 0], K=2, collect_info=False).metrics.hits)
    2
    """

    name = "hyperbolic"

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"keys": _slots(lanes, K, device),
                "cnt": _slots(lanes, K, device, fill=0),
                "ins": _slots(lanes, K, device, fill=0),
                "t": lane_scalar(0, lanes, device)}

    def step(self, state, req: Request):
        keys, cnt, ins, t = (state["keys"], state["cnt"], state["ins"],
                             state["t"])
        hit, i = _find(keys, req.key)
        age = (t.unsqueeze(-1) - ins + 1).to(torch.float32)
        prio = torch.where(keys == EMPTY, float("-inf"),
                           cnt.to(torch.float32) / age)
        v = _argmin(prio)
        return {
            "keys": _sel(hit, keys, _set(keys, v, req.key)),
            "cnt": _sel(hit, _add(cnt, i, 1), _set(cnt, v, 1)),
            "ins": _sel(hit, ins, _set(ins, v, t)),
            "t": t + 1,
        }, step_info(hit, req, evicted_key=_get(keys, v))
