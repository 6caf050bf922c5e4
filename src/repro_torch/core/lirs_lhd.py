"""LIRS and LHD (port of ``core/lirs_lhd.py``), plain torch over the lane
axis ``[B, ...]`` with the reference's state layout.

LIRS (Jiang & Zhang 2002) in the reference's timestamp formulation: per
tracked key a last-access time and a state (LIR, resident HIR, ghost HIR,
bounded at ``ghost_factor * K`` ghosts); "in the stack" is ``t_last >=``
the oldest LIR's ``t_last``.  LHD (Beckmann et al. 2018), binned-age and
unsampled: hit density per power-of-2 age bin, ``hits_b / ((hits_b +
evs_b + 1) * 2^b)`` in float32, counters halved every ``4K`` requests,
eviction of the resident slot of least density (empty slots first).

As in ``core/baselines.py`` every step is branch-free and every tie the
first minimum.
"""
from __future__ import annotations

import torch

from .baselines import (INF32, _argmin, _find, _first_true, _get, _sel,
                        _set, _slots)
from .policy import EMPTY, Policy, Request, lane_scalar, step_info

__all__ = ["LIRS", "LHD"]

# LIRS states
FREE, LIR, HIR, GHOST = 0, 1, 2, 3


class LIRS(Policy):
    """LIRS (Jiang & Zhang 2002): inter-reference recency beats recency —
    LIR blocks own most of the cache, HIR blocks pass through a small
    residency window, ghosts remember evicted HIRs.

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("lirs", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    3
    """

    name = "lirs"

    def __init__(self, hir_frac: float = 0.01, ghost_factor: int = 2):
        self.hir_frac = float(hir_frac)
        self.ghost_factor = int(ghost_factor)

    def _sizes(self, K):
        k_hir = max(1, int(K * self.hir_frac))
        return K - k_hir, k_hir, self.ghost_factor * K

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        _, _, G = self._sizes(K)
        M = K + G
        return {"keys": _slots(lanes, M, device),
                "t_last": _slots(lanes, M, device, fill=-1),
                "state": _slots(lanes, M, device, fill=FREE),
                "t": lane_scalar(0, lanes, device)}

    def step(self, state, req: Request):
        key = req.key
        keys, t_last, st = state["keys"], state["t_last"], state["state"]
        t = state["t"] + 1
        K = keys.shape[-1] // (1 + self.ghost_factor)
        k_lir, _, G = self._sizes(K)

        tracked, idx_found = _find(keys, key)
        cur_state = torch.where(tracked, _get(st, idx_found), FREE)
        hit = tracked & ((cur_state == LIR) | (cur_state == HIR))

        is_lir = st == LIR
        n_lir = is_lir.sum(-1, dtype=torch.int32)
        lir_bottom = _argmin_where(is_lir, t_last)
        min_lir_t = torch.where(n_lir > 0, _get(t_last, lir_bottom), -1)
        in_stack = tracked & (_get(t_last, idx_found) >= min_lir_t)

        hir_lru = _argmin_where(st == HIR, t_last)
        has_hir = (st == HIR).any(-1)

        # case 1: LIR hit, refresh recency
        t_hit = _set(t_last, idx_found, t)
        s1 = (keys, t_hit, st)

        # case 2: resident-HIR hit; in the stack it becomes LIR and the LIR
        # bottom a resident HIR, out of it it stays HIR
        st2a = _set(_set(st, idx_found, LIR), lir_bottom, HIR)
        promote = in_stack & (n_lir > 0)
        s2 = (keys, t_hit, _sel(promote, st2a, st))

        # case 3: a miss
        n_res = (is_lir | (st == HIR)).sum(-1, dtype=torch.int32)
        full = n_res >= K
        # the residency eviction: the HIR demoted to a ghost (or, with no
        # HIR, the LIR bottom dropped)
        evicted = torch.where(
            full, torch.where(has_hir, _get(keys, hir_lru),
                              _get(keys, lir_bottom)), EMPTY)
        st3 = _sel(full, _sel(has_hir, _set(st, hir_lru, GHOST),
                              _set(st, lir_bottom, FREE)), st)
        keys3 = _sel(full & ~has_hir, _set(keys, lir_bottom, EMPTY), keys)
        # bound the ghost table: drop its LRU if over capacity
        ghost_lru3 = _argmin_where(st3 == GHOST, t_last)
        drop = (st3 == GHOST).sum(-1, dtype=torch.int32) > G
        keys3 = _sel(drop, _set(keys3, ghost_lru3, EMPTY), keys3)
        st3 = _sel(drop, _set(st3, ghost_lru3, FREE), st3)
        t3 = _sel(drop, _set(t_last, ghost_lru3, -1), t_last)

        # insertion slot: the key's ghost slot, else the first free one;
        # while LIR is underfull new blocks become LIR, a ghost in the
        # stack is promoted to LIR and demotes the LIR bottom
        was_ghost = tracked & (cur_state == GHOST)
        ins = torch.where(was_ghost, idx_found,
                          _first_true(st3 == FREE)[1])
        ghost_promote = was_ghost & in_stack & (n_lir >= k_lir)
        new_state = torch.where((n_lir < k_lir) | ghost_promote,
                                torch.full_like(key, LIR), HIR)
        keys3 = _set(keys3, ins, key)
        st3 = _set(st3, ins, new_state)
        st3 = _sel(ghost_promote, _set(st3, lir_bottom, HIR), st3)
        t3 = _set(t3, ins, t)
        s3 = (keys3, t3, st3)

        is_lir_hit = hit & (cur_state == LIR)
        out = [_sel(is_lir_hit, a, _sel(hit, b, c))
               for a, b, c in zip(s1, s2, s3)]
        return {"keys": out[0], "t_last": out[1], "state": out[2],
                "t": t}, step_info(hit, req, evicted_key=evicted)


def _argmin_where(mask, ts):
    """The slot of least timestamp among ``mask`` (0 if none)."""
    return _argmin(torch.where(mask, ts, INF32))


class LHD(Policy):
    """LHD (Beckmann et al. 2018): evict the slot with the lowest hit
    density for its age bin (binned-age approximation, unsampled).

    >>> from repro_torch.core import Engine
    >>> int(Engine(device="cpu").replay("lhd", [0, 1, 0, 2, 0, 1, 2, 0],
    ...     K=2, collect_info=False).metrics.hits)
    2
    """

    name = "lhd"

    def __init__(self, n_bins: int = 16, decay_every_factor: int = 4):
        self.n_bins = int(n_bins)
        self.decay_every_factor = int(decay_every_factor)

    def init(self, K: int, lanes: int = 1, device="cuda") -> dict:
        return {"keys": _slots(lanes, K, device),
                "t_ins": _slots(lanes, K, device, fill=-1),
                "hits": _slots(lanes, self.n_bins, device, fill=0),
                "evs": _slots(lanes, self.n_bins, device, fill=0),
                "t": lane_scalar(0, lanes, device)}

    def _powers(self, like):
        """``2^j`` for ``j`` in ``[1, n_bins)``, the bins' lower edges."""
        return torch.bitwise_left_shift(
            torch.ones(self.n_bins - 1, dtype=like.dtype, device=like.device),
            torch.arange(1, self.n_bins, dtype=like.dtype,
                         device=like.device))

    def _bin(self, age, powers):
        """Integer ``floor(log2(age + 1))``, capped at the last bin: the
        count of ``j`` in ``[1, n_bins)`` with ``age + 1 >= 2^j``, as the
        reference counts it, in one ``bucketize`` over those powers."""
        a = torch.clamp(age, min=0) + 1
        b = torch.bucketize(a, powers, right=True).to(torch.int32)
        return torch.clamp(b, 0, self.n_bins - 1)

    def _hd(self, hits, evs):
        b = torch.arange(self.n_bins, dtype=torch.float32,
                         device=hits.device)
        num = hits.to(torch.float32)
        den = (hits + evs + 1).to(torch.float32) * torch.exp2(b)
        return num / den

    def step(self, state, req: Request):
        keys, t_ins = state["keys"], state["t_ins"]
        hits_c, evs_c = state["hits"], state["evs"]
        t = state["t"] + 1
        K = keys.shape[-1]
        hit, i = _find(keys, req.key)
        powers = self._powers(t_ins)
        bin_i = self._bin(t - _get(t_ins, i), powers)

        # a hit records its reuse age and refreshes the slot
        hits_h = _set(hits_c, bin_i, _get(hits_c, bin_i) + 1)
        t_ins_h = _set(t_ins, i, t)

        # a miss evicts the least hit density (empties first) and records
        # the eviction age
        hd = self._hd(hits_c, evs_c)
        slot_hd = hd.gather(-1, self._bin(t.unsqueeze(-1) - t_ins,
                                          powers).long())
        slot_hd = torch.where(keys == EMPTY, -1.0, slot_hd)
        v = _argmin(slot_hd)
        victim_occupied = _get(keys, v) != EMPTY
        bin_v = self._bin(t - _get(t_ins, v), powers)
        evs_m = _sel(victim_occupied,
                     _set(evs_c, bin_v, _get(evs_c, bin_v) + 1), evs_c)
        evicted = torch.where(victim_occupied, _get(keys, v), EMPTY)

        keys = _sel(hit, keys, _set(keys, v, req.key))
        t_ins = _sel(hit, t_ins_h, _set(t_ins, v, t))
        hits_c = _sel(hit, hits_h, hits_c)
        evs_c = _sel(hit, evs_c, evs_m)

        # periodic integer-halving decay
        decay = (t % (self.decay_every_factor * K)) == 0
        hits_c = _sel(decay, hits_c // 2, hits_c)
        evs_c = _sel(decay, evs_c // 2, evs_c)
        return {"keys": keys, "t_ins": t_ins, "hits": hits_c, "evs": evs_c,
                "t": t}, step_info(hit, req, evicted_key=evicted)
