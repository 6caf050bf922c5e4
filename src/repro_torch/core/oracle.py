"""Literal step-by-step Python reference implementations of every policy.

These follow the paper pseudocode / original-paper formulations as directly
as possible (lists, while-loops, pointer walks) and serve as the oracle for
the vectorized JAX implementations: for any trace, the per-request hit
sequence must match exactly.  Also provides Belady's OPT for reference
curves.

Conventions shared with the JAX side (so hit sequences are comparable):
  * keys are ints >= 0; -1 is the EMPTY sentinel.
  * tie-breaks: lowest slot index / first minimum.
  * Hyperbolic priorities computed in float32 (matching the TPU arithmetic).

The oracles deliberately keep the scalar ``step(key) -> hit`` shape: they
validate replacement *decisions*, which are size/cost-oblivious for every
policy here.  ``oracle_replay`` lifts an oracle over a trace (optionally
with per-request sizes/costs) into the same (hits, bytes_missed, penalty)
aggregates the JAX engine reports, so engine metrics are checkable
end-to-end against plain Python.
"""
from __future__ import annotations

import math

import numpy as np

EMPTY = -1


def oracle_replay(name: str, trace, K: int, sizes=None, costs=None, **kw):
    """Replay `trace` through oracle `name`; returns a dict with the hit
    mask plus the engine's aggregate metrics computed in plain Python."""
    oracle = ORACLES[name](K, **kw)
    trace = np.asarray(trace)
    hits = np.array([oracle.step(int(k)) for k in trace], dtype=bool)
    sizes = np.ones(len(trace)) if sizes is None else np.asarray(sizes)
    costs = np.ones(len(trace)) if costs is None else np.asarray(costs)
    total = sizes.sum()
    return {
        "hits": hits,
        "miss_ratio": float((~hits).mean()) if len(trace) else 0.0,
        "byte_miss_ratio": (float(((~hits) * sizes).sum() / total)
                            if total > 0 else 0.0),
        "penalty": float(((~hits) * costs).sum()),
    }


class OracleAdaptiveClimb:
    """Algorithm 1, on an actual ordered list (index 0 = top)."""

    def __init__(self, K: int):
        self.K = K
        self.cache = [EMPTY] * K
        self.jump = K

    def step(self, key: int) -> bool:
        K = self.K
        if key in self.cache:
            i = self.cache.index(key)
            self.jump = max(self.jump - 1, 1)
            t = max(i - self.jump, 0)
            self.cache.pop(i)
            self.cache.insert(t, key)
            return True
        self.jump = min(self.jump + 1, K)
        self.cache.pop()  # evict bottom
        self.cache.insert(K - self.jump, key)
        return False


class OracleDynamicAdaptiveClimb:
    """Algorithm 2 with the interpretation choices documented in
    dynamicadaptiveclimb.py (resize checks after every request, <= threshold,
    clamp+reset after resize)."""

    def __init__(self, K: int, eps: float = 0.5, growth: int = 4,
                 k_min: int = 2):
        self.K_max = K * growth
        self.k = K
        self.eps = eps
        self.k_min = k_min
        self.cache = [EMPTY] * K
        self.jump = K
        self.jump2 = 0

    def step(self, key: int) -> bool:
        k = self.k
        half = k // 2
        hit = key in self.cache
        if hit:
            i = self.cache.index(key)
            if self.jump > -half:
                self.jump -= 1
            if i < half:
                if self.jump2 > -half:
                    self.jump2 -= 1
            else:
                if self.jump2 < 0:
                    self.jump2 += 1
            actual = max(1, min(self.jump, i))
            if i > 0:
                t = i - actual
                self.cache.pop(i)
                self.cache.insert(t, key)
        else:
            self.jump = min(self.jump + 1, 2 * k)
            if self.jump2 < 0:
                self.jump2 += 1
            actual = max(1, min(k - 1, self.jump))
            self.cache.pop()  # evict rank k-1
            self.cache.insert(k - actual, key)

        # resize checks
        if self.jump == 0:
            self.jump2 = 0
        half = self.k // 2
        shrink_thresh = -math.ceil(self.eps * half)
        if self.jump >= 2 * self.k and 2 * self.k <= self.K_max:
            self.cache = self.cache + [EMPTY] * self.k
            self.k = 2 * self.k
            self.jump = max(min(self.jump, 2 * self.k), -(self.k // 2))
            self.jump2 = 0
        elif (self.jump <= -half and self.jump2 <= shrink_thresh
              and half >= self.k_min):
            self.cache = self.cache[:half]
            self.k = half
            self.jump = 0  # neutral restart (see dynamicadaptiveclimb.py)
            self.jump2 = 0
        return hit


class OracleFIFO:
    def __init__(self, K: int):
        self.keys = [EMPTY] * K
        self.head = 0
        self.K = K

    def step(self, key: int) -> bool:
        if key in self.keys:
            return True
        self.keys[self.head] = key
        self.head = (self.head + 1) % self.K
        return False


class OracleLRU:
    def __init__(self, K: int):
        self.keys = [EMPTY] * K
        self.last = [-1] * K
        self.t = 0

    def step(self, key: int) -> bool:
        hit = key in self.keys
        if hit:
            i = self.keys.index(key)
        else:
            i = self.last.index(min(self.last))
            self.keys[i] = key
        self.last[i] = self.t
        self.t += 1
        return hit


class OracleBLRU:
    def __init__(self, K: int, lag_div: int = 8):
        self.keys = [EMPTY] * K
        self.last = [-1] * K
        self.t = 0
        self.lag = max(1, K // lag_div)

    def step(self, key: int) -> bool:
        hit = key in self.keys
        if hit:
            i = self.keys.index(key)
            if self.t - self.last[i] > self.lag:
                self.last[i] = self.t
        else:
            i = self.last.index(min(self.last))
            self.keys[i] = key
            self.last[i] = self.t
        self.t += 1
        return hit


class OracleClimb:
    def __init__(self, K: int):
        self.cache = [EMPTY] * K

    def step(self, key: int) -> bool:
        if key in self.cache:
            i = self.cache.index(key)
            if i > 0:
                self.cache[i], self.cache[i - 1] = \
                    self.cache[i - 1], self.cache[i]
            return True
        self.cache[-1] = key
        return False


class OracleLFU:
    def __init__(self, K: int):
        self.keys = [EMPTY] * K
        self.cnt = [0] * K

    def step(self, key: int) -> bool:
        hit = key in self.keys
        if hit:
            i = self.keys.index(key)
            self.cnt[i] += 1
        else:
            i = self.cnt.index(min(self.cnt))
            self.keys[i] = key
            self.cnt[i] = 1
        return hit


class OracleClock:
    def __init__(self, K: int):
        self.keys = [EMPTY] * K
        self.ref = [False] * K
        self.hand = 0
        self.K = K

    def step(self, key: int) -> bool:
        if key in self.keys:
            self.ref[self.keys.index(key)] = True
            return True
        for _ in range(2 * self.K + 1):
            if self.keys[self.hand] == EMPTY or not self.ref[self.hand]:
                break
            self.ref[self.hand] = False
            self.hand = (self.hand + 1) % self.K
        victim = self.hand
        self.keys[victim] = key
        self.ref[victim] = False
        self.hand = (victim + 1) % self.K
        return False


class OracleSieve:
    """SIEVE with an explicit seq-ordered walk (hand: oldest -> newest)."""

    def __init__(self, K: int):
        self.K = K
        self.entries = {}  # key -> [seq, visited]
        self.hand_seq = 0
        self.ctr = 0

    def step(self, key: int) -> bool:
        if key in self.entries:
            self.entries[key][1] = True
            return True
        if len(self.entries) == self.K:
            # walk from the oldest seq >= hand_seq toward newer, wrapping
            ordered = sorted(self.entries.items(), key=lambda kv: kv[1][0])
            seqs = [kv[1][0] for kv in ordered]
            start = 0
            while start < len(seqs) and seqs[start] < self.hand_seq:
                start += 1
            order = list(range(start, len(seqs))) + list(range(0, start))
            victim = None
            for idx in order + order:  # at most two passes
                k2, (s2, v2) = ordered[idx]
                if not self.entries[k2][1]:
                    victim = k2
                    break
                self.entries[k2][1] = False
            assert victim is not None
            victim_seq = self.entries[victim][0]
            del self.entries[victim]
            self.hand_seq = victim_seq + 1
        self.entries[key] = [self.ctr, False]
        self.ctr += 1
        return False


class OracleTwoQ:
    def __init__(self, K: int):
        self.kin = max(1, K // 4)
        self.kout = max(1, K // 2)
        self.km = max(1, K - self.kin)
        self.a1in = []   # FIFO, oldest first
        self.a1out = []  # ghost FIFO, oldest first
        self.am = []     # LRU, oldest first

    def step(self, key: int) -> bool:
        if key in self.am:
            self.am.remove(key)
            self.am.append(key)
            return True
        if key in self.a1in:
            return True
        if key in self.a1out:
            self.a1out.remove(key)
            if len(self.am) == self.km:
                self.am.pop(0)
            self.am.append(key)
            return False
        if len(self.a1in) == self.kin:
            displaced = self.a1in.pop(0)
            if len(self.a1out) == self.kout:
                self.a1out.pop(0)
            self.a1out.append(displaced)
        self.a1in.append(key)
        return False


class OracleARC:
    """Megiddo & Modha 2003 Fig. 4 with integer-valued p."""

    def __init__(self, K: int):
        self.K = K
        self.t1, self.t2, self.b1, self.b2 = [], [], [], []  # oldest first
        self.p = 0

    def _replace(self, in_b2: bool):
        if self.t1 and ((in_b2 and len(self.t1) == self.p)
                        or len(self.t1) > self.p or not self.t2):
            old = self.t1.pop(0)
            self.b1.append(old)
        elif self.t2:
            old = self.t2.pop(0)
            self.b2.append(old)

    def step(self, key: int) -> bool:
        K = self.K
        if key in self.t1:
            self.t1.remove(key)
            self.t2.append(key)
            return True
        if key in self.t2:
            self.t2.remove(key)
            self.t2.append(key)
            return True
        if key in self.b1:
            # ghost removed before REPLACE (see baselines.ARC for rationale)
            self.p = min(self.p + max(1, len(self.b2) // max(len(self.b1), 1)), K)
            self.b1.remove(key)
            self._replace(False)
            self.t2.append(key)
            return False
        if key in self.b2:
            self.p = max(self.p - max(1, len(self.b1) // max(len(self.b2), 1)), 0)
            self.b2.remove(key)
            self._replace(True)
            self.t2.append(key)
            return False
        L1 = len(self.t1) + len(self.b1)
        total = L1 + len(self.t2) + len(self.b2)
        if L1 == K:
            if len(self.t1) < K:
                self.b1.pop(0)
                self._replace(False)
            else:
                self.t1.pop(0)
        elif L1 < K and total >= K:
            if total == 2 * K:
                self.b2.pop(0)
            self._replace(False)
        self.t1.append(key)
        return False


class OracleTinyLFU:
    def __init__(self, K: int, rows: int = 4, width_factor: int = 16,
                 window_factor: int = 8):
        self.K = K
        self.rows = rows
        W = 1
        while W < K * width_factor:
            W *= 2
        self.W = W
        self.window = window_factor * K
        self.sketch = np.zeros((rows, W), dtype=np.int64)
        self.adds = 0
        self.keys = [EMPTY] * K
        self.last = [-1] * K
        self.t = 0

    def _hash(self, key: int):
        consts = [0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F][: self.rows]
        out = []
        for a in consts:
            x = ((key + 1) * a) & 0xFFFFFFFF
            x = (x ^ (x >> 15)) & 0xFFFFFFFF
            out.append(x & (self.W - 1))
        return out

    def _estimate(self, key: int) -> int:
        if key == EMPTY:
            return int(min(self.sketch[r, h]
                           for r, h in enumerate(self._hash(key))))
        return int(min(self.sketch[r, h]
                       for r, h in enumerate(self._hash(key))))

    def step(self, key: int) -> bool:
        hit = key in self.keys
        for r, h in enumerate(self._hash(key)):
            self.sketch[r, h] += 1
        self.adds += 1
        if self.adds >= self.window:
            self.sketch //= 2
            self.adds = 0
        if hit:
            i = self.keys.index(key)
            self.last[i] = self.t
        else:
            if EMPTY in self.keys:
                i = self.keys.index(EMPTY)
                admit = True
            else:
                i = self.last.index(min(self.last))
                admit = self._estimate(key) > self._estimate(self.keys[i])
            if admit:
                self.keys[i] = key
                self.last[i] = self.t
        self.t += 1
        return hit


class OracleHyperbolic:
    def __init__(self, K: int):
        self.keys = [EMPTY] * K
        self.cnt = [0] * K
        self.ins = [0] * K
        self.t = 0

    def step(self, key: int) -> bool:
        hit = key in self.keys
        if hit:
            self.cnt[self.keys.index(key)] += 1
        else:
            prio = [
                -np.inf if k == EMPTY else
                np.float32(np.float32(c) / np.float32(self.t - s + 1))
                for k, c, s in zip(self.keys, self.cnt, self.ins)
            ]
            i = int(np.argmin(np.array(prio, dtype=np.float32)))
            self.keys[i] = key
            self.cnt[i] = 1
            self.ins[i] = self.t
        self.t += 1
        return hit


def belady_opt(trace: np.ndarray, K: int) -> np.ndarray:
    """Belady's optimal offline policy; returns the per-request hit mask."""
    T = len(trace)
    nxt = np.full(T, np.iinfo(np.int64).max, dtype=np.int64)
    last_pos: dict = {}
    for i in range(T - 1, -1, -1):
        k = int(trace[i])
        nxt[i] = last_pos.get(k, np.iinfo(np.int64).max)
        last_pos[k] = i
    cache: dict = {}  # key -> next use position
    hits = np.zeros(T, dtype=bool)
    for i, k in enumerate(trace):
        k = int(k)
        if k in cache:
            hits[i] = True
        elif len(cache) == K:
            victim = max(cache, key=lambda q: cache[q])
            del cache[victim]
        cache[k] = nxt[i]
    return hits


ORACLES = {
    "adaptiveclimb": OracleAdaptiveClimb,
    "dynamicadaptiveclimb": OracleDynamicAdaptiveClimb,
    "fifo": OracleFIFO,
    "lru": OracleLRU,
    "blru": OracleBLRU,
    "climb": OracleClimb,
    "lfu": OracleLFU,
    "clock": OracleClock,
    "sieve": OracleSieve,
    "twoq": OracleTwoQ,
    "arc": OracleARC,
    "tinylfu": OracleTinyLFU,
    "hyperbolic": OracleHyperbolic,
}


class OracleLIRS:
    """Timestamp-formulation LIRS mirroring core.lirs_lhd.LIRS exactly."""

    def __init__(self, K: int, hir_frac: float = 0.01,
                 ghost_factor: int = 2):
        self.K = K
        self.k_hir = max(1, int(K * hir_frac))
        self.k_lir = K - self.k_hir
        self.G = ghost_factor * K
        self.t = 0
        # key -> [t_last, state]  (state in {"LIR","HIR","GHOST"})
        self.tbl: dict = {}

    def _min_lir_t(self):
        ts = [v[0] for v in self.tbl.values() if v[1] == "LIR"]
        return min(ts) if ts else -1

    def _lru(self, state):
        cands = [(v[0], k) for k, v in self.tbl.items() if v[1] == state]
        return min(cands)[1] if cands else None

    def step(self, key: int) -> bool:
        self.t += 1
        t = self.t
        ent = self.tbl.get(key)
        cur = ent[1] if ent else None
        n_lir = sum(1 for v in self.tbl.values() if v[1] == "LIR")
        min_lir = self._min_lir_t()
        in_stack = ent is not None and ent[0] >= min_lir

        if cur == "LIR":
            ent[0] = t
            return True
        if cur == "HIR":
            if in_stack and n_lir > 0:
                bottom = self._lru("LIR")
                self.tbl[bottom][1] = "HIR"
                ent[1] = "LIR"
            ent[0] = t
            return True

        # miss ----------------------------------------------------------
        n_res = sum(1 for v in self.tbl.values() if v[1] in ("LIR", "HIR"))
        if n_res >= self.K:
            hir_lru = self._lru("HIR")
            if hir_lru is not None:
                self.tbl[hir_lru][1] = "GHOST"
            else:                      # unreachable after warmup
                del self.tbl[self._lru("LIR")]
        n_ghost = sum(1 for v in self.tbl.values() if v[1] == "GHOST")
        if n_ghost > self.G:
            dropped = self._lru("GHOST")
            del self.tbl[dropped]
            if dropped == key:
                ent = None   # its ghost entry is gone, but flags captured
        was_ghost = cur == "GHOST"
        promote = was_ghost and in_stack and n_lir >= self.k_lir
        new_state = "LIR" if (n_lir < self.k_lir or promote) else "HIR"
        if promote:
            bottom = self._lru("LIR")
            self.tbl[bottom][1] = "HIR"
        self.tbl[key] = [t, new_state]
        return False


class OracleLHD:
    """Binned-age LHD mirroring core.lirs_lhd.LHD exactly (f32 math)."""

    def __init__(self, K: int, n_bins: int = 16,
                 decay_every_factor: int = 4):
        self.K = K
        self.n_bins = n_bins
        self.decay_every = decay_every_factor * K
        self.keys = np.full(K, EMPTY, np.int64)
        self.t_ins = np.full(K, -1, np.int64)
        self.hits = np.zeros(n_bins, np.int64)
        self.evs = np.zeros(n_bins, np.int64)
        self.t = 0

    def _bin(self, age):
        a = max(int(age), 0) + 1
        b = sum(1 for j in range(1, self.n_bins) if a >= 2 ** j)
        return min(b, self.n_bins - 1)

    def step(self, key: int) -> bool:
        self.t += 1
        t = self.t
        matches = np.nonzero(self.keys == key)[0]
        hit = matches.size > 0
        if hit:
            i = int(matches[0])
            self.hits[self._bin(t - self.t_ins[i])] += 1
            self.t_ins[i] = t
        else:
            num = self.hits.astype(np.float32)
            den = ((self.hits + self.evs + 1).astype(np.float32)
                   * np.exp2(np.arange(self.n_bins, dtype=np.float32)))
            hd = num / den
            slot_hd = np.array(
                [np.float32(-1.0) if self.keys[s] == EMPTY
                 else hd[self._bin(t - self.t_ins[s])]
                 for s in range(self.K)], np.float32)
            v = int(np.argmin(slot_hd))
            if self.keys[v] != EMPTY:
                self.evs[self._bin(t - self.t_ins[v])] += 1
            self.keys[v] = key
            self.t_ins[v] = t
        if t % self.decay_every == 0:
            self.hits //= 2
            self.evs //= 2
        return hit


ORACLES["lirs"] = OracleLIRS
ORACLES["lhd"] = OracleLHD
