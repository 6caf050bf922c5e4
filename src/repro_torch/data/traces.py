"""Synthetic trace generators the port's replay needs (a copy of part of
``repro/data/traces.py`` and of ``k_for`` in ``repro/bench/scenario.py``).

The port imports nothing of the reference package, so it keeps its own
copy; ``tests/test_torch_isolation.py`` holds every copied generator equal
to the original bit for bit.  Every generator is deterministic in its seed
(numpy ``Generator`` s); keys are int32 >= 0.

The six dataset families resolve through :func:`family_trace`, as the
reference's ``make_trace(name).generate`` does.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "zipf_trace", "shifting_zipf_trace", "scan_mix_trace", "churn_trace",
    "DATASET_FAMILIES", "object_sizes", "fetch_costs", "k_for",
    "family_trace", "family_batch", "family_footprint",
]

# cache-size regimes, as fractions of the trace id footprint (paper §V-B:
# small = 0.1%, large = 10%)
SMALL_FRAC = 0.001
LARGE_FRAC = 0.10

def _zipf_pmf(N: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, N + 1, dtype=np.float64)
    w = ranks ** -alpha
    return w / w.sum()


def zipf_trace(N: int, T: int, alpha: float, seed: int = 0) -> np.ndarray:
    """IID Zipf(alpha) requests over N objects.

    >>> keys = zipf_trace(N=64, T=100, alpha=1.0, seed=0)
    >>> keys.shape, keys.dtype.name, bool((keys < 64).all())
    ((100,), 'int32', True)
    >>> bool((keys == zipf_trace(N=64, T=100, alpha=1.0, seed=0)).all())
    True
    """
    rng = np.random.default_rng(seed)
    pmf = _zipf_pmf(N, alpha)
    return rng.choice(N, size=T, p=pmf).astype(np.int32)


def shifting_zipf_trace(N: int, T: int, alpha: float, phases: int,
                        seed: int = 0) -> np.ndarray:
    """Zipf requests whose item->rank mapping is re-permuted each phase.

    Models working-set churn: popular objects change identity abruptly.
    This is the regime where the paper claims DynamicAdaptiveClimb shines
    ("fluctuating working set sizes").

    >>> shifting_zipf_trace(N=64, T=50, alpha=0.9, phases=2).shape
    (50,)
    """
    rng = np.random.default_rng(seed)
    pmf = _zipf_pmf(N, alpha)
    out = np.empty(T, dtype=np.int32)
    bounds = np.linspace(0, T, phases + 1).astype(int)
    for ph in range(phases):
        perm = rng.permutation(N).astype(np.int32)
        draws = rng.choice(N, size=bounds[ph + 1] - bounds[ph], p=pmf)
        out[bounds[ph]:bounds[ph + 1]] = perm[draws]
    return out


def scan_mix_trace(N: int, T: int, alpha: float, scan_frac: float,
                   scan_len: int, seed: int = 0) -> np.ndarray:
    """Zipf traffic interleaved with sequential scans over cold keys.

    Scans are the classic LRU-killer (they flush the cache with
    never-reused objects); CDN / block-storage traces contain many.
    Scan keys live in a disjoint id range [N, 2N): a scan run that would
    pass 2N-1 wraps around *within* the cold range (modulo N on the
    offset), never back into the hot Zipf range [0, N).

    >>> keys = scan_mix_trace(N=64, T=200, alpha=1.0, scan_frac=0.3,
    ...                       scan_len=16)
    >>> bool((keys < 128).all())       # ids span [0, 2N)
    True
    """
    rng = np.random.default_rng(seed)
    out = zipf_trace(N, T, alpha, seed=seed + 1).astype(np.int64)
    n_scans = max(1, int(T * scan_frac / scan_len))
    for s in range(n_scans):
        start = rng.integers(0, max(1, T - scan_len))
        base = rng.integers(0, N)
        length = min(scan_len, T - start)
        out[start:start + length] = N + (base + np.arange(length)) % N
    return out.astype(np.int32)


def _phase_sizes(rng, T, mean_phase):
    sizes = []
    total = 0
    while total < T:
        s = int(rng.exponential(mean_phase)) + mean_phase // 4 + 1
        sizes.append(min(s, T - total))
        total += s
    return sizes


def _churn_phases(N: int, T: int, mean_phase: int, drift: float,
                  hot_frac: float, seed: int):
    """Yield ``(start, stop, perm)`` per churn phase, where ``perm[r]`` is
    the object id occupying popularity rank ``r`` during that phase.

    Each phase swaps ``round(H * drift)`` ids out of the hot ranks
    ``[0, H)`` (``H = max(1, int(N * hot_frac))``) against ids drawn from
    the cold ranks ``[H, N)`` — so the realized hot-set turnover is
    *exactly* ``round(H * drift) / H`` every phase, not a lumpy binomial
    whose typical value is far below ``drift`` for skewed traces (the old
    uniform-over-all-``N`` rotation touched the hot ranks only in
    expectation).  Any positive ``drift`` rotates at least one id, so the
    turnover is floored at ``1/H`` when ``H * drift < 1/2`` rather than
    silently rounding to a drift-free trace.  The per-phase test in
    ``tests/test_traces.py`` measures turnover through this generator."""
    if not 0 < hot_frac < 1:
        raise ValueError(
            f"hot_frac must lie in (0, 1), got {hot_frac} — with no cold "
            "ranks there is nothing to rotate against")
    if not 0 <= drift <= 1:
        raise ValueError(
            f"drift must lie in [0, 1], got {drift} — it is the fraction "
            "of the hot set rotated per phase")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
    perm = rng.permutation(N).astype(np.int32)
    H = max(1, int(N * hot_frac))
    n_rot = max(1, int(round(H * drift))) if drift > 0 else 0
    if n_rot > N - H:
        # clamping would silently deliver less turnover than promised
        raise ValueError(
            f"drift={drift} with hot_frac={hot_frac} needs {n_rot} cold "
            f"ids per phase but only {N - H} exist; shrink hot_frac or "
            "drift")
    pos = 0
    for size in _phase_sizes(rng, T, mean_phase):
        if n_rot > 0:
            hot = rng.choice(H, size=n_rot, replace=False)
            cold = H + rng.choice(N - H, size=n_rot, replace=False)
            swap_in, swap_out = perm[cold].copy(), perm[hot].copy()
            perm[hot], perm[cold] = swap_in, swap_out
        yield pos, pos + size, perm.copy()
        pos += size


def churn_trace(N: int, T: int, alpha: float, mean_phase: int,
                drift: float, seed: int = 0, *,
                hot_frac: float = 0.1) -> np.ndarray:
    """Zipf with gradual popularity drift: each phase, a ``drift`` fraction
    of the hot set — the ids on the top ``hot_frac * N`` popularity ranks —
    is rotated out against previously-cold ids; the rest persists.  Closer
    to production KV churn than full re-permutation.

    The rotation swaps exactly ``round(H * drift)`` hot-ranked ids
    (at least one while ``drift > 0``) with cold-ranked ones per phase
    (``H = hot_frac * N``), so the realized hot-set turnover *is* the
    ``drift`` parameter, deterministically —
    rather than a drift-in-expectation-only shuffle spread uniformly over
    all ``N`` ids, which left the typical phase of a skewed trace with no
    hot turnover at all.

    >>> churn_trace(N=64, T=50, alpha=1.0, mean_phase=20, drift=0.1).shape
    (50,)
    """
    pmf = _zipf_pmf(N, alpha)
    draw = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    out = np.empty(T, dtype=np.int32)
    for start, stop, perm in _churn_phases(N, T, mean_phase, drift,
                                           hot_frac, seed):
        out[start:stop] = perm[draw.choice(N, size=stop - start, p=pmf)]
    return out


def object_sizes(n_objects: int, seed: int = 0,
                 median_kb: float = 16.0, sigma: float = 1.5) -> np.ndarray:
    """Log-normal object sizes in bytes (wiki-like heavy tail).

    >>> sizes = object_sizes(1000, seed=0)
    >>> sizes.shape, bool((sizes >= 1).all())
    ((1000,), True)
    """
    rng = np.random.default_rng(seed)
    kb = rng.lognormal(mean=np.log(median_kb), sigma=sigma, size=n_objects)
    return np.maximum(1, (kb * 1024).astype(np.int64))


def fetch_costs(sizes_bytes: np.ndarray, base_ms: float = 2.0,
                per_mb_ms: float = 8.0) -> np.ndarray:
    """Miss penalty (ms) for fetching an object from the backing store:
    a fixed round-trip plus a bandwidth term.  Feeds ``Request.cost`` so
    the engine's ``penalty_ratio`` measures latency-weighted misses, not
    just request- or byte-weighted ones.

    >>> float(fetch_costs(np.array([0.0]), base_ms=2.0)[0])
    2.0
    """
    sizes_bytes = np.asarray(sizes_bytes, dtype=np.float64)
    return (base_ms + per_mb_ms * sizes_bytes / 2**20).astype(np.float32)


def k_for(N: int, regime: str) -> int:
    """Resolve a regime letter to a capacity: S = 0.1%, L = 10% of N
    (paper §V-B), floored at 4 slots.

    >>> k_for(8192, "S"), k_for(8192, "L")
    (8, 819)
    """
    if regime not in ("S", "L"):
        raise ValueError(f"capacity regime must be 'S' or 'L', got {regime!r}")
    frac = SMALL_FRAC if regime == "S" else LARGE_FRAC
    return max(4, int(N * frac))


DATASET_FAMILIES = {
    "alibaba": dict(kind="churn", N=8192, alpha=1.1, mean_phase=20000,
                    drift=0.2),
    "tencent": dict(kind="scan", N=8192, alpha=0.7, scan_frac=0.3,
                    scan_len=2048),
    "twitter": dict(kind="churn", N=8192, alpha=1.3, mean_phase=50000,
                    drift=0.05),
    "metacdn": dict(kind="scan", N=8192, alpha=1.0, scan_frac=0.15,
                    scan_len=1024),
    "metakv": dict(kind="churn", N=8192, alpha=1.05, mean_phase=30000,
                   drift=0.1),
    "wiki": dict(kind="zipfshift", N=8192, alpha=0.9, phases=4),
}


# each DATASET_FAMILIES "kind" is one generator; scan mixes put their cold
# ids in [N, 2N), so their id footprint is 2N
_KIND_TO_GENERATOR = {"churn": churn_trace, "scan": scan_mix_trace,
                      "zipfshift": shifting_zipf_trace}


def family_trace(name: str, T: int, seed: int = 0) -> np.ndarray:
    """One ``[T]`` trace of a dataset family, as the reference's
    ``make_trace(name).generate(T, seed)``.

    >>> family_trace("wiki", T=100, seed=0).shape
    (100,)
    """
    cfg = dict(DATASET_FAMILIES[name])
    return _KIND_TO_GENERATOR[cfg.pop("kind")](T=T, seed=seed, **cfg)


def family_batch(name: str, T: int, seeds) -> np.ndarray:
    """``[len(seeds), T]`` independent traces of one dataset family."""
    return np.stack([family_trace(name, T, int(s)) for s in seeds])


def family_footprint(name: str) -> int:
    """Id footprint of a dataset family: ``N``, or ``2N`` for scan mixes.

    >>> family_footprint("wiki"), family_footprint("tencent")
    (8192, 16384)
    """
    cfg = DATASET_FAMILIES[name]
    return 2 * cfg["N"] if cfg["kind"] == "scan" else cfg["N"]
