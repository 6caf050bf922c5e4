"""Synthetic trace generators + the trace registry (the port's copy of the
reference's ``data/traces.py``, whole, so that scenario specs resolve
identically; ``tests/test_torch_isolation.py`` holds the two equal on
seeded inputs).  The port's helpers ``k_for``, ``family_trace``,
``family_batch`` and ``family_footprint`` close the module.

The paper's six public datasets cannot be redistributed or fetched offline;
each generator below produces a family of traces matched to the published
qualitative characteristics of one dataset (skew, working-set churn, scan
fraction, object-size distribution).  Every generator is deterministic in
its seed.  Keys are int32 >= 0.

Traces are addressed by spec strings, mirroring
``repro_torch.core.make_policy``::

    spec = make_trace("zipf(N=8192,alpha=0.9)")     # -> TraceSpec
    spec = make_trace("alibaba")                    # dataset-family alias
    keys = spec.generate(T=200_000, seed=0)         # [T] int32
    batch = spec.generate_batch(T=200_000, seeds=range(8))   # [8, T]

``str(spec)`` round-trips to the canonical spec string, so experiment
configs and result JSONs carry traces as data, not code.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np

from ..specs import build_kwargs, coerce_value, format_spec, parse_spec
from . import ingest

__all__ = [
    "zipf_trace", "shifting_zipf_trace", "scan_mix_trace", "churn_trace",
    "tenants_trace", "fleet_trace", "file_trace", "flood_trace",
    "scanstorm_trace", "diurnal_trace", "thrash_trace", "dataset_family",
    "DATASET_FAMILIES", "object_sizes", "bimodal_sizes", "fetch_costs",
    "TraceSpec", "make_trace", "TRACES", "TRACE_ALIASES", "TIER_FAMILIES",
    "FLEET_FAMILIES", "COLD_RANGE_FAMILIES",
    "SMALL_FRAC", "LARGE_FRAC", "k_for", "family_trace", "family_batch",
    "family_footprint",
]


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


def tenants_trace(N: int, T: int, n_tenants: int, alpha: float = 0.9,
                  period: int = 8192, duty: float = 0.25, lo: int = 64,
                  alpha_lo: float = 1.6, seed: int = 0) -> np.ndarray:
    """``[T, n_tenants]`` interleaved multi-tenant streams with
    phase-shifted working-set fluctuation.

    Each tenant alternates between a *wide* phase (working set = all ``N``
    keys — the cache thrashes, DAC's ``jump`` saturates and demands
    capacity) and a *narrow* phase (working set = ``lo`` keys — hits
    concentrate, DAC shrinks and returns capacity).  Tenant ``t``'s phase
    is shifted by ``t * period / n_tenants``, so at any instant roughly
    ``duty * n_tenants`` tenants are wide while the rest are narrow: the
    paper's §5 "fluctuating working set" regime, but *across* tenants —
    total demand stays near-constant while its owner rotates, which is
    exactly the workload where a shared budget beats static partitioning.

    Wide-phase draws are Zipf(``alpha``) over all ``N`` keys (broad, weak
    locality — capacity is what earns hits); narrow-phase draws are
    Zipf(``alpha_lo``) over the ``lo``-key hot set (tight, strong locality
    — a small cache suffices and the concentrated hits are exactly the
    signal DAC's shrink rule keys on).  Both go through a private
    per-tenant key permutation (all tenants address ``[0, N)`` but their
    hot sets differ).  Deterministic in ``seed``.

    >>> tenants_trace(N=64, T=10, n_tenants=4, seed=0).shape
    (10, 4)
    """
    rng = np.random.default_rng(seed)
    out = np.empty((T, n_tenants), np.int32)
    i = np.arange(T)
    wide_len = max(1, int(period * duty))
    for t in range(n_tenants):
        perm = rng.permutation(N).astype(np.int32)
        wide = rng.choice(N, size=T, p=_zipf_pmf(N, alpha))
        narrow = rng.choice(lo, size=T, p=_zipf_pmf(lo, alpha_lo))
        phase = (i + (t * period) // n_tenants) % period
        out[:, t] = perm[np.where(phase < wide_len, wide, narrow)]
    return out


def fleet_trace(N: int, T: int, n_lanes: int, rate: float = 0.005,
                mean_session: int = 2000, alpha: float = 0.9,
                period: int = 2048, duty: float = 0.25, lo: int = 64,
                alpha_lo: float = 1.6, seed: int = 0) -> np.ndarray:
    """``[T, n_lanes]`` dynamic-fleet request streams: tenants *arrive*
    (Poisson, ``rate`` arrivals per global step), serve one ``tenants``-
    style session (exponential length, mean ``mean_session`` steps), and
    *depart* — the entry is ``-1`` wherever a lane has no active tenant.

    This extends :func:`tenants_trace` with the lifecycle the fleet layer
    (ROADMAP A10) schedules inside its scanned program: a lane's
    key turning ``>= 0`` is an admission event (a fresh tenant takes over
    the lane's cache), turning ``-1`` a departure (the lane's slots fall
    back to the arbiter's free pool).  Each session gets a private hot-set
    permutation and a random phase offset into the same wide/narrow
    working-set fluctuation as ``tenants(...)`` — so concurrent sessions
    demand capacity at different times, the regime where arbitration
    matters.  An arrival is dropped (not queued) when every lane is busy;
    consecutive sessions on one lane are separated by at least one ``-1``
    step, so alive-mask transitions detect *every* arrival and departure.
    Deterministic in ``seed``.

    >>> keys = fleet_trace(N=64, T=400, n_lanes=4, rate=0.05,
    ...                    mean_session=100, seed=0)
    >>> keys.shape, keys.dtype.name
    ((400, 4), 'int32')
    >>> bool((keys == -1).any()), bool(keys.max() < 64)
    (True, True)
    >>> same = fleet_trace(N=64, T=400, n_lanes=4, rate=0.05,
    ...                    mean_session=100, seed=0)
    >>> bool((keys == same).all())
    True
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    out = np.full((T, n_lanes), -1, np.int32)
    pmf_wide = _zipf_pmf(N, alpha)
    pmf_lo = _zipf_pmf(lo, alpha_lo)
    wide_len = max(1, int(period * duty))
    free_at = np.zeros(n_lanes, np.int64)      # step at which a lane frees
    t = float(rng.exponential(1.0 / rate))     # first arrival time
    while t < T:
        at = int(t)
        lanes = np.flatnonzero(free_at <= at)
        if lanes.size:                         # else: dropped (all busy)
            lane = int(lanes[0])
            length = 1 + int(rng.exponential(mean_session))
            stop = min(at + length, T)
            n = stop - at
            perm = rng.permutation(N).astype(np.int32)
            wide = rng.choice(N, size=n, p=pmf_wide)
            narrow = rng.choice(lo, size=n, p=pmf_lo)
            phase = (np.arange(n) + int(rng.integers(0, period))) % period
            out[at:stop, lane] = perm[np.where(phase < wide_len, wide,
                                               narrow)]
            # ">= stop + 1": at least one dead step between sessions so
            # the alive mask transitions on every arrival/departure
            free_at[lane] = stop + 1
        t += float(rng.exponential(1.0 / rate))
    return out


def file_trace(path: str, format: str = "auto", T: int = 0,
               seed: int = 0) -> np.ndarray:
    """Keys of a *real* trace file (``repro_torch.data.ingest`` formats:
    oracleGeneral binary / CSV / key-per-line, gzip-transparent), densely
    remapped to ``[0, n_objects)`` int32 in first-appearance order.

    Real data has no seed axis: ``seed`` is accepted (the registry's
    runtime contract) and ignored.  ``T > 0`` takes the first ``T``
    requests and raises if the file is shorter — a silent wrap-around
    would distort reuse distances; ``T <= 0`` returns the whole trace.
    Per-request sizes/costs carried by the file are exposed through
    :func:`repro_torch.data.ingest.load_trace`, which the bench layer uses for
    file-backed scenarios.
    """
    del seed  # real traces are data, not a distribution to resample
    tr = ingest.load_trace(path, format=format, limit=max(0, T))
    if T > 0 and len(tr.keys) < T:
        raise ValueError(
            f"file trace {path!r} has only {len(tr.keys)} requests, "
            f"T={T} requested (no implicit wrap-around)")
    return tr.keys


# --- hostile (adversarial) families ----------------------------------------
# The robustness grid: each family targets one known failure mode of
# lightweight replacement/admission policies.  Cold/one-hit ids live in the
# disjoint range [N, 2N) (like scan_mix), so a bimodal size model can give
# them correlated (large) sizes by id.

def flood_trace(N: int, T: int, alpha: float, flood_frac: float = 0.3,
                burst_len: int = 64, phases: int = 4,
                seed: int = 0) -> np.ndarray:
    """One-hit-wonder floods: Zipf(``alpha``) base traffic over ``[0, N)``
    interrupted by bursts of *fresh* cold keys from ``[N, 2N)`` that are
    never requested again (until the cold range wraps after ``N`` flood
    requests).

    Each of the ``phases`` equal time phases carries exactly
    ``int(phase_len * flood_frac)`` flood requests, grouped into runs of
    ``burst_len`` consecutive positions on distinct block boundaries — so
    the realized per-phase flood fraction *is* the parameter (the
    property suite measures it).  Fresh ids advance a global counter
    modulo ``N``; keep total flood traffic below ``N`` requests for
    strictly one-hit wonders.  Pair with the ``bimodal(split=N)`` size
    model to make the flood large-object (the admission layer's hardest
    byte-weighted case).

    >>> keys = flood_trace(N=64, T=400, alpha=1.0, flood_frac=0.25,
    ...                    burst_len=10, phases=2)
    >>> keys.shape, bool((keys < 128).all())
    ((400,), True)
    >>> int((keys >= 64).sum())          # 2 phases x int(200 * 0.25)
    100
    """
    if not 0.0 <= flood_frac < 1.0:
        raise ValueError(f"flood_frac must lie in [0, 1), got {flood_frac}")
    if burst_len < 1 or phases < 1:
        raise ValueError("burst_len and phases must be >= 1")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    out = zipf_trace(N, T, alpha, seed=seed + 1).astype(np.int64)
    bounds = np.linspace(0, T, phases + 1).astype(int)
    counter = 0
    for ph in range(phases):
        lo, hi = bounds[ph], bounds[ph + 1]
        L = hi - lo
        n_flood = int(L * flood_frac)
        if n_flood == 0:
            continue
        blocks = L // burst_len
        if n_flood > blocks * burst_len:
            raise ValueError(
                f"flood_frac={flood_frac} with burst_len={burst_len} does "
                f"not fit a phase of {L} requests; shrink burst_len or "
                "flood_frac")
        n_bursts = -(-n_flood // burst_len)
        chosen = rng.choice(blocks, size=n_bursts, replace=False)
        remaining = n_flood
        for j in np.sort(chosen):
            start = lo + int(j) * burst_len
            take = min(burst_len, remaining)
            out[start:start + take] = N + (counter + np.arange(take)) % N
            counter += take
            remaining -= take
    return out.astype(np.int32)


def scanstorm_trace(N: int, T: int, alpha: float, mean_phase: int = 2000,
                    drift: float = 0.1, storm_frac: float = 0.25,
                    scan_len: int = 256, seed: int = 0) -> np.ndarray:
    """Sequential scans landing *mid-churn*: a :func:`churn_trace` base
    (popularity drifting every phase) overwritten by scan runs over the
    cold id range ``[N, 2N)`` — the cache must survive the flush while
    the hot set underneath it is already moving.

    >>> keys = scanstorm_trace(N=64, T=300, alpha=1.0, mean_phase=100,
    ...                        drift=0.1, storm_frac=0.25, scan_len=16)
    >>> keys.shape, bool((keys < 128).all()), bool((keys >= 64).any())
    ((300,), True, True)
    """
    if not 0.0 <= storm_frac < 1.0:
        raise ValueError(f"storm_frac must lie in [0, 1), got {storm_frac}")
    if scan_len < 1:
        raise ValueError(f"scan_len must be >= 1, got {scan_len}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 4]))
    out = churn_trace(N, T, alpha, mean_phase, drift,
                      seed=seed).astype(np.int64)
    n_scans = max(1, int(T * storm_frac / scan_len))
    for _ in range(n_scans):
        start = rng.integers(0, max(1, T - scan_len))
        base = rng.integers(0, N)
        length = min(scan_len, T - start)
        out[start:start + length] = N + (base + np.arange(length)) % N
    return out.astype(np.int32)


def diurnal_trace(N: int, T: int, alpha: float = 0.9, period: int = 4096,
                  duty: float = 0.5, lo: int = 64, alpha_lo: float = 1.6,
                  seed: int = 0) -> np.ndarray:
    """Diurnal load swings on a single cache: the working set alternates
    between *wide* (Zipf(``alpha``) over all ``N`` keys, ``duty`` of each
    ``period``) and *narrow* (Zipf(``alpha_lo``) over a ``lo``-key hot
    set) — the single-tenant version of :func:`tenants_trace`'s
    fluctuating-working-set regime, which is where the paper claims DAC's
    resizing wins and where admission must not pin the cache to the stale
    wide set.

    >>> keys = diurnal_trace(N=64, T=200, period=40, duty=0.5, lo=8)
    >>> keys.shape, bool((keys < 64).all())
    ((200,), True)
    """
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must lie in (0, 1), got {duty}")
    if not 1 <= lo <= N:
        raise ValueError(f"lo must lie in [1, N], got {lo}")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(N).astype(np.int32)
    wide = rng.choice(N, size=T, p=_zipf_pmf(N, alpha))
    narrow = rng.choice(lo, size=T, p=_zipf_pmf(lo, alpha_lo))
    phase = np.arange(T) % period
    wide_len = max(1, int(period * duty))
    return perm[np.where(phase < wide_len, wide, narrow)].astype(np.int32)


def thrash_trace(N: int, T: int, loop: int, seed: int = 0) -> np.ndarray:
    """The adversarial eviction-order pattern: a strict cyclic sweep over
    ``loop`` distinct keys (a seeded subset of ``[0, N)``).  Every reuse
    distance is exactly ``loop - 1``, so any policy holding ``K < loop``
    slots with LRU-like eviction order misses *every* request — the
    classic sequential-flooding worst case (FIFO/CLOCK/LRU all degrade;
    frequency-free policies cannot recover).

    >>> keys = thrash_trace(N=64, T=12, loop=4, seed=0)
    >>> sorted(set(keys.tolist())) == sorted(set(keys[:4].tolist()))
    True
    >>> bool((keys[:4] == keys[4:8]).all())
    True
    """
    if not 1 <= loop <= N:
        raise ValueError(f"loop must lie in [1, N], got {loop}")
    rng = np.random.default_rng(seed)
    cycle = rng.permutation(N)[:loop].astype(np.int32)
    return cycle[np.arange(T) % loop]


# --- dataset families ------------------------------------------------------
# Parameters chosen to mimic the published character of each dataset:
#   alibaba   block storage, high skew, heavy churn, large footprint
#   tencent   block storage (CBS), large working set, weak temporal locality
#   twitter   in-memory KV, very high skew, strong temporal locality
#   metacdn   CDN, scans + skew mix
#   metakv    KV, skewed with drift
#   wiki      CDN-like, moderate skew, large objects (used for byte-miss)

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


# --- trace registry --------------------------------------------------------
# Mirrors the policy registry: family name -> generator.  Spec params are
# the generator's parameters minus the runtime axes (T, seed), coerced to
# the declared type exactly like make_policy's constructor kwargs.

TRACES = {
    "zipf": zipf_trace,
    "shifting_zipf": shifting_zipf_trace,
    "scan_mix": scan_mix_trace,
    "churn": churn_trace,
    "tenants": tenants_trace,
    "fleet": fleet_trace,
    "file": file_trace,
    "flood": flood_trace,
    "scanstorm": scanstorm_trace,
    "diurnal": diurnal_trace,
    "thrash": thrash_trace,
}

# families whose cold/one-hit ids live in the disjoint range [N, 2N): the
# id footprint is 2N, and a bimodal(split=N) size model makes cold
# traffic large-object by construction
COLD_RANGE_FAMILIES = frozenset({"scan_mix", "flood", "scanstorm"})

# families whose generators emit [T, n_tenants] interleaved tier streams
# (the tier layer's replay_tier input) rather than a single [T] key trace
TIER_FAMILIES = frozenset({"tenants"})

# families whose [T, n_lanes] streams additionally carry -1 "no active
# tenant" entries — the fleet layer's replay_fleet input ONLY (a -1 key fed
# to replay_tier would spuriously hit the EMPTY rank sentinel)
FLEET_FAMILIES = frozenset({"fleet"})

_RUNTIME_PARAMS = ("T", "seed")

# each DATASET_FAMILIES "kind" is one registered family
_KIND_TO_FAMILY = {"churn": "churn", "scan": "scan_mix",
                   "zipfshift": "shifting_zipf"}

# dataset names resolve like policy aliases: to a (family, params) expansion
TRACE_ALIASES = {
    name: (_KIND_TO_FAMILY[cfg["kind"]],
           {k: v for k, v in cfg.items() if k != "kind"})
    for name, cfg in DATASET_FAMILIES.items()
}


def _family_params(family: str) -> dict:
    fn = TRACES[family]
    return {k: p for k, p in inspect.signature(fn).parameters.items()
            if k not in _RUNTIME_PARAMS}


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A trace family plus its parameters — data, not code.

    ``params`` is stored as a tuple of ``(name, value)`` pairs in the
    generator's signature order, so specs are hashable and ``str(spec)``
    is canonical (parsing it back yields an equal spec).

    >>> spec = make_trace("zipf(N=128,alpha=1.0)")
    >>> str(spec), spec.n_keys, spec.is_tier
    ('zipf(N=128,alpha=1.0)', 128, False)
    >>> spec.generate(T=50, seed=3).shape
    (50,)
    >>> spec.generate_batch(T=50, seeds=(0, 1)).shape
    (2, 50)
    """

    family: str
    params: tuple = ()

    @property
    def kwargs(self) -> dict:
        return dict(self.params)

    @property
    def n_keys(self) -> int:
        """Id-space footprint: keys lie in ``[0, n_keys)``.  Cold-range
        families (:data:`COLD_RANGE_FAMILIES` — scan mixes, floods, scan
        storms) address ``[0, 2N)`` (cold ids live in ``[N, 2N)``); file
        traces resolve their distinct-key count from the file itself
        (``repro_torch.data.ingest.characterize``, cached by path + mtime)."""
        if self.is_file:
            return self.stats().n_objects
        N = self.kwargs["N"]
        return 2 * N if self.family in COLD_RANGE_FAMILIES else N

    @property
    def is_file(self) -> bool:
        """True for file-backed traces (family ``"file"``): real data —
        ``generate`` ignores the seed, and per-request sizes/costs come
        from the file rather than a synthetic size model."""
        return self.family == "file"

    def stats(self) -> "ingest.TraceStats":
        """File-backed traces only: the underlying file's
        :class:`repro_torch.data.ingest.TraceStats` (request/object counts,
        byte footprint, skew estimate)."""
        if not self.is_file:
            raise ValueError(
                f"stats() is for file-backed traces; {self.family!r} is "
                "synthetic — its footprint is the N parameter")
        return ingest.characterize(self.kwargs["path"],
                                   self.kwargs.get("format", "auto"))

    @property
    def n_requests(self) -> int:
        """File-backed traces only: the trace length, via the cheap
        :func:`repro_torch.data.ingest.count_requests` path (O(1) for
        uncompressed oracle files — no full characterization pass)."""
        if not self.is_file:
            raise ValueError(
                f"n_requests is for file-backed traces; {self.family!r} "
                "is synthetic — any T can be generated")
        return ingest.count_requests(self.kwargs["path"],
                                     self.kwargs.get("format", "auto"))

    @property
    def is_tier(self) -> bool:
        """True for multi-tenant families: ``generate`` returns a
        ``[T, n_tenants]`` interleaved stream (the tier layer's input), not
        a single ``[T]`` trace.  Fleet families are *not* tier input —
        their ``-1`` inactive-lane entries only make sense to
        the fleet layer's ``replay_fleet`` (see :data:`FLEET_FAMILIES`)."""
        return self.family in TIER_FAMILIES

    @property
    def is_fleet(self) -> bool:
        """True for dynamic-lifecycle families (``fleet(...)``): a
        ``[T, n_lanes]`` stream with ``-1`` marking lanes with no active
        tenant — the fleet layer's ``replay_fleet`` input."""
        return self.family in FLEET_FAMILIES

    @property
    def n_tenants(self) -> int:
        """Tenant/lane-axis width for tier and fleet families; 1 for
        single-cache ones."""
        if self.is_fleet:
            return self.kwargs["n_lanes"]
        return self.kwargs["n_tenants"] if self.is_tier else 1

    def __str__(self) -> str:
        return format_spec(self.family, self.kwargs)

    def generate(self, T: int, seed: int = 0) -> np.ndarray:
        """One ``[T]`` int32 trace, deterministic in ``seed`` (file-backed
        traces are real data — every seed returns the same keys)."""
        return TRACES[self.family](T=T, seed=seed, **self.kwargs)

    def generate_batch(self, T: int, seeds) -> np.ndarray:
        """``[len(seeds), T]`` independent traces — the seed axis the sweep
        runner vmaps over."""
        return np.stack([self.generate(T, seed=int(s)) for s in seeds])


def make_trace(spec) -> TraceSpec:
    """Build a :class:`TraceSpec` from a spec string: a registered family
    (``"zipf(N=8192,alpha=0.9)"``), a dataset alias (``"alibaba"``,
    optionally with parameter overrides), or a real trace file
    (``"file(path=benchmarks/corpus/kv.csv.gz)"``).  Values are coerced
    to the generator parameter's declared type; unknown families, unknown
    parameters, and missing required parameters raise ``ValueError`` —
    the same contract as ``make_policy``.  ``TraceSpec`` instances pass
    through.

    >>> str(make_trace("wiki"))                 # alias expansion
    'shifting_zipf(N=8192,alpha=0.9,phases=4)'
    >>> str(make_trace("wiki(alpha=1.2)"))      # ... with overrides
    'shifting_zipf(N=8192,alpha=1.2,phases=4)'
    >>> make_trace("tenants(N=64,n_tenants=2)").n_tenants
    2
    """
    if isinstance(spec, TraceSpec):
        return spec
    name, argstr = parse_spec(spec)
    base = {}
    if name in TRACE_ALIASES:
        name, base = TRACE_ALIASES[name]
    if name not in TRACES:
        raise ValueError(
            f"unknown trace family {name!r}; known: {sorted(TRACES)} "
            f"(aliases: {sorted(TRACE_ALIASES)})")
    sig = _family_params(name)
    kwargs = {k: coerce_value("trace family", name, sig, k, v)
              for k, v in base.items()}
    kwargs.update(build_kwargs("trace family", name, TRACES[name], argstr,
                               skip=_RUNTIME_PARAMS))
    missing = [k for k, p in sig.items()
               if p.default is inspect.Parameter.empty and k not in kwargs]
    if missing:
        raise ValueError(
            f"trace family {name!r} missing required parameters {missing}; "
            f"accepts: {sorted(sig)}")
    ordered = tuple((k, kwargs[k]) for k in sig if k in kwargs)
    return TraceSpec(family=name, params=ordered)


def dataset_family(name: str, T: int = 200_000, n_traces: int = 3,
                   seed: int = 0) -> np.ndarray:
    """Return [n_traces, T] synthetic traces for one dataset family.

    Back-compat wrapper over the registry: ``make_trace(name)`` plus the
    historical ``seed * 1000 + i`` per-trace seeding.

    >>> dataset_family("wiki", T=100, n_traces=2).shape
    (2, 100)
    """
    if name not in TRACE_ALIASES:
        raise ValueError(
            f"unknown dataset family {name!r}; known: {sorted(TRACE_ALIASES)}")
    spec = make_trace(name)
    return spec.generate_batch(
        T, seeds=[seed * 1000 + i for i in range(n_traces)])


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


def bimodal_sizes(n_objects: int, seed: int = 0, split: int = 8192,
                  small_kb: float = 4.0, large_kb: float = 64.0,
                  sigma: float = 0.5) -> np.ndarray:
    """Two-population log-normal size table: ids below ``split`` draw
    around ``small_kb``, ids at or above it around ``large_kb``.  With a
    cold-range trace family (``flood``/``scanstorm``/``scan_mix``) and
    ``split=N``, the hostile cold traffic is large-object *by id* — the
    correlated-size regime where byte-weighted metrics punish size-blind
    admission hardest.

    >>> sizes = bimodal_sizes(100, split=50, small_kb=4, large_kb=64,
    ...                       sigma=0.0)
    >>> [round(s / 1024) for s in sizes[[0, 99]]]
    [4, 64]
    """
    rng = np.random.default_rng(seed)
    small = rng.lognormal(np.log(small_kb), sigma, size=n_objects)
    large = rng.lognormal(np.log(large_kb), sigma, size=n_objects)
    kb = np.where(np.arange(n_objects) < split, small, large)
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


# --- the port's helpers ------------------------------------------------------

# cache-size regimes, as fractions of the trace id footprint (paper §V-B:
# small = 0.1%, large = 10%); the reference keeps these and ``k_for`` in
# ``bench/scenario.py``, which the port's re-exports
SMALL_FRAC = 0.001
LARGE_FRAC = 0.10


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


def family_trace(name: str, T: int, seed: int = 0) -> np.ndarray:
    """One ``[T]`` trace of a dataset family: ``make_trace(name)
    .generate(T, seed)``.

    >>> family_trace("wiki", T=100, seed=0).shape
    (100,)
    """
    return make_trace(name).generate(T, seed=seed)


def family_batch(name: str, T: int, seeds) -> np.ndarray:
    """``[len(seeds), T]`` independent traces of one dataset family."""
    return make_trace(name).generate_batch(T, seeds)


def family_footprint(name: str) -> int:
    """Id footprint of a dataset family: ``N``, or ``2N`` for scan mixes.

    >>> family_footprint("wiki"), family_footprint("tencent")
    (8192, 16384)
    """
    return make_trace(name).n_keys
