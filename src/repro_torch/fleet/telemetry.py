"""Per-tenant SLO telemetry for the fleet replay (port of
``fleet/telemetry.py``).

The fleet replay carries a fixed-bucket **penalty histogram** per lane
(O(BINS) state), from which any quantile is recovered on the host to
one-bucket resolution.  Buckets are log2-spaced (bucket 0 is exactly "no
penalty"): fine where SLO thresholds live, coarse in the tail's far end.
Occupancy *fairness* is Jain's index over the lanes' mean active sizes,
``J = (sum x)^2 / (n * sum x^2)``: 1.0 when every tenant holds the same
share, ``1/n`` when one holds everything.

>>> h = torch.zeros(BINS, dtype=torch.int32)
>>> for p in [0.0, 0.0, 2.0, 40.0]:
...     h[int(penalty_bucket(torch.tensor(p)))] += 1
>>> float(penalty_quantile(h, 0.5))       # median request: no penalty
0.0
>>> float(penalty_quantile(h, 0.99))      # p99 lands in 40ms's bucket
64.0
>>> round(float(jain_index(np.array([4., 4., 4., 4.]))), 3)
1.0
>>> round(float(jain_index(np.array([16., 0., 0., 0.]))), 3)
0.25
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["BINS", "LOG2_LO", "penalty_bucket", "penalty_quantile",
           "jain_index", "window_records"]

# bucket 0: zero penalty; buckets 1..BINS-1: log2-spaced, bucket j covering
# [2^(LOG2_LO+j-1), 2^(LOG2_LO+j)) cost units, clamped at both ends
BINS = 32
LOG2_LO = -4

# log(2) in float32, the divisor of the reference's log2
_LN2 = float(np.log(np.float32(2.0)))


def penalty_bucket(penalty):
    """Histogram bucket index (int32, any shape) of a float32 per-request
    miss penalty: 0 for no penalty, else log2-spaced and edge-clamped.

    The reference takes ``floor(log(x) / log(2))`` in float32, which next
    to a power of two can round up to it (``2^-3 * (1 - 2^-24)`` lands in
    the bucket of ``2^-3``).  The port rounds the same way on
    every device: the natural log in float64 rounded to float32 (the
    correctly rounded float32 log), then the IEEE float32 division.  At
    every float32 within 200 ulps of each power of two from 2^-8 to 2^29,
    and 300,000 others, the bucket equals the reference's.

    >>> penalty_bucket(torch.tensor([0.0, 1.0, 8.0, 40.0])).tolist()
    [0, 5, 8, 10]
    """
    safe = torch.clamp(penalty, min=1e-30)
    log32 = torch.log(safe.to(torch.float64)).to(torch.float32)
    # the divisor as a tensor on the device: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal instead
    ln2 = torch.full((), _LN2, dtype=torch.float32, device=penalty.device)
    idx = torch.floor(log32 / ln2).to(torch.int32) - LOG2_LO + 1
    return torch.where(penalty > 0, torch.clamp(idx, 1, BINS - 1), 0)


def _edges() -> np.ndarray:
    """Upper edge of each bucket (bucket 0's is exactly 0.0)."""
    return np.concatenate(
        [[0.0], 2.0 ** (LOG2_LO + np.arange(1, BINS, dtype=np.float64))])


def _host(x):
    return (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x))


def penalty_quantile(hist, q: float):
    """The ``q``-quantile's bucket upper edge, from a ``[..., BINS]``
    histogram (host side).  Conservative to one bucket: the true quantile
    is at most the returned edge.  Empty histograms report 0.0."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must lie in [0, 1], got {q}")
    h = np.asarray(_host(hist), np.float64)
    total = h.sum(axis=-1)
    cdf = np.cumsum(h, axis=-1)
    # first bucket where the CDF crosses q * total
    target = q * total[..., None]
    idx = np.argmax(cdf >= target - 1e-9, axis=-1)
    out = _edges()[idx]
    return np.where(total > 0, out, 0.0)


def jain_index(x, mask=None):
    """Jain's fairness index over the last axis, ``(sum x)^2 / (n sum
    x^2)``, with ``mask`` selecting the lanes that count.  An empty or
    all-zero selection reports 1.0."""
    x = np.asarray(_host(x), np.float64)
    if mask is not None:
        x = np.where(np.asarray(mask, bool), x, 0.0)
        n = np.asarray(mask, bool).sum(axis=-1)
    else:
        n = x.shape[-1]
    s1 = x.sum(axis=-1)
    s2 = (x * x).sum(axis=-1)
    den = n * s2
    out = np.divide(s1 * s1, den, out=np.ones_like(s1, np.float64),
                    where=den > 0)
    return float(out) if np.ndim(out) == 0 else out


def window_records(obs, windows: int = 8):
    """Downsample a fleet replay's ``obs`` (``{"k": [T, N], "alive":
    [T, N]}``) into per-window records: each window's mean occupancy per
    lane, alive fraction, and ``max_t sum_i k``.  Host side."""
    ks = np.asarray(_host(obs["k"]), np.float64)
    alive = np.asarray(_host(obs["alive"]), bool)
    T = ks.shape[0]
    bounds = np.linspace(0, T, windows + 1).astype(int)
    out = []
    for w in range(windows):
        lo, hi = int(bounds[w]), int(bounds[w + 1])
        if hi <= lo:
            continue
        out.append({
            "t0": lo, "t1": hi,
            "mean_k": [float(v) for v in ks[lo:hi].mean(axis=0)],
            "alive_frac": [float(v) for v in alive[lo:hi].mean(axis=0)],
            "peak_sum_k": float(ks[lo:hi].sum(axis=1).max()),
        })
    return out
