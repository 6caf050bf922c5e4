"""Fleet serving: dynamic multi-tenant DAC with auction arbitration and
per-tenant SLO telemetry (port of ``repro.fleet``, on one device).

Where :mod:`repro_torch.tier` holds a fixed tenant set, the fleet serves a
population: tenants arrive, hold a cache lane for one session and leave,
all inside one step loop over fixed-shape ``[n_lanes]`` pools with an
alive mask.  The ``auction`` arbiter prices capacity by each tenant's
byte-miss-cost EWMA, and every replay carries SLO telemetry: per-tenant
penalty quantiles (p50/p99 from the histograms) and Jain's
occupancy-fairness index.  ``replay_fleet(mesh=...)`` shards the lanes
over the ranks of a mesh axis with a periodic budget re-deal.

>>> from repro_torch.data.traces import fleet_trace
>>> keys = fleet_trace(N=64, T=400, n_lanes=4, rate=0.05,
...                    mean_session=120, seed=1)
>>> fl = FleetTier("dac(k_min=4)", n_lanes=4, budget=64, arbiter="auction")
>>> res = replay_fleet(fl, keys, device="cpu")
>>> 0.0 <= float(res.jain) <= 1.0
True
"""
from .fleet import FleetResult, FleetTier, replay_fleet
from .telemetry import (BINS, jain_index, penalty_bucket, penalty_quantile,
                        window_records)

__all__ = [
    "FleetTier", "FleetResult", "replay_fleet",
    "BINS", "penalty_bucket", "penalty_quantile", "jain_index",
    "window_records",
]
