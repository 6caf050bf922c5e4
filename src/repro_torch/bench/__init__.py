"""Declarative experiment API of the port (``repro.bench``'s counterpart):
experiments are data, not code.

The paper's evaluation grid as three layers::

    scenario = Scenario("wiki", trace="wiki", T=60_000, K=("S", "L"),
                        size_model="lognormal", cost_model="fetch")
    sweep = Sweep("fig8", policies=("lru", "arc", "dac"),
                  scenarios=(scenario,), seeds=(0, 1, 2))
    result = run_sweep(sweep)                 # seeds batched as lanes
    payload = result.save()                   # canonical versioned JSON

``run_sweep`` runs on the engine's device (``Engine()`` is the card;
``run_sweep(sweep, engine=Engine(device="cpu"))`` runs the plain
versions).  :mod:`repro_torch.bench.results` owns the versioned,
provenance-stamped, validated payloads that
:mod:`repro_torch.bench.report` renders into the paper's tables.
``run_tier_sweep`` and ``run_fleet_sweep`` run the multi-tenant grids
(:class:`TierSweep`, :class:`FleetSweep`) through ``Engine.replay_tier``
and ``Engine.replay_fleet`` into ``SCHEMA_V2`` records.
"""
from . import report, results
from .runner import (STREAM_THRESHOLD, FleetSweepResult, SweepResult,
                     TierSweepResult, materialize, run_fleet_sweep,
                     run_sweep, run_tier_sweep, should_stream,
                     stream_chunks)
from .scenario import (COST_MODELS, LARGE_FRAC, SIZE_MODELS, SMALL_FRAC,
                       FleetScenario, FleetSweep, Scenario, ServeScenario,
                       Sweep, TierScenario, TierSweep, k_for)

__all__ = [
    "Scenario", "Sweep", "SweepResult", "run_sweep", "materialize",
    "should_stream", "stream_chunks", "STREAM_THRESHOLD",
    "TierScenario", "TierSweep", "TierSweepResult", "run_tier_sweep",
    "FleetScenario", "FleetSweep", "FleetSweepResult", "run_fleet_sweep",
    "ServeScenario",
    "results", "report", "k_for",
    "SIZE_MODELS", "COST_MODELS", "SMALL_FRAC", "LARGE_FRAC",
]
