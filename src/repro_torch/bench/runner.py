"""Grid execution: a Sweep runs through the Engine, seeds batched as lanes
(port of ``bench/runner.py``).

For every (policy, scenario, K) cell the runner builds one ``[S, T]``
request batch (S = the sweep's seed axis) and issues a *single*
``Engine.replay`` call: the seeds replay as parallel cache lanes
(metrics-only, the totals reduced on the device), instead of a Python loop
over seeds.  On CUDA a rank policy's cell is one launch of kernel B1 and a
slot policy's cell a CUDA graph per chunk of steps (``core/simulator.py``);
the engine's device decides, so there is no ``use_pallas=``.  With
``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) materialized cells
shard their seed lanes over the mesh's ``data`` axis, every rank running
the same sweep and getting the same records.

Two execution paths per cell, producing identical records (bit for bit
whenever the float32 byte/cost running sums are exact; always for the
integer counts and ratios):

* *materialized*: the whole ``[S, T]`` batch lives on the device
  (``Engine.replay``);
* *streaming*: the cell replays through ``Engine.replay_stream`` in
  ``[S, chunk]`` slices: device memory is O(K + chunk), and file-backed
  traces (``trace="file(path=...)"``) are read off disk chunk by chunk
  (``data.ingest.iter_chunks``), never fully resident.

``run_sweep(stream="auto")`` picks streaming when a scenario is
file-backed or its ``T`` exceeds :data:`STREAM_THRESHOLD`
(:func:`should_stream`); ``stream=True`` / ``False`` forces a path.

The output is a list of flat, JSON-able records (one per cell, per-seed
metric lists) wrapped in a :class:`SweepResult` that renders the canonical
payload of :mod:`repro_torch.bench.results`.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..core import Engine
from ..core.policy import Request
from ..data import ingest
from . import report, results
from .scenario import FleetSweep, Sweep, TierSweep

__all__ = ["materialize", "run_sweep", "SweepResult", "run_tier_sweep",
           "TierSweepResult", "run_fleet_sweep", "FleetSweepResult",
           "should_stream", "stream_chunks", "STREAM_THRESHOLD"]

# per-lane trace length above which run_sweep(stream="auto") switches a
# synthetic scenario to the streaming path (file-backed scenarios always
# stream): past ~half a million requests the [S, T] device batch starts to
# dominate device memory
STREAM_THRESHOLD = 1 << 19


def _file_parts(spec):
    return spec.kwargs["path"], spec.kwargs.get("format", "auto")


def _tile(x, S):
    """Lay a per-request column out across S identical seed lanes."""
    return None if x is None else np.repeat(x[None], S, axis=0)


def materialize(scenario, seeds, device="cuda") -> Request:
    """Build the ``[S, T]`` request batch of one scenario on ``device``:
    traces from the registry (one lane per seed) with the scenario's
    size/cost tables gathered per request.  File-backed scenarios
    replicate the real trace across the seed lanes, sizes/costs sourced
    from the file.

    >>> from repro_torch.bench import Scenario
    >>> sc = Scenario("z", trace="zipf(N=64,alpha=1.0)", T=50, K=(8,))
    >>> tuple(materialize(sc, seeds=(0, 1), device="cpu").key.shape)
    (2, 50)
    """
    spec = scenario.trace_spec()
    if spec.is_file:
        path, fmt = _file_parts(spec)
        tr = ingest.load_trace(path, fmt, limit=scenario.T)
        S = len(tuple(seeds))
        return Request.of(_tile(tr.keys, S), sizes=_tile(tr.sizes, S),
                          costs=_tile(tr.costs, S), device=device)
    keys, sizes, costs = _synthetic_host(scenario, seeds)
    if sizes is None:
        return Request.of(keys, device=device)
    return Request.of(keys, sizes=sizes[keys],
                      costs=None if costs is None else costs[keys],
                      device=device)


def should_stream(scenario, stream="auto", *,
                  threshold: int = STREAM_THRESHOLD) -> bool:
    """Resolve the execution path for one scenario: ``True`` / ``False``
    pass through; ``"auto"`` streams file-backed scenarios and any whose
    ``T`` exceeds ``threshold``.  Anything else is an error.

    >>> from repro_torch.bench import Scenario
    >>> sc = Scenario("z", trace="zipf(N=64,alpha=1.0)", T=50, K=(8,))
    >>> should_stream(sc), should_stream(sc, True)
    (False, True)
    >>> should_stream(sc, threshold=10)
    True
    """
    if isinstance(stream, str) and stream == "auto":
        return scenario.trace_spec().is_file or scenario.T > threshold
    if not isinstance(stream, bool):
        raise ValueError(
            f"stream must be True, False or 'auto', got {stream!r}")
    return stream


def _synthetic_host(scenario, seeds):
    """Host-side ``([S, T] keys, size table, cost table)`` of a synthetic
    scenario: the arrays :func:`stream_chunks` slices."""
    keys = scenario.trace_spec().generate_batch(scenario.T, seeds)
    sizes = scenario.size_table()
    costs = None if sizes is None else scenario.cost_table(sizes)
    return keys, sizes, costs


def stream_chunks(scenario, seeds, chunk: int = ingest.DEFAULT_CHUNK,
                  _host=None, device="cuda"):
    """Yield the ``[S, c]`` :class:`Request` chunks of one scenario for
    ``Engine.replay_stream``: the requests :func:`materialize` builds,
    sliced into ``chunk``-request pieces on ``device``.  File-backed traces
    are read off disk chunk by chunk past :data:`STREAM_THRESHOLD`
    requests (below it, from the cached whole load) and replicated across
    the seed lanes; synthetic traces are generated on the host and sliced.

    >>> from repro_torch.bench import Scenario
    >>> sc = Scenario("z", trace="zipf(N=64,alpha=1.0)", T=50, K=(8,))
    >>> [tuple(c.key.shape) for c in stream_chunks(sc, seeds=(0, 1),
    ...                                            chunk=32, device="cpu")]
    [(2, 32), (2, 18)]
    """
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    spec = scenario.trace_spec()
    S = len(tuple(seeds))
    if spec.is_file:
        path, fmt = _file_parts(spec)
        if spec.n_requests <= STREAM_THRESHOLD:
            tr = ingest.load_trace(path, fmt, limit=scenario.T)
            parts = (tuple(None if x is None else x[lo:lo + chunk]
                           for x in (tr.keys, tr.sizes, tr.costs))
                     for lo in range(0, len(tr.keys), chunk))
        else:
            parts = ((ch.keys, ch.sizes, ch.costs) for ch in
                     ingest.iter_chunks(path, fmt, chunk=chunk,
                                        limit=scenario.T))
        for keys, sizes, costs in parts:
            yield Request.of(_tile(keys, S), sizes=_tile(sizes, S),
                             costs=_tile(costs, S), device=device)
        return
    keys, sizes, costs = (_synthetic_host(scenario, seeds) if _host is None
                          else _host)
    for lo in range(0, scenario.T, chunk):
        k = keys[:, lo:lo + chunk]
        yield Request.of(k, sizes=None if sizes is None else sizes[k],
                         costs=None if costs is None else costs[k],
                         device=device)


def _per_seed(x) -> list:
    return [float(v) for v in np.atleast_1d(np.asarray(x))]


def _avg_k(res, streamed: bool):
    """Per-seed time-mean adapted size, whichever path produced ``res``:
    the streaming path already carries time means in ``obs``; the
    materialized path stacks per-step observables to average."""
    if res.obs is None or "k" not in res.obs:
        return None
    k = res.obs["k"]
    k = (k.detach().cpu().numpy() if torch.is_tensor(k)
         else np.asarray(k)).astype(np.float64)
    return k if streamed else k.mean(axis=-1)


def _cell_record(pol, sc, K, k_label, seeds, res, wall_s,
                 avg_k=None) -> dict:
    metrics = {
        "miss_ratio": _per_seed(res.miss_ratio),
        "hit_ratio": _per_seed(res.hit_ratio),
        "byte_miss_ratio": _per_seed(res.byte_miss_ratio),
        "penalty_ratio": _per_seed(res.penalty_ratio),
    }
    if avg_k is not None:
        # adaptive policies: time-mean of the adapted cache size per seed
        metrics["avg_k"] = _per_seed(avg_k)
    return {
        "policy": pol, "scenario": sc.name, "trace": sc.trace,
        "T": int(sc.T), "K": int(K), "K_label": k_label,
        "seeds": [int(s) for s in seeds],
        "metrics": metrics, "wall_s": float(wall_s),
    }


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Executed sweep: the config that produced it, one record per cell,
    and the device the records were computed on."""

    sweep: Sweep
    records: list
    wall_s: float
    device: str = "cuda"

    def select(self, **eq) -> list:
        """Records whose fields equal every given keyword (e.g.
        ``select(policy="lru", scenario="wiki", K_label="S")``)."""
        return report.select(self.records, **eq)

    def metric(self, name: str, **eq) -> np.ndarray:
        """Per-seed values of one metric for the single matching record."""
        return report.seed_values(self.records, name, **eq)

    def payload(self, extras: dict | None = None, *,
                schema: str = results.SCHEMA_V1) -> dict:
        return results.build_payload(
            self.sweep.name, config=self.sweep.to_config(),
            records=self.records, extras=extras, wall_s=self.wall_s,
            schema=schema, device=self.device)

    def save(self, extras: dict | None = None, *,
             results_dir: str | None = None,
             schema: str = results.SCHEMA_V1) -> dict:
        """Validate + write the canonical payload; returns it."""
        payload = self.payload(extras, schema=schema)
        results.save(payload, results_dir=results_dir)
        return payload


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _shared_metrics(res) -> tuple:
    """The aggregate and per-lane metrics a tier record and a fleet record
    share, per seed."""
    avg_k = np.asarray(res.avg_k.cpu().numpy(), dtype=np.float64)
    agg = {
        "miss_ratio": _per_seed(res.agg_miss_ratio),
        "byte_miss_ratio": _per_seed(res.agg_byte_miss_ratio),
        "penalty_ratio": _per_seed(res.agg_penalty_ratio),
        "avg_k_total": _per_seed(avg_k.sum(axis=-1)),
    }
    per_lane = {
        "miss_ratio": np.atleast_2d(np.asarray(res.miss_ratio)),
        "byte_miss_ratio": np.atleast_2d(np.asarray(res.byte_miss_ratio)),
        "avg_k": np.atleast_2d(avg_k),
    }
    return agg, per_lane


def _multi_record(pol, arb, sc, B, label, seeds, wall_s, agg, per_lane,
                  n, axis) -> dict:
    """One v2 record: aggregate metrics plus a sub-record per tenant
    (``axis="tenant"``) or lane (``"lane"``)."""
    subs = [{axis: t, "metrics": {name: [float(v) for v in vals[:, t]]
                                  for name, vals in per_lane.items()}}
            for t in range(n)]
    return {
        "policy": pol, "arbiter": arb, "scenario": sc.name,
        "trace": sc.trace, "T": int(sc.T), "budget": int(B),
        "budget_label": label, f"n_{axis}s": n,
        "seeds": [int(s) for s in seeds],
        "metrics": agg, f"{axis}s": subs, "wall_s": float(wall_s),
    }


def _tier_cell_record(pol, arb, sc, B, label, seeds, res, wall_s) -> dict:
    """One v2 record: aggregate (byte- and cost-weighted) tier metrics plus
    a per-tenant sub-record list."""
    agg, per_tenant = _shared_metrics(res)
    return _multi_record(pol, arb, sc, B, label, seeds, wall_s, agg,
                         per_tenant, sc.n_tenants, "tenant")


def _fleet_cell_record(pol, arb, sc, B, label, seeds, res, wall_s) -> dict:
    """One v2 record: aggregate fleet metrics + SLO telemetry (penalty
    p50/p99, Jain occupancy fairness) plus a per-lane sub-record list."""
    agg, per_lane = _shared_metrics(res)
    agg.update(penalty_p50=_per_seed(res.agg_penalty_quantile(0.5)),
               penalty_p99=_per_seed(res.agg_penalty_quantile(0.99)),
               jain=_per_seed(res.jain))
    per_lane.update(
        alive_frac=np.atleast_2d(np.asarray(
            res.alive_frac.cpu().numpy(), dtype=np.float64)),
        penalty_p99=np.atleast_2d(res.penalty_quantile(0.99)),
        requests=np.atleast_2d(np.asarray(
            res.metrics.requests.cpu().numpy(), dtype=np.float64)))
    return _multi_record(pol, arb, sc, B, label, seeds, wall_s, agg,
                         per_lane, sc.n_lanes, "lane")


@dataclasses.dataclass(frozen=True)
class TierSweepResult:
    """Executed tier (or fleet) sweep: config + one v2 record per grid
    cell, and the device the records were computed on."""

    sweep: TierSweep
    records: list
    wall_s: float
    device: str = "cuda"

    def select(self, **eq) -> list:
        return report.select(self.records, **eq)

    def metric(self, name: str, **eq) -> np.ndarray:
        return report.seed_values(self.records, name, **eq)

    def payload(self, extras: dict | None = None) -> dict:
        return results.build_payload(
            self.sweep.name, config=self.sweep.to_config(),
            records=self.records, extras=extras, wall_s=self.wall_s,
            schema=results.SCHEMA_V2, device=self.device)

    def save(self, extras: dict | None = None, *,
             results_dir: str | None = None) -> dict:
        payload = self.payload(extras)
        results.save(payload, results_dir=results_dir)
        return payload


class FleetSweepResult(TierSweepResult):
    """Executed fleet sweep (``sweep`` a :class:`FleetSweep`)."""


def _run_cells(sweep, engine, build, replay, record, result_cls, progress):
    """Every (policy, arbiter, scenario, budget) cell of a tier or fleet
    sweep: one ``[S, T, N]`` batch per scenario (shared across entries
    and budgets), one replay per cell with the seeds as independent
    tiers; ``wall_s`` ends after ``torch.cuda.synchronize()`` on the
    card."""
    engine = engine or Engine()
    dev = engine.device
    t_start = time.perf_counter()
    records = []
    reqs_cache = {}
    for pol, arb, sc, B, label in sweep.cells():
        if sc.name not in reqs_cache:
            reqs_cache[sc.name] = materialize(sc, sweep.seeds, dev)
        t0 = time.perf_counter()
        res = getattr(engine, replay)(build(pol, arb, sc, B),
                                      reqs_cache[sc.name])
        _sync(dev)
        wall = time.perf_counter() - t0
        records.append(record(pol, arb, sc, B, label, sweep.seeds, res,
                              wall))
        if progress is not None:
            mr = np.mean(records[-1]["metrics"]["byte_miss_ratio"])
            progress(f"[{sweep.name}] {sc.name} B={B}({label}) "
                     f"{pol}+{arb}: byte_miss={mr:.3f} [{wall:.2f}s]")
    return result_cls(sweep=sweep, records=records,
                      wall_s=time.perf_counter() - t_start, device=str(dev))


def run_tier_sweep(sweep: TierSweep, *, engine: Engine | None = None,
                   progress=None) -> TierSweepResult:
    """Execute every tier cell on ``engine``'s device (default
    ``Engine()``, the card): one ``Engine.replay_tier`` call per (policy,
    arbiter, budget) cell, the seeds as independent tiers, emitting
    ``SCHEMA_V2`` records with per-tenant sub-records.

    >>> from repro_torch.bench import TierScenario, TierSweep
    >>> sw = TierSweep("doc", entries=(("dac", "greedy"),), seeds=(0,),
    ...                scenarios=(TierScenario(
    ...                    "flux", trace="tenants(N=64,n_tenants=2,lo=8)",
    ...                    T=300, budget=(32,)),))
    >>> rec = run_tier_sweep(sw, engine=Engine(device="cpu")).records[0]
    >>> rec["n_tenants"], len(rec["tenants"]), rec["budget"]
    (2, 2, 32)
    """
    from ..tier import CacheTier

    def build(pol, arb, sc, B):
        return CacheTier(pol, n_tenants=sc.n_tenants, budget=B,
                         arbiter=arb, k0=sc.k0)

    return _run_cells(sweep, engine, build, "replay_tier",
                      _tier_cell_record, TierSweepResult, progress)


def run_fleet_sweep(sweep: FleetSweep, *, engine: Engine | None = None,
                    progress=None) -> FleetSweepResult:
    """Execute every fleet cell on ``engine``'s device (default
    ``Engine()``, the card): one ``Engine.replay_fleet`` call per (policy,
    arbiter, budget) cell, the seeds as independent fleets, emitting
    ``SCHEMA_V2`` records with per-lane SLO telemetry.

    >>> from repro_torch.bench import FleetScenario, FleetSweep
    >>> sw = FleetSweep("doc", entries=(("dac(k_min=4)", "auction"),),
    ...                 seeds=(0,), scenarios=(FleetScenario(
    ...                     "pool", trace="fleet(N=64,n_lanes=2,rate=0.05,"
    ...                     "mean_session=100,lo=8)", T=300, budget=(32,)),))
    >>> rec = run_fleet_sweep(sw, engine=Engine(device="cpu")).records[0]
    >>> rec["n_lanes"], len(rec["lanes"]), rec["budget"]
    (2, 2, 32)
    >>> sorted(rec["metrics"])[:3]
    ['avg_k_total', 'byte_miss_ratio', 'jain']
    """
    from ..fleet import FleetTier

    def build(pol, arb, sc, B):
        return FleetTier(pol, n_lanes=sc.n_lanes, budget=B, arbiter=arb,
                         k0=sc.k0, util_decay=sc.util_decay)

    return _run_cells(sweep, engine, build, "replay_fleet",
                      _fleet_cell_record, FleetSweepResult, progress)


def run_sweep(sweep: Sweep, *, engine: Engine | None = None, mesh=None,
              stream="auto", chunk: int = ingest.DEFAULT_CHUNK,
              progress=None) -> SweepResult:
    """Execute every cell of ``sweep`` through ``engine`` (default
    ``Engine()``, on the card).

    Materialized cells share one ``[S, T]`` request batch per scenario
    across policies and capacities; each cell is one metrics-only replay.
    Streaming cells (``stream=True``, or ``"auto"`` for file-backed /
    over-:data:`STREAM_THRESHOLD` scenarios) replay the same requests
    through ``Engine.replay_stream`` in ``[S, chunk]`` slices instead.
    Both paths emit identical counts, ratios and time-mean observables;
    the float byte/cost totals agree bit for bit while their float32
    running sums are exact and to float32 rounding beyond that (the
    streaming path sums its chunks on the host in float64).  Each cell's
    ``wall_s`` ends after ``torch.cuda.synchronize()`` on the card.
    ``mesh`` applies to materialized cells only (streamed chunks run
    unsharded): under ``"auto"`` a mesh keeps synthetic cells on the
    sharded materialized path, and any cell that still streams
    (file-backed, or forced with ``stream=True``) warns that the mesh is
    not consulted.  ``progress`` (e.g. ``print``) receives a line per
    cell.

    >>> from repro_torch.bench import Scenario, Sweep
    >>> sw = Sweep("doc", policies=("lru",), seeds=(0,),
    ...            scenarios=(Scenario("z", trace="zipf(N=64,alpha=1.0)",
    ...                                T=200, K=(8,)),))
    >>> res = run_sweep(sw, engine=Engine(device="cpu"))
    >>> sorted(res.records[0]["metrics"])
    ['byte_miss_ratio', 'hit_ratio', 'miss_ratio', 'penalty_ratio']
    """
    engine = engine or Engine(mesh=mesh)
    have_mesh = mesh is not None or engine.mesh is not None
    dev = engine.device
    t_start = time.perf_counter()
    records = []
    reqs_cache = {}
    # single-entry host cache: cells() iterates scenario-major, so only
    # the current streamed scenario's [S, T] batch is ever held
    host_name, host_val = None, None
    for pol, sc, K, k_label in sweep.cells():
        streamed = should_stream(sc, stream)
        if streamed and have_mesh:
            if stream == "auto" and not sc.trace_spec().is_file:
                streamed = False    # a mesh-sharded materialized cell
                                    # beats an unsharded stream
            else:
                warnings.warn(
                    f"cell ({pol}, {sc.name}, K={K}) streams unsharded: "
                    "replay_stream does not consult mesh=", stacklevel=2)
        # one-time per-scenario host work (trace generation, request
        # materialization) stays outside the per-cell wall timer
        if streamed:
            host = None
            if not sc.trace_spec().is_file:
                if host_name != sc.name:
                    host_name = sc.name
                    host_val = _synthetic_host(sc, sweep.seeds)
                host = host_val
            t0 = time.perf_counter()
            res = engine.replay_stream(
                pol, stream_chunks(sc, sweep.seeds, chunk, _host=host,
                                   device=dev), K, observe=sweep.observe)
        else:
            if sc.name not in reqs_cache:
                reqs_cache[sc.name] = materialize(sc, sweep.seeds, dev)
            t0 = time.perf_counter()
            res = engine.replay(pol, reqs_cache[sc.name], K,
                                observe=sweep.observe, collect_info=False,
                                mesh=mesh)
            _sync(dev)
        wall = time.perf_counter() - t0
        records.append(_cell_record(pol, sc, K, k_label, sweep.seeds,
                                    res, wall, avg_k=_avg_k(res, streamed)))
        if progress is not None:
            mr = np.mean(records[-1]["metrics"]["miss_ratio"])
            progress(f"[{sweep.name}] {sc.name} K={K}({k_label}) "
                     f"{pol}{' [stream]' if streamed else ''}: "
                     f"miss={mr:.3f} [{wall:.2f}s]")
    return SweepResult(sweep=sweep, records=records,
                       wall_s=time.perf_counter() - t_start,
                       device=str(dev))
