"""Campaign execution: shard pending cells across workers, resumably (the
port's copy of the reference's ``campaign/executor.py``).

The executor turns a :class:`repro_torch.campaign.Manifest` into the flat,
deterministically-ordered cell list (:func:`plan_cells`), drops every
cell whose key already sits in the store (completed *or* quarantined —
that is the whole resume protocol), optionally takes a ``--shard i/n``
slice for multi-host launches, and runs the remainder either inline or
across a ``ProcessPoolExecutor`` (spawn context: each worker has its own
CUDA context, builds its own :class:`repro_torch.core.Engine` from the
device string and loads kernel B1's library itself).

Each cell executes as a single-cell :class:`repro_torch.bench.Sweep`
through ``run_sweep(stream="auto")``, so out-of-core traces stream off
disk exactly as they do everywhere else (on the card, one B1 launch per
``ingest.DEFAULT_CHUNK`` requests of a rank-policy cell), and the
resulting ``repro.bench.result/v2`` payload is validated and atomically
written by the store.  Wall-times and a progress/ETA ticker flow through
the store journal and the ``progress`` callback.

Where the port differs from the reference:

* there is no ``use_pallas``: the engine's device decides.
  :func:`execute_cell` and :func:`run_campaign` take ``device="cuda"``
  (the card, like every entry point of the port; ``"cpu"`` runs the
  plain versions), and each spawned worker gets the device's name;
* a failing trace **quarantines** the cell with its traceback instead of
  killing the campaign, as in the reference (ingest, parse and spec
  errors), but a device fault (:func:`is_device_fault`: a kernel's failed
  build, load or launch, or torch's CUDA and accelerator errors) is
  re-raised out of :func:`run_campaign` and never quarantined: CUDA errors
  are sticky, so quarantining one would blame the trace and then every
  later cell of that process.

>>> m = Manifest(name="d", root="corpus",
...              grid=Grid(policies=("lru", "dac"), K=(8,), seeds=(0,)),
...              datasets=(Dataset(name="a", traces=(("t.csv", "auto"),)),))
>>> [(c.policy, c.K) for c in plan_cells(m)]
[('lru', 8), ('dac', 8)]
"""
from __future__ import annotations

import dataclasses
import os
import time
import traceback

import torch

from ..bench import Scenario, Sweep, results, run_sweep
from ..core import Engine
from ..data import ingest
from ..kernels import _build
from .manifest import Dataset, Grid, Manifest  # noqa: F401  (doctest surface)
from .store import CampaignStore, Cell, cell_key

__all__ = ["plan_cells", "pending_cells", "shard_cells", "parse_shard",
           "execute_cell", "run_campaign", "CampaignSummary",
           "is_device_fault"]


def plan_cells(manifest: Manifest) -> list:
    """The campaign's full cell list — every matched trace x the grid —
    in deterministic (dataset, trace, policy, K, seed) order.  Shard
    slices and resume sets are carved out of this one ordering, so every
    worker and every restart agrees on what cell an index means."""
    grid = manifest.grid
    return [Cell(dataset=ds, trace=path, format=fmt, policy=pol, K=K,
                 seed=seed, T=grid.T)
            for ds, path, fmt in manifest.traces()
            for pol in grid.policies
            for K in grid.K
            for seed in grid.seeds]


def pending_cells(cells, store: CampaignStore) -> list:
    """Cells with no completed *and* no quarantined record — exactly what
    a (re)started campaign still has to run."""
    return [c for c in cells
            if not store.has(cell_key(c))
            and not os.path.exists(os.path.join(
                store.quarantine_dir, f"{cell_key(c)}.json"))]


def parse_shard(shard) -> tuple | None:
    """Normalize a shard designator: ``None``, an ``(i, n)`` pair, or the
    CLI string ``"i/n"`` with ``0 <= i < n``.

    >>> parse_shard("1/4"), parse_shard(None), parse_shard((0, 2))
    ((1, 4), None, (0, 2))
    """
    if shard is None:
        return None
    if isinstance(shard, str):
        try:
            i, n = (int(x) for x in shard.split("/"))
        except ValueError:
            raise ValueError(
                f"shard must look like 'i/n' (e.g. '0/4'), got {shard!r}")
    else:
        i, n = (int(x) for x in shard)
    if not 0 <= i < n:
        raise ValueError(f"shard index must satisfy 0 <= i < n, "
                         f"got {i}/{n}")
    return i, n


def shard_cells(cells, shard) -> list:
    """Deterministic ``i``-th of ``n`` slices of the *full* cell list
    (round-robin by plan index) — stable across restarts even as cells
    complete, so multi-host shards never overlap.

    >>> shard_cells([10, 11, 12, 13, 14], "1/2")
    [11, 13]
    """
    parsed = parse_shard(shard)
    if parsed is None:
        return list(cells)
    i, n = parsed
    return list(cells)[i::n]


def is_device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a fault of the device rather than of the cell's
    trace: a kernel's failed build, load or launch
    (:class:`repro_torch.kernels._build.KernelError`, what
    ``_build.check`` raises), torch's accelerator and CUDA out-of-memory
    errors, or any other ``RuntimeError`` that names CUDA.  A cell never
    quarantines one of these.

    >>> is_device_fault(_build.KernelError("policy_replay: CUDA error 700"))
    True
    >>> is_device_fault(ValueError("size is not a multiple of 24"))
    False
    """
    if isinstance(exc, (_build.KernelError, torch.AcceleratorError,
                        torch.cuda.OutOfMemoryError)):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)


def _cell_payload(cell: Cell, engine: Engine, *, chunk=None) -> dict:
    """Run one cell through the Scenario/Sweep machinery on ``engine`` and
    return its v2 payload (the store normalizes the volatile timing
    fields)."""
    n = ingest.count_requests(cell.trace, cell.format)
    T = min(cell.T, n) if cell.T else n
    fmt_arg = "" if cell.format == "auto" else f",format={cell.format}"
    scenario = Scenario(
        f"{cell.dataset}/{os.path.basename(cell.trace)}",
        trace=f"file(path={cell.trace}{fmt_arg})", T=T, K=(cell.K,))
    sweep = Sweep(f"cell-{cell_key(cell)}", policies=(cell.policy,),
                  scenarios=(scenario,), seeds=(cell.seed,), observe=True)
    kw = {} if chunk is None else {"chunk": chunk}
    res = run_sweep(sweep, engine=engine, stream="auto", **kw)
    stats = dataclasses.asdict(ingest.characterize(cell.trace, cell.format))
    return res.payload(
        extras={"campaign": {"key": cell_key(cell),
                             "cell": cell.to_dict(),
                             "trace_stats": stats}},
        schema=results.SCHEMA_V2)


def execute_cell(cell: Cell, store: CampaignStore, *, chunk=None,
                 device="cuda") -> tuple:
    """Execute one cell against the store on ``device``: completed cells
    land in ``cells/``, failing traces in ``quarantine/`` with their
    traceback.  Returns ``(key, status, wall_s, error)`` with status
    ``"done"`` or ``"failed"``; a device fault (:func:`is_device_fault`)
    raises instead."""
    key = cell_key(cell)
    engine = Engine(device)
    t0 = time.perf_counter()
    try:
        payload = _cell_payload(cell, engine, chunk=chunk)
        store.put(key, payload)
        return key, "done", time.perf_counter() - t0, None
    except Exception as exc:
        if is_device_fault(exc):
            raise
        tb = traceback.format_exc()
        store.quarantine(key, cell, tb)
        return key, "failed", time.perf_counter() - t0, tb


def _pool_worker(cell_cfg: dict, store_root: str, chunk, device: str):
    """Top-level (picklable) worker body for ProcessPoolExecutor.  A
    worker on the CPU runs torch on one thread, the pool being the
    parallelism."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    cell = Cell.from_dict(cell_cfg)
    return execute_cell(cell, CampaignStore(store_root), chunk=chunk,
                        device=device)


@dataclasses.dataclass(frozen=True)
class CampaignSummary:
    """What one ``run_campaign`` invocation did: the planned/sharded cell
    count, how many were already in the store, and the keys executed or
    quarantined this run."""

    total: int                  # cells in this invocation's (sharded) plan
    skipped: int                # already completed or quarantined on entry
    executed: tuple             # keys completed this run, in finish order
    quarantined: tuple          # keys quarantined this run
    remaining: int              # pending cells left (cell budget exhausted)
    wall_s: float

    @property
    def counts(self) -> dict:
        return {"total": self.total, "skipped": self.skipped,
                "executed": len(self.executed),
                "quarantined": len(self.quarantined),
                "remaining": self.remaining}


def _eta(done: int, todo: int, elapsed: float) -> str:
    if not done:
        return "?"
    return f"{elapsed / done * (todo - done):.0f}s"


def run_campaign(manifest: Manifest, store, *, workers: int = 0,
                 shard=None, max_cells: int | None = None,
                 chunk: int | None = None, device="cuda",
                 progress=None) -> CampaignSummary:
    """Run (or resume) a campaign: plan -> shard -> skip stored cells ->
    execute the rest, atomically recording each one.

    Cells run on ``device`` (the card unless ``device="cpu"``).
    ``workers <= 1`` runs inline (one process, the kernels' libraries
    loaded once for all cells); ``workers > 1`` fans cells out over a
    spawn-context process pool, each worker on the same device.  ``shard="i/n"`` takes the i-th
    round-robin slice of the full plan for multi-host launches — every
    host runs the same command with a different ``i``.  ``max_cells``
    bounds how many cells *execute* this invocation (the crash-simulation
    / smoke-test budget hook); skipped cells are free.  ``progress``
    (e.g. ``print``) receives one ticker line per cell with a running
    ETA.  A device fault in any cell (:func:`is_device_fault`) cancels the
    cells not started and raises; nothing is quarantined for it.
    """
    store = store if isinstance(store, CampaignStore) \
        else CampaignStore(store)
    device = str(Engine(device).device)      # no card: raise before a cell
    store.init_manifest(manifest)
    cells = shard_cells(plan_cells(manifest), shard)
    pending = pending_cells(cells, store)
    if max_cells is not None:
        if max_cells < 0:
            raise ValueError(f"max_cells must be >= 0, got {max_cells}")
        budget = pending[:max_cells]
    else:
        budget = pending
    skipped = len(cells) - len(pending)
    store.journal(event="start", name=manifest.name, shard=shard,
                  workers=workers, planned=len(cells), skipped=skipped,
                  pending=len(pending), budget=len(budget))
    t0 = time.perf_counter()
    executed, quarantined = [], []

    def record(key, status, wall, cell):
        elapsed = time.perf_counter() - t0
        (executed if status == "done" else quarantined).append(key)
        done = len(executed) + len(quarantined)
        store.journal(event=status, key=key, wall_s=wall,
                      trace=cell.trace, policy=cell.policy,
                      K=cell.K, seed=cell.seed)
        if progress is not None:
            progress(
                f"[{manifest.name}] {done}/{len(budget)} "
                f"{cell.dataset}/{os.path.basename(cell.trace)} "
                f"{cell.policy} K={cell.K} s{cell.seed}: {status} "
                f"[{wall:.1f}s, ETA {_eta(done, len(budget), elapsed)}]")

    if workers and workers > 1 and len(budget) > 1:
        import concurrent.futures as cf
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=workers,
                                    mp_context=ctx) as pool:
            futs = {pool.submit(_pool_worker, c.to_dict(), store.root,
                                chunk, device): c
                    for c in budget}
            try:
                for fut in cf.as_completed(futs):
                    key, status, wall, _ = fut.result()
                    record(key, status, wall, futs[fut])
            except BaseException:
                for fut in futs:
                    fut.cancel()
                raise
    else:
        for cell in budget:
            key, status, wall, _ = execute_cell(
                cell, store, chunk=chunk, device=device)
            record(key, status, wall, cell)

    wall = time.perf_counter() - t0
    summary = CampaignSummary(
        total=len(cells), skipped=skipped, executed=tuple(executed),
        quarantined=tuple(quarantined),
        remaining=len(pending) - len(budget), wall_s=wall)
    store.journal(event="stop", wall_s=wall, **summary.counts)
    return summary
