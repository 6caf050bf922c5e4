"""Campaign orchestration: resumable, sharded, corpus-scale evaluation on
the card (the port of the reference's ``repro.campaign``).

The paper's headline result is a 1067-trace, 6-dataset grid; one
``run_sweep`` call cannot deliver that.  This package runs whole trace
*directories* through the port's Scenario/Sweep machinery, built to
survive the realities of corpus scale::

    from repro_torch.campaign import load_manifest, run_campaign
    from repro_torch.campaign import CampaignStore, render_report

    manifest = load_manifest("campaign.json")    # datasets x grid, as data
    run_campaign(manifest, "runs/corpus",        # resumable: reruns skip
                 workers=4, progress=print)      #   completed cells
    report = render_report(CampaignStore("runs/corpus"))

``run_campaign`` runs on the card (``device="cuda"``, the default) or,
with ``device="cpu"``, on the plain versions.  Four layers, each the
reference's module of the same name:

* :mod:`repro_torch.campaign.manifest` — the versioned
  ``repro.campaign.manifest/v1`` format: datasets as globs (or pinned
  lists with frozen :func:`repro_torch.data.ingest.characterize` stats,
  what ``python -m repro_torch.campaign.make_manifest`` emits) plus the
  policy x K x seed grid;
* :mod:`repro_torch.campaign.store` — one atomically-written,
  schema-validated ``repro.bench.result/v2`` file per ``(trace, policy,
  K, seed)`` cell, keyed by content hash (the reference's key for the
  same cell) and normalized to be bit-reproducible, so a killed worker
  never corrupts anything and a restart skips what's done;
* :mod:`repro_torch.campaign.executor` — shards pending cells across
  spawned worker processes (or ``--shard i/n`` across hosts), streams
  each cell through ``run_sweep(stream="auto")`` (kernel B1 on every
  rank-policy cell), quarantines failing traces with their traceback
  instead of dying, re-raises device faults, and tickers progress/ETA;
* :mod:`repro_torch.campaign.report` — hit-ratio CDFs, per-dataset
  winner tables and miss/byte/penalty reduction vs a baseline, rendered
  from the store without rerunning anything.

``python -m repro_torch.campaign`` is the CLI over all four (the
reference's ``benchmarks/campaign.py``, plus ``--device``).
"""
from .executor import (CampaignSummary, execute_cell, parse_shard,
                       pending_cells, plan_cells, run_campaign, shard_cells)
from .manifest import (MANIFEST_SCHEMA, Dataset, Grid, Manifest,
                       load_manifest, scan_corpus)
from .report import (REPORT_SCHEMA, campaign_records, complete_cells,
                     dataset_winners, format_report, hit_ratio_cdf,
                     mrr_vs_baseline, render_report)
from .store import Cell, CampaignStore, cell_key, deterministic_payload

__all__ = [
    "MANIFEST_SCHEMA", "Manifest", "Dataset", "Grid", "load_manifest",
    "scan_corpus",
    "Cell", "CampaignStore", "cell_key", "deterministic_payload",
    "plan_cells", "pending_cells", "shard_cells", "parse_shard",
    "execute_cell", "run_campaign", "CampaignSummary",
    "REPORT_SCHEMA", "campaign_records", "complete_cells",
    "dataset_winners", "mrr_vs_baseline", "hit_ratio_cdf",
    "render_report", "format_report",
]
