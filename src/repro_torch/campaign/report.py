"""Aggregate campaign reports, rendered from the store alone (the port's
copy of the reference's ``campaign/report.py``, on the port's
``bench/report.py``; the same report, key for key).

Everything here is a pure function over the completed cell payloads in a
:class:`repro_torch.campaign.CampaignStore` — nothing reruns.  The shapes
are the paper's: hit-ratio CDFs across traces
(:func:`repro_torch.bench.report.metric_cdf`), per-dataset winner tables
with deterministic ties and margins
(:func:`repro_torch.bench.report.winners`), and mean miss/byte-miss/penalty
reduction vs a baseline policy (the 29%-over-FIFO headline shape,
byte-weighted variants included).

Campaign cells may be *incomplete* — a quarantined trace, a policy added
to the grid mid-campaign — so every cross-policy table first restricts
itself to cells where **all** compared policies have a record
(:func:`complete_cells`); partial coverage shrinks a table instead of
crashing it, and the dropped-cell count is surfaced in the report.

>>> recs = [
...     {"policy": p, "scenario": "d/a.csv", "K_label": "S", "seeds": [0],
...      "dataset": "d", "metrics": {"miss_ratio": [m], "hit_ratio": [1 - m],
...                                  "byte_miss_ratio": [m],
...                                  "penalty_ratio": [m]}}
...     for p, m in [("fifo", 0.5), ("lru", 0.25)]]
>>> dataset_winners(recs)["d"]["winner"]
'lru'
>>> mrr_vs_baseline(recs, baseline="fifo")["d"]["lru"]
0.5
"""
from __future__ import annotations

import numpy as np

from ..bench import report as bench_report

__all__ = ["campaign_records", "complete_cells", "dataset_winners",
           "mrr_vs_baseline", "hit_ratio_cdf", "render_report",
           "format_report", "REPORT_SCHEMA"]

REPORT_SCHEMA = "repro.campaign.report/v1"


def campaign_records(store) -> list:
    """Flatten a store into one record list, each record annotated with
    its ``dataset`` and ``cell_key`` (from the payload's campaign
    extras) so the grouping the manifest declared survives into the
    tables."""
    out = []
    for key, payload in store.payloads():
        camp = payload.get("extras", {}).get("campaign", {})
        ds = camp.get("cell", {}).get("dataset", "?")
        for rec in payload["records"]:
            out.append(dict(rec, dataset=ds, cell_key=key))
    return out


def _policies(records, policies=None) -> list:
    return (list(policies) if policies
            else sorted({r["policy"] for r in records}))


def complete_cells(records, policies) -> tuple:
    """Split records into (kept, n_dropped_cells): only cells — distinct
    ``(scenario, K_label)`` pairs — where every compared policy has a
    record survive into cross-policy tables.

    >>> recs = [{"policy": "lru", "scenario": "t", "K_label": "S",
    ...          "metrics": {"miss_ratio": [0.1]}}]
    >>> complete_cells(recs, ["lru", "fifo"])
    ([], 1)
    """
    have: dict = {}
    for r in records:
        have.setdefault((r["scenario"], r["K_label"]), set()).add(r["policy"])
    ok = {c for c, pols in have.items() if set(policies) <= pols}
    kept = [r for r in records
            if (r["scenario"], r["K_label"]) in ok
            and r["policy"] in policies]
    return kept, len(have) - len(ok)


def dataset_winners(records, policies=None,
                    metric: str = "miss_ratio") -> dict:
    """The per-dataset winner table: for each dataset, every policy's
    fraction of (trace, K) cells won (deterministic lexicographic ties),
    the overall winner, and the mean winning margin.  ``per_cell`` keeps
    the raw cell-level verdicts for drill-down."""
    out = {}
    for ds in sorted({r["dataset"] for r in records}):
        recs = [r for r in records if r["dataset"] == ds]
        pols = _policies(recs, policies)
        kept, dropped = complete_cells(recs, pols)
        if not kept:
            continue
        per_cell = bench_report.winners(kept, pols, metric, margin=True)
        n = len(per_cell)
        wins = {p: 0.0 for p in pols}
        for cell in per_cell.values():
            for p, frac in cell["winners"].items():
                wins[p] += frac / n
        winner = max(sorted(wins), key=lambda p: wins[p])
        out[ds] = {
            "cells": n, "dropped": dropped,
            "wins": {p: round(f, 6) for p, f in sorted(wins.items())},
            "winner": winner,
            "margin": float(np.mean([c["margin"]
                                     for c in per_cell.values()])),
            "per_cell": per_cell,
        }
    return out


def mrr_vs_baseline(records, policies=None, baseline: str = "fifo",
                    metric: str = "miss_ratio") -> dict:
    """Per dataset, each policy's metric reduction vs ``baseline``
    averaged over that dataset's complete cells — the paper's
    "29% hit-ratio gain over FIFO" aggregate, for any ratio metric
    (``byte_miss_ratio`` and ``penalty_ratio`` give the byte- and
    miss-penalty-weighted variants).  Datasets with no baseline cells are
    skipped."""
    out = {}
    for ds in sorted({r["dataset"] for r in records}):
        recs = [r for r in records if r["dataset"] == ds]
        pols = _policies(recs, policies)
        if baseline not in pols:
            pols = pols + [baseline]
        kept, _ = complete_cells(recs, pols)
        if not kept:
            continue
        matrix = bench_report.mrr_matrix(kept, pols, baseline=baseline,
                                         metric=metric)
        col = {}
        for p in pols:
            col[p] = float(np.mean([cell[p] for cell in matrix.values()]))
        out[ds] = col
    return out


def hit_ratio_cdf(records, policies=None) -> dict:
    """Per-policy hit-ratio CDF across every completed campaign cell —
    the across-traces distribution figure."""
    pols = _policies(records, policies)
    kept, _ = complete_cells(records, pols)
    return bench_report.metric_cdf(kept, pols, "hit_ratio") if kept else {}


def render_report(store, *, baseline: str = "fifo",
                  policies=None) -> dict:
    """The full campaign report as one JSON-able dict, from the store
    alone: coverage counts, per-dataset winner tables (request- and
    byte-weighted), the hit-ratio CDF, and miss / byte-miss / miss-
    penalty reduction vs ``baseline``."""
    records = campaign_records(store)
    pols = _policies(records, policies)
    quarantined = store.quarantined()
    report = {
        "schema": REPORT_SCHEMA,
        "campaign": _campaign_name(store),
        "n_cells": len(store.completed()),
        "n_quarantined": len(quarantined),
        "quarantined": quarantined,
        "policies": pols,
        "datasets": sorted({r["dataset"] for r in records}),
        "winners": dataset_winners(records, pols),
        "winners_bytes": dataset_winners(records, pols,
                                         metric="byte_miss_ratio"),
        "hit_ratio_cdf": hit_ratio_cdf(records, pols),
    }
    if baseline in pols:
        report["baseline"] = baseline
        for name, metric in (("mrr", "miss_ratio"),
                             ("byte_mrr", "byte_miss_ratio"),
                             ("penalty_reduction", "penalty_ratio")):
            report[f"{name}_vs_{baseline}"] = mrr_vs_baseline(
                records, pols, baseline=baseline, metric=metric)
    return report


def _campaign_name(store) -> str:
    try:
        return store.manifest_dict().get("name", "?")
    except OSError:
        return "?"


def format_report(report: dict) -> str:
    """Human-readable rendering of :func:`render_report`'s dict — the
    ``python -m repro_torch.campaign --report`` console output."""
    lines = [f"campaign {report['campaign']}: "
             f"{report['n_cells']} cells, "
             f"{report['n_quarantined']} quarantined"]
    pols = report["policies"]
    for title, key in (("winners (miss ratio)", "winners"),
                       ("winners (byte-weighted)", "winners_bytes")):
        table = report.get(key) or {}
        if not table:
            continue
        lines.append(f"\n{title}:")
        lines.append(bench_report.fmt_row(
            ["dataset"] + pols + ["winner", "margin"],
            [16] + [10] * len(pols) + [14, 8]))
        for ds, row in table.items():
            lines.append(bench_report.fmt_row(
                [ds] + [f"{row['wins'].get(p, 0.0):.2f}" for p in pols]
                + [row["winner"], f"{row['margin']:.4f}"],
                [16] + [10] * len(pols) + [14, 8]))
    baseline = report.get("baseline")
    if baseline:
        for title, key in (
                ("mean MRR", f"mrr_vs_{baseline}"),
                ("mean byte-MRR", f"byte_mrr_vs_{baseline}"),
                ("mean penalty reduction", f"penalty_reduction_vs_{baseline}")):
            table = report.get(key) or {}
            if not table:
                continue
            lines.append(f"\n{title} vs {baseline}:")
            lines.append(bench_report.fmt_row(
                ["dataset"] + pols, [16] + [12] * len(pols)))
            for ds, col in table.items():
                lines.append(bench_report.fmt_row(
                    [ds] + [f"{col.get(p, float('nan')):+.4f}"
                            for p in pols],
                    [16] + [12] * len(pols)))
    cdf = report.get("hit_ratio_cdf") or {}
    if cdf:
        lines.append("\nhit-ratio across cells (min / median / max):")
        for p in pols:
            vals = cdf.get(p, {}).get("values", [])
            if vals:
                lines.append(f"  {p:24s} {min(vals):.3f} / "
                             f"{float(np.median(vals)):.3f} / "
                             f"{max(vals):.3f}  ({len(vals)} cells)")
    return "\n".join(lines)
