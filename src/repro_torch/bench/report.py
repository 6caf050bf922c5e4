"""Render the paper's tables from canonical sweep records (the port's copy
of the reference's ``bench/report.py``, on the port's ``mrr``).

Pure functions over the record lists emitted by
:mod:`repro_torch.bench.runner` (or reloaded from result JSONs): the
MRR-vs-FIFO matrix (Table III), the per-cell winner fractions (Fig. 6),
and generic metric pivots, so the table logic lives once.
"""
from __future__ import annotations

import numpy as np

from ..core import mrr

__all__ = ["select", "seed_values", "cell_label", "pivot",
           "mrr_matrix", "winners", "metric_cdf", "robustness_frontier",
           "fmt_row", "print_table",
           "tier_mrr_matrix", "tier_winners", "tenant_occupancy"]


def select(records, **eq):
    """Records whose fields equal every keyword.

    >>> recs = [{"policy": "lru", "K": 8}, {"policy": "dac", "K": 8}]
    >>> select(recs, policy="dac")
    [{'policy': 'dac', 'K': 8}]
    """
    return [r for r in records if all(r.get(k) == v for k, v in eq.items())]


def seed_values(records, metric: str, **eq) -> np.ndarray:
    """Per-seed values of one metric for the single matching record.

    >>> recs = [{"policy": "lru", "metrics": {"miss_ratio": [0.2, 0.3]}}]
    >>> seed_values(recs, "miss_ratio", policy="lru").tolist()
    [0.2, 0.3]
    """
    recs = select(records, **eq)
    if len(recs) != 1:
        raise KeyError(f"{len(recs)} records match {eq} (need exactly 1)")
    return np.atleast_1d(np.asarray(recs[0]["metrics"][metric]))


def cell_label(rec) -> str:
    """Column label for one (scenario, K) cell: ``wiki(S)`` / ``zipf(256)``.

    >>> cell_label({"scenario": "wiki", "K_label": "S"})
    'wiki(S)'
    """
    return f"{rec['scenario']}({rec['K_label']})"


def _cells(records, key_field: str = "K_label"):
    """Distinct (scenario, <key_field>) cells in first-appearance order."""
    seen = []
    for r in records:
        key = (r["scenario"], r[key_field])
        if key not in seen:
            seen.append(key)
    return seen


# The v1 (policy-keyed) and tier (entry-keyed) views share one
# aggregation core, parameterized by the cell key field, the per-row
# seed-value selector, and the row label.

def _mrr_over_cells(records, rows, baseline, metric, key_field, values,
                    label) -> dict:
    out = {}
    for scenario, cell in _cells(records, key_field):
        base = values(records, metric, baseline, scenario, cell)
        col = {}
        for row in rows:
            vals = values(records, metric, row, scenario, cell)
            col[label(row)] = float(np.mean(
                [mrr(float(m), float(f)) for m, f in zip(vals, base)]))
        out[f"{scenario}({cell})"] = col
    return out


def _winners_over_cells(records, rows, metric, key_field, values,
                        label, margin=False) -> dict:
    out = {}
    for scenario, cell in _cells(records, key_field):
        labels = [label(row) for row in rows]
        stack = np.stack([values(records, metric, row, scenario, cell)
                          for row in rows])
        best_val = stack.min(axis=0)
        # ties break deterministically: the lexicographically smallest
        # label among the tied rows wins, independent of caller ordering
        by_label = sorted(range(len(rows)), key=lambda i: labels[i])
        counts: dict = {}
        for s in range(stack.shape[1]):
            w = next(labels[i] for i in by_label
                     if stack[i, s] == best_val[s])
            counts[w] = counts.get(w, 0) + 1
        frac = {w: counts[w] / stack.shape[1] for w in sorted(counts)}
        if not margin:
            out[f"{scenario}({cell})"] = frac
            continue
        # margin: runner-up minus winner metric per seed, averaged — how
        # much the win is worth (0.0 on exact ties or a single row)
        if len(rows) > 1:
            part = np.partition(stack, 1, axis=0)
            marg = float((part[1] - part[0]).mean())
        else:
            marg = 0.0
        out[f"{scenario}({cell})"] = {"winners": frac, "margin": marg}
    return out


def _policy_values(records, metric, pol, scenario, k_label):
    return seed_values(records, metric, policy=pol, scenario=scenario,
                       K_label=k_label)


def pivot(records, metric: str, policies, reduce=np.mean) -> dict:
    """``{cell_label: {policy: reduced metric}}`` over all cells.

    >>> recs = [{"policy": "lru", "scenario": "z", "K_label": "8",
    ...          "metrics": {"miss_ratio": [0.25, 0.75]}}]
    >>> pivot(recs, "miss_ratio", ["lru"])
    {'z(8)': {'lru': 0.5}}
    """
    out = {}
    for scenario, k_label in _cells(records):
        col = {}
        for pol in policies:
            vals = seed_values(records, metric, policy=pol,
                               scenario=scenario, K_label=k_label)
            col[pol] = float(reduce(vals))
        out[f"{scenario}({k_label})"] = col
    return out


def mrr_matrix(records, policies, baseline: str = "fifo",
               metric: str = "miss_ratio") -> dict:
    """Table III: per cell, each policy's mean miss-ratio reduction vs the
    baseline, the reduction computed per seed then averaged (paper's
    signed MRR definition).

    >>> recs = [{"policy": p, "scenario": "z", "K_label": "8",
    ...          "metrics": {"miss_ratio": [m]}}
    ...         for p, m in [("fifo", 0.4), ("dac", 0.2)]]
    >>> mrr_matrix(recs, ["dac"])
    {'z(8)': {'dac': 0.5}}
    """
    return _mrr_over_cells(records, policies, baseline, metric,
                           "K_label", _policy_values, lambda p: p)


def winners(records, policies, metric: str = "miss_ratio", *,
            margin: bool = False) -> dict:
    """Fig. 6: per cell, the fraction of seeds on which each policy attains
    the lowest metric (only winning policies appear).  Exact ties go to
    the lexicographically smallest policy id — winner tables are stable
    across runs and caller orderings — and ``margin=True`` additionally
    reports how far the runner-up trailed (seed-mean metric gap), so a
    "win" by 0.000 is visible as one.

    >>> recs = [{"policy": p, "scenario": "z", "K_label": "8",
    ...          "metrics": {"miss_ratio": [m, m]}}
    ...         for p, m in [("lru", 0.4), ("dac", 0.2)]]
    >>> winners(recs, ["lru", "dac"])
    {'z(8)': {'dac': 1.0}}
    >>> winners(recs, ["lru", "dac"], margin=True)
    {'z(8)': {'winners': {'dac': 1.0}, 'margin': 0.2}}
    >>> tied = [{"policy": p, "scenario": "z", "K_label": "8",
    ...          "metrics": {"miss_ratio": [0.3]}} for p in ("lru", "arc")]
    >>> winners(tied, ["lru", "arc"])     # tie -> lexicographic, not order
    {'z(8)': {'arc': 1.0}}
    """
    return _winners_over_cells(records, policies, metric, "K_label",
                               _policy_values, lambda p: p, margin=margin)


def metric_cdf(records, policies, metric: str = "hit_ratio") -> dict:
    """Per-policy empirical CDF of the seed-mean metric across every
    (scenario, K) cell — the paper's hit-ratio-CDF-across-traces figure
    shape.  ``values`` are sorted ascending; ``cdf[i]`` is the fraction
    of cells at or below ``values[i]``.

    >>> recs = [{"policy": "lru", "scenario": s, "K_label": "8",
    ...          "metrics": {"hit_ratio": [v]}}
    ...         for s, v in [("a", 0.8), ("b", 0.4)]]
    >>> metric_cdf(recs, ["lru"])
    {'lru': {'values': [0.4, 0.8], 'cdf': [0.5, 1.0]}}
    """
    out = {}
    for pol in policies:
        recs = select(records, policy=pol)
        vals = sorted(
            float(np.mean(seed_values(recs, metric, scenario=sc,
                                      K_label=kl)))
            for sc, kl in _cells(recs))
        n = len(vals)
        out[pol] = {"values": vals,
                    "cdf": [(i + 1) / n for i in range(n)]}
    return out


def robustness_frontier(records, policies, baseline: str = "fifo",
                        metric: str = "byte_miss_ratio") -> dict:
    """Worst-case vs mean MRR frontier: per policy, the seed-mean MRR vs
    ``baseline`` in every (scenario, K) cell, reduced to its minimum
    (the adversarial worst case — the number the robustness claim rides
    on) and its mean.  A policy's worst cell is named so the table says
    *where* it breaks; exact worst-case ties resolve to the
    lexicographically smallest cell label, stable across runs.

    Partial grids are first-class: a cell missing either the policy's or
    the baseline's record is skipped and *counted* in ``dropped`` — a
    shrunken table always says how much of the grid it actually covers.
    A policy with no covered cell reports ``worst``/``mean``/
    ``worst_cell`` of ``None`` rather than vanishing silently.

    >>> recs = [{"policy": p, "scenario": s, "K_label": "8",
    ...          "metrics": {"byte_miss_ratio": [m]}}
    ...         for p, s, m in [("fifo", "flood", 0.8), ("fifo", "scan", 0.5),
    ...                         ("dac", "flood", 0.4), ("dac", "scan", 0.5),
    ...                         ("lru", "flood", 0.6)]]
    >>> f = robustness_frontier(recs, ["dac", "lru"])
    >>> f["dac"]["worst"], f["dac"]["worst_cell"], f["dac"]["dropped"]
    (0.0, 'scan(8)', 0)
    >>> f["lru"]["cells"], f["lru"]["dropped"]     # scan cell has no record
    (1, 1)
    """
    cells = _cells(records)
    out = {}
    for pol in policies:
        per_cell, dropped = {}, 0
        for scenario, kl in cells:
            try:
                base = seed_values(records, metric, policy=baseline,
                                   scenario=scenario, K_label=kl)
                vals = seed_values(records, metric, policy=pol,
                                   scenario=scenario, K_label=kl)
            except KeyError:
                dropped += 1
                continue
            per_cell[f"{scenario}({kl})"] = float(np.mean(
                [mrr(float(m), float(f)) for m, f in zip(vals, base)]))
        worst_cell = (min(sorted(per_cell), key=per_cell.get)
                      if per_cell else None)
        out[pol] = {
            "worst": per_cell[worst_cell] if per_cell else None,
            "worst_cell": worst_cell,
            "mean": float(np.mean(list(per_cell.values())))
            if per_cell else None,
            "cells": len(per_cell),
            "dropped": dropped,
            "per_cell": per_cell,
        }
    return out


# --- tier (v2) views -------------------------------------------------------
# Tier records are keyed by (policy, arbiter) entries instead of a bare
# policy; rows are labelled "policy+arbiter" and cells are (scenario,
# budget_label) pairs.

def _tier_label(entry) -> str:
    return "+".join(entry)


def _entry_values(records, metric, entry, scenario, budget_label):
    pol, arb = entry
    return seed_values(records, metric, policy=pol, arbiter=arb,
                       scenario=scenario, budget_label=budget_label)


def tier_mrr_matrix(records, entries, baseline=("fifo", "static"),
                    metric: str = "byte_miss_ratio") -> dict:
    """Aggregate miss-ratio reduction of each (policy, arbiter) entry vs
    the baseline entry, per tier cell — the byte-weighted default makes
    it the tier analogue of the paper's Table III, computed per seed then
    averaged.

    >>> recs = [{"policy": p, "arbiter": a, "scenario": "flux",
    ...          "budget_label": "512", "seeds": [0],
    ...          "metrics": {"byte_miss_ratio": [m]}}
    ...         for p, a, m in [("fifo", "static", 0.5),
    ...                         ("dac", "greedy", 0.25)]]
    >>> tier_mrr_matrix(recs, [("dac", "greedy")])
    {'flux(512)': {'dac+greedy': 0.5}}
    """
    return _mrr_over_cells(records, entries, baseline, metric,
                           "budget_label", _entry_values, _tier_label)


def tier_winners(records, entries, metric: str = "byte_miss_ratio", *,
                 margin: bool = False) -> dict:
    """Per tier cell, the fraction of seeds on which each (policy,
    arbiter) entry attains the lowest aggregate metric — same tie-break
    and ``margin=`` semantics as :func:`winners`."""
    return _winners_over_cells(records, entries, metric, "budget_label",
                               _entry_values, _tier_label, margin=margin)


def occupancy_timeline(ks, windows: int = 8) -> list:
    """Downsample a per-step occupancy trace ``[T, N]`` (from
    ``replay_tier(..., observe=True)``) into ``windows`` rows of
    per-tenant mean active size — the occupancy-over-time table for one
    tier replay.

    >>> import numpy as np
    >>> ks = np.stack([np.arange(4), np.full(4, 2)], axis=1)   # [T=4, N=2]
    >>> occupancy_timeline(ks, windows=2)
    [[0.5, 2.0], [2.5, 2.0]]
    """
    ks = np.asarray(ks, dtype=np.float64)
    bounds = np.linspace(0, ks.shape[0], windows + 1).astype(int)
    return [[float(v) for v in ks[lo:hi].mean(axis=0)]
            for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]


def tenant_occupancy(rec) -> dict:
    """Per-tenant occupancy/miss table for one tier record:
    ``{tenant: {"avg_k": seed-mean occupancy, "share": fraction of the
    budget, "miss_ratio": seed-mean}}``.

    >>> rec = {"budget": 10, "tenants": [
    ...     {"tenant": 0, "metrics": {"avg_k": [4.0], "miss_ratio": [0.5],
    ...                               "byte_miss_ratio": [0.5]}}]}
    >>> tenant_occupancy(rec)[0]["share"]
    0.4
    """
    out = {}
    for ten in rec["tenants"]:
        avg_k = float(np.mean(ten["metrics"]["avg_k"]))
        out[int(ten["tenant"])] = {
            "avg_k": avg_k,
            "share": avg_k / rec["budget"],
            "miss_ratio": float(np.mean(ten["metrics"]["miss_ratio"])),
        }
    return out


def fmt_row(cells, widths) -> str:
    """Left-justify ``cells`` into fixed-width columns.

    >>> fmt_row(["a", 1], [3, 3])
    'a    1  '
    """
    return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))


def print_table(matrix: dict, policies, *, fmt="{:+.3f}", col_w=14,
                name_w=22, out=print):
    """Print a ``{col: {policy: value}}`` matrix, policies as rows."""
    cols = list(matrix)
    out(fmt_row(["policy"] + cols, [name_w] + [col_w] * len(cols)))
    for pol in policies:
        out(fmt_row([pol] + [fmt.format(matrix[c][pol]) for c in cols],
                    [name_w] + [col_w] * len(cols)))
