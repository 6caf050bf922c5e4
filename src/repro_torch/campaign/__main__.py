"""Campaign CLI: corpus-scale trace evaluation over `repro_torch.campaign`
(the port's counterpart of the reference's ``benchmarks/campaign.py``: the
same flags and exit codes, plus ``--device``).

  # run (or resume — completed cells are skipped) a campaign on the card:
  PYTHONPATH=src python -m repro_torch.campaign \\
      --manifest campaign.json --store runs/corpus [--workers N] \\
      [--shard i/n] [--max-cells N] [--chunk C] [--device cuda|cpu] [--quiet]

  # render the aggregate report from the store alone (nothing reruns):
  PYTHONPATH=src python -m repro_torch.campaign --store runs/corpus --report

  # coverage counts only:
  PYTHONPATH=src python -m repro_torch.campaign --store runs/corpus --status

The store directory is self-describing (it pins the manifest on first
run), so `--report` / `--status` / resumption need only `--store`.
`--shard i/n` runs the i-th round-robin slice of the full grid — launch
the same command on n hosts with i = 0..n-1 and point them at a shared
store.  `--max-cells` bounds how many cells execute this invocation
(smoke tests, crash-resume drills).  Failing traces are quarantined with
their traceback under `<store>/quarantine/` and reported, never fatal; a
device fault (a kernel's failed build or launch, a CUDA error) stops the
run with its traceback.  `--device` (default `cuda`) picks the card or,
with `cpu`, the plain versions.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.bench import results
from repro_torch.campaign import (CampaignStore, Manifest, format_report,
                                  load_manifest, pending_cells, plan_cells,
                                  render_report, run_campaign)


def _store_manifest(store: CampaignStore) -> Manifest:
    # the pinned copy's root was already re-anchored by load_manifest
    return Manifest.from_dict(store.manifest_dict())


def _status(store: CampaignStore) -> int:
    m = _store_manifest(store)
    cells = plan_cells(m)
    pending = pending_cells(cells, store)
    print(f"campaign {m.name} @ {store.root}")
    print(f"  planned     {len(cells)}")
    print(f"  completed   {len(store.completed())}")
    print(f"  quarantined {len(store.quarantined())}")
    print(f"  pending     {len(pending)}")
    return 0


def _report(store: CampaignStore, out: str | None, baseline: str) -> int:
    report = render_report(store, baseline=baseline)
    path = out or os.path.join(store.root, "report.json")
    results.atomic_write_json(path, report, sort_keys=True)
    print(format_report(report))
    print(f"\nreport written to {path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--store", required=True,
                    help="campaign store directory (created if missing)")
    ap.add_argument("--manifest", default=None,
                    help="manifest file (JSON/TOML); optional when the "
                         "store already pins one")
    ap.add_argument("--workers", type=int, default=0,
                    help="process-pool size; <=1 runs inline (default)")
    ap.add_argument("--shard", default=None, metavar="i/n",
                    help="run only the i-th of n round-robin grid slices")
    ap.add_argument("--max-cells", type=int, default=None,
                    help="execute at most this many cells this run")
    ap.add_argument("--chunk", type=int, default=None,
                    help="streaming chunk size override")
    ap.add_argument("--report", action="store_true",
                    help="render the aggregate report from the store "
                         "and exit (nothing reruns)")
    ap.add_argument("--status", action="store_true",
                    help="print coverage counts and exit")
    ap.add_argument("--baseline", default="fifo",
                    help="baseline policy for the reduction tables "
                         "(default: fifo)")
    ap.add_argument("--out", default=None,
                    help="report JSON path (default: <store>/report.json)")
    ap.add_argument("--device", default="cuda",
                    help="where cells replay: cuda (the card, default) or "
                         "cpu (the plain versions)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    store = CampaignStore(args.store)
    if args.report:
        return _report(store, args.out, args.baseline)
    if args.status:
        return _status(store)

    if args.manifest:
        manifest = load_manifest(args.manifest)
    else:
        try:
            manifest = _store_manifest(store)
        except OSError:
            print("error: --manifest is required for a fresh store",
                  file=sys.stderr)
            return 2
    summary = run_campaign(
        manifest, store, workers=args.workers, shard=args.shard,
        max_cells=args.max_cells, chunk=args.chunk, device=args.device,
        progress=None if args.quiet else print)
    c = summary.counts
    print(f"[{manifest.name}] {c['executed']} executed, "
          f"{c['skipped']} skipped (already stored), "
          f"{c['quarantined']} quarantined, {c['remaining']} remaining "
          f"[{summary.wall_s:.1f}s]")
    if summary.quarantined and not args.quiet:
        for key in summary.quarantined:
            q = store.get_quarantined(key)
            print(f"  quarantined {key}: {q['cell']['trace']} "
                  f"({q['error'].strip().splitlines()[-1]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
