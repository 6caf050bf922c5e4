"""Scan a trace directory and emit a campaign manifest (the port's
counterpart of the reference's ``tools/make_manifest.py``: the same
arguments, and the same manifest bytes for the same corpus).

Walks ``CORPUS`` one level deep for trace files in any
``repro_torch.data.ingest`` format (oracleGeneral binary / CSV /
key-per-line, gzip-transparent), groups them into datasets (subdirectory
name; trace format for flat files; ``--dataset`` forces one group),
characterizes each trace (request/object counts, byte footprint, skew —
frozen into the manifest), and writes a pinned
``repro.campaign.manifest/v1`` JSON ready for ``python -m
repro_torch.campaign``.

Usage::

    PYTHONPATH=src python -m repro_torch.campaign.make_manifest \\
        benchmarks/corpus --out campaign.json --policies fifo lru dac \\
        --K S L --seeds 0
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from repro_torch.campaign import Grid, scan_corpus

DEFAULT_POLICIES = ("fifo", "lru", "arc", "adaptiveclimb",
                    "dynamicadaptiveclimb")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign.make_manifest",
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("corpus", help="directory of trace files to scan")
    ap.add_argument("--out", default=None,
                    help="manifest path (default: <corpus>/campaign.json)")
    ap.add_argument("--name", default=None,
                    help="campaign name (default: the corpus dir name)")
    ap.add_argument("--policies", nargs="+", default=list(DEFAULT_POLICIES),
                    metavar="SPEC", help="make_policy spec strings")
    ap.add_argument("--K", nargs="+", default=["S", "L"], metavar="K",
                    help="capacities: ints and/or S/L regime letters")
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--T", type=int, default=None,
                    help="cap requests per trace (default: full trace)")
    ap.add_argument("--dataset", default=None,
                    help="force all traces into one named dataset")
    ap.add_argument("--no-stats", action="store_true",
                    help="skip per-trace characterization (faster scan)")
    args = ap.parse_args(argv)

    K = tuple(k if k in ("S", "L") else int(k) for k in args.K)
    grid = Grid(policies=tuple(args.policies), K=K,
                seeds=tuple(args.seeds), T=args.T)
    manifest = scan_corpus(args.corpus, name=args.name, grid=grid,
                           dataset=args.dataset,
                           characterize=not args.no_stats)
    n_traces = sum(len(d.traces) for d in manifest.datasets)
    out = args.out or os.path.join(args.corpus, "campaign.json")
    # a relative manifest root re-anchors at the manifest file's directory
    # on load, so record the corpus relative to where the manifest lands —
    # the pair stays relocatable together
    root = os.path.relpath(os.path.abspath(args.corpus),
                           os.path.dirname(os.path.abspath(out)))
    manifest = dataclasses.replace(manifest, root=root)
    manifest.save(out)
    cells = (n_traces * len(grid.policies) * len(grid.K)
             * len(grid.seeds))
    print(f"{out}: {len(manifest.datasets)} dataset(s), "
          f"{n_traces} trace(s), {cells} grid cells")
    for ds in manifest.datasets:
        reqs = (sum(s["n_requests"] for s in ds.stats.values())
                if ds.stats else "?")
        print(f"  {ds.name}: {len(ds.traces)} trace(s), {reqs} requests")
    return 0


if __name__ == "__main__":
    sys.exit(main())
