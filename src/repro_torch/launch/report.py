"""Summarize the dry run's JSONs into the roofline table (port of
``launch/report.py``; the same table from the same records).

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--dir experiments/dryrun_torch] [--mesh pod]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

__all__ = ["load", "fmt_s", "table"]


def load(dir_):
    """``{(arch, shape, mesh): record}`` of the untagged cell files in
    ``dir_`` (tagged files, ``<arch>__<shape>__<mesh>__<tag>.json``, are
    reported separately)."""
    cells = {}
    for f in glob.glob(os.path.join(dir_, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        key = (r["arch"], r["shape"], r["mesh"])
        if os.path.basename(f) == f"{r['arch']}__{r['shape']}__{r['mesh']}.json":
            cells[key] = r
    return cells


def fmt_s(x):
    """Seconds in a short form.

    >>> [fmt_s(x) for x in (250.0, 2.5, 0.0025, 2.5e-6)]
    ['250', '2.50', '2.50m', '2u']
    """
    if x >= 100:
        return f"{x:.0f}"
    if x >= 1:
        return f"{x:.2f}"
    if x >= 1e-3:
        return f"{x*1e3:.2f}m"
    return f"{x*1e6:.0f}u"


def table(cells, mesh="pod", out=None):
    """The markdown table of the ``ok`` cells of ``mesh``."""
    lines = []
    lines.append(
        "| arch | shape | compute_s | memory_s | coll_s | dominant | "
        "mem_s (kernel) | frac | frac (kernel) | MODEL/HLO |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|")
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh or not r.get("ok"):
            continue
        rf = r["roofline"]
        kc = rf.get("kernel_credited", {})
        lines.append(
            f"| {arch} | {shape} "
            f"| {fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} "
            f"| {fmt_s(rf['collective_s'])} | {rf['dominant'][:-2]} "
            f"| {fmt_s(kc['memory_s']) if kc else '-'} "
            f"| {rf['roofline_fraction']:.4f} "
            f"| {kc.get('roofline_fraction', 0):.4f} "
            f"| {rf['useful_flops_ratio']:.3f} |")
    text = "\n".join(lines)
    if out:
        with open(out, "w") as f:
            f.write(text)
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.report",
        description="Print the dry run's roofline table.")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="pod")
    args = ap.parse_args(argv)
    cells = load(args.dir)
    ok = sum(1 for r in cells.values() if r.get("ok"))
    print(f"# {ok}/{len(cells)} cells ok ({args.mesh} mesh shown)\n")
    print(table(cells, args.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
