"""Dry-run profiler (port of ``launch/profile.py``): one cell's HBM bytes
and collectives attributed to the code that issued them, the "profile"
step of the hypothesis -> change -> measure loop without a card.

The reference reads XLA's ``op_name`` metadata off the compiled HLO and
multiplies each instruction by its loop trips.  Here the step runs eagerly
under :class:`~repro_torch.launch.roofline.StepCounter` with
``attribute=True``: each aten op is charged to the innermost
``repro_torch`` function on the Python stack when it was dispatched (an
op of the backward pass to the function whose forward op made its
autograd node, as ``grad of ...``), and each collective to the function
that called ``launch.mesh``.  Every call counts, so the ``x`` column is
the number of calls, not a trip count.

  python -m repro_torch.launch.profile --arch musicgen-medium \\
      --shape prefill_32k --mesh pod --top 15
"""
from __future__ import annotations

import argparse
import sys

__all__ = ["profile_text"]


def profile_text(ana: dict, top: int = 15) -> str:
    """The terms, the bytes by op, and the ``top`` HBM contributors and
    collectives of a counter's result (``ana``, with its ``rows``).

    >>> ana = {"terms": {"compute_s": 1.0, "memory_s": 2.0,
    ...                  "collective_s": 0.5},
    ...        "hbm_by_op": {"mm": 3e9},
    ...        "rows": {("hbm", "mm", "models.layers.mlp_apply"): (3e9, 2),
    ...                 ("coll", "sum", "models.sharding.Local.sum"):
    ...                     (1e9, 4)}}
    >>> print(profile_text(ana))                # doctest: +ELLIPSIS
    terms: compute=1.000s memory=2.000s collective=0.500s
    hbm_by_op: mm=3GB
    <BLANKLINE>
    == top HBM contributors (bytes x calls) ==
            3.0GB x      2 mm                     models.layers.mlp_apply
    <BLANKLINE>
    == top collectives (wire bytes x calls) ==
            1.0GB x      4 sum                    models.sharding.Local.sum
    """
    terms = ana["terms"]
    out = [f"terms: compute={terms['compute_s']:.3f}s "
           f"memory={terms['memory_s']:.3f}s "
           f"collective={terms['collective_s']:.3f}s"]
    out.append("hbm_by_op: " + ", ".join(
        f"{k}={v / 1e9:.0f}GB" for k, v in sorted(
            ana["hbm_by_op"].items(), key=lambda kv: -kv[1])[:6]))
    rows = {"hbm": [], "coll": []}
    for (kind, op, fn), (b, n) in ana["rows"].items():
        rows[kind].append((b, n, op, fn[-70:]))
    for kind, title in (("hbm", "top HBM contributors (bytes x calls)"),
                        ("coll", "top collectives (wire bytes x calls)")):
        out.append(f"\n== {title} ==")
        for b, n, op, fn in sorted(rows[kind], reverse=True)[:top]:
            out.append(f"  {b / 1e9:9.1f}GB x{n:7.0f} {op:22s} {fn}")
    return "\n".join(out)


def main(argv=None):
    from ..configs import ARCHS, SHAPES
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.profile",
        description="Trace one dry-run cell and list its top HBM "
                    "contributors and collectives by issuing function.")
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--n-micro", type=int, default=0)
    ap.add_argument("--serve-sharding", default="resident",
                    choices=["resident", "fsdp"])
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device type (nothing is "
                         "allocated on it)")
    args = ap.parse_args(argv)

    from .dryrun import trace_cell
    extra = {"serve_sharding": args.serve_sharding}
    if args.n_micro:
        extra["n_micro"] = args.n_micro
    ana, _, _, _ = trace_cell(args.arch, args.shape, args.mesh,
                              remat=args.remat, extra=extra,
                              device=args.device, attribute=True)
    print(profile_text(ana, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
