"""The port's static-analysis gate: AST lint + step contracts + retrace
audit (counterpart of ``tools/repolint.py``).

Runs the three layers of ``repro_torch.analysis`` and exits nonzero on
any unwaived finding:

1. **lint** — the reference's AST rules, with their torch forms, over
   ``src/``, ``benchmarks/``, ``tools/``.  Waivers are per-line
   ``# repolint: waive[rule] -- reason`` comments, audited like the
   reference's; a torch-only finding is repaired, not waived.
2. **contracts** — every registry policy (and ``admit(...)`` wrapper, the
   budgeted DAC paths, the tier and the fleet) stepped once on a fresh
   state under an aten-op record on ``--device`` (on the card also
   captured into a CUDA graph and held equal to the eager step), plus the
   float64-default-dtype sub-pass.
3. **retrace** — the nine canonical engine calls of dac and lru count the
   captures, B1 launches, library loads and step programs the module
   states, and no equivalent spelling costs more.

Usage::

    python -m repro_torch.analysis                 # the gate, on the card
    python -m repro_torch.analysis --device cpu    # the plain versions
    python -m repro_torch.analysis --lint-only     # AST pass only
    python -m repro_torch.analysis --contracts-only
    python -m repro_torch.analysis --no-retrace    # skip the retrace audit
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("--lint-only", action="store_true",
                    help="run only the AST lint pass (imports no torch)")
    ap.add_argument("--contracts-only", action="store_true",
                    help="run only the contract + retrace passes")
    ap.add_argument("--no-retrace", action="store_true",
                    help="skip the retrace audit")
    ap.add_argument("--root", default=str(ROOT),
                    help="repository root to lint (default: this checkout)")
    ap.add_argument("--device", default="cuda",
                    help="device of the contract and retrace passes "
                         "(default: cuda)")
    args = ap.parse_args(argv)
    if args.lint_only and args.contracts_only:
        ap.error("--lint-only and --contracts-only are mutually exclusive")

    findings = []
    t0 = time.perf_counter()

    if not args.contracts_only:
        from .lint import lint_tree
        lint_findings = lint_tree(args.root)
        findings += lint_findings
        print(f"[repolint] lint: {len(lint_findings)} finding(s)")

    if not args.lint_only:
        import torch

        from . import contracts, retrace
        if args.device == "cuda" and not torch.cuda.is_available():
            print("[repolint] --device cuda needs a CUDA device; pass "
                  "--device cpu to check the plain versions",
                  file=sys.stderr)
            return 2
        contract_findings = contracts.verify_contracts(
            devices=(args.device,))
        findings += contract_findings
        n_targets = len(contracts.registry_specs()) + 4   # + budgeted/tier
        print(f"[repolint] contracts: {len(contract_findings)} finding(s) "
              f"over {n_targets} targets on {args.device} (+ float64 "
              "default-dtype pass)")
        if not args.no_retrace:
            for policy in ("dac", "lru"):
                retrace_findings, report = retrace.audit_engine(
                    policy, device=args.device)
                findings += retrace_findings
                print(f"[repolint] retrace {policy}: "
                      f"{len(retrace_findings)} finding(s), counts {report}")

    for f in findings:
        print(f"  {f}")
    status = "clean" if not findings else f"{len(findings)} finding(s)"
    print(f"[repolint] {status} in {time.perf_counter() - t0:.1f}s")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
