"""Static analysis for the port: step contracts, the retrace audit and
repo lint (port of ``repro.analysis``).

Three levels, one ``Finding`` currency, gated by
``python -m repro_torch.analysis``:

* :mod:`repro_torch.analysis.contracts` — runs one step of every registry
  policy (and the tier/fleet budgeted paths) on a fresh state under an
  aten-op record and verifies the graph loop's carry law, lane-padded
  ``int32`` rows, ``ADAPT_KEYS`` presence, the absence of 64-bit widening
  and of host syncs; on the card it also captures each step into a CUDA
  graph and holds the replay equal to the eager step.
* :mod:`repro_torch.analysis.retrace` — counts CUDA graph captures, B1
  launches and library builds and loads (on the CPU, distinct step
  programs) across the nine canonical engine calls and fails on a
  recapture or rebuild.
* :mod:`repro_torch.analysis.lint` — the reference's AST rules over
  ``src/``, ``benchmarks/`` and ``tools/``, with their torch forms where a
  module imports ``torch``, and the audited per-line waiver syntax.

The package loads ``lint`` (which needs no torch) alone until a contract
or retrace name is asked for, so the lint gate imports neither torch nor
jax.

>>> from repro_torch.analysis import (Finding, check_policy, lint_source,
...                                   verify_contracts)
>>> lint_source("x = 1\\n", path="ok.py")
[]
>>> check_policy("fifo", device="cpu")
[]
"""
from .findings import Finding
from .lint import RULES, lint_file, lint_source, lint_tree

__all__ = [
    "Finding", "RULES", "lint_source", "lint_file", "lint_tree",
    "registry_specs", "check_policy", "check_tier", "check_fleet",
    "verify_contracts", "audit_jit", "audit_engine", "cache_entries",
]

_LAZY = {
    "registry_specs": "contracts", "check_policy": "contracts",
    "check_tier": "contracts", "check_fleet": "contracts",
    "verify_contracts": "contracts",
    "audit_jit": "retrace", "audit_engine": "retrace",
    "cache_entries": "retrace",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
