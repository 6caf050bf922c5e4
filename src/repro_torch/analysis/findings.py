"""The one currency of the port's static-analysis subsystem: a ``Finding``
(the port's copy of ``repro/analysis/findings.py``).

Every analyzer level — the AST lint pass (``repro_torch.analysis.lint``),
the step-contract analyzer (``repro_torch.analysis.contracts``) and the
retrace audit (``repro_torch.analysis.retrace``) — reports problems as a
flat list of ``Finding`` records, so ``python -m repro_torch.analysis`` can
render and gate them uniformly.

>>> f = Finding(rule="wallclock", where="benchmarks/run.py:12",
...             message="time.time() call")
>>> print(f)
benchmarks/run.py:12: [wallclock] time.time() call
"""
from __future__ import annotations

from typing import NamedTuple

__all__ = ["Finding"]


class Finding(NamedTuple):
    """One static-analysis violation.

    ``rule`` is the machine-readable rule id (used in waiver comments),
    ``where`` locates it (``path:line`` for lint, a contract-target label
    for step checks), ``message`` explains it to a human.

    >>> Finding("carry-aval", "dac@pallas=False", "dtype drift").rule
    'carry-aval'
    """

    rule: str
    where: str
    message: str

    def __str__(self):
        return f"{self.where}: [{self.rule}] {self.message}"
