"""The examples in the port's docstrings run (on the CPU), as
``tests/test_doctests.py`` runs the reference's."""
import doctest
import importlib

import pytest

MODULES = [
    "repro_torch.core",
    "repro_torch.core.policy",
    "repro_torch.core.simulator",
    "repro_torch.core.control",
    "repro_torch.core.adaptiveclimb",
    "repro_torch.core.dynamicadaptiveclimb",
    "repro_torch.core.baselines",
    "repro_torch.core.lirs_lhd",
    "repro_torch.core.state_io",
    "repro_torch.core.admission",
    "repro_torch.tier",
    "repro_torch.tier.arbiter",
    "repro_torch.tier.tier",
    "repro_torch.fleet",
    "repro_torch.fleet.fleet",
    "repro_torch.fleet.telemetry",
    "repro_torch.data.traces",
    "repro_torch.data.ingest",
    "repro_torch.bench.scenario",
    "repro_torch.bench.runner",
    "repro_torch.bench.results",
    "repro_torch.bench.report",
    "repro_torch.specs",
]


@pytest.mark.parametrize("module", MODULES)
def test_doctests(module):
    mod = importlib.import_module(module)
    result = doctest.testmod(mod, verbose=False,
                             optionflags=doctest.NORMALIZE_WHITESPACE)
    assert result.attempted > 0, f"{module} has no examples"
    assert result.failed == 0, f"{result.failed} doctest(s) failed in {module}"
