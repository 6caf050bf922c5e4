"""The port stands alone: it imports neither ``jax`` nor the reference
package, and its copies of the reference's numpy-only code (trace
generators, ``k_for``, the spec parser) equal the originals.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro import specs as ref_specs  # noqa: E402
from repro.bench.scenario import k_for as ref_k_for  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch import specs as port_specs  # noqa: E402
from repro_torch.data import traces as pt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PORT.rglob("*.py"))


def test_port_modules_import_without_jax_or_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 12


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path.name} imports {bad}"


@pytest.mark.parametrize("seed", (0, 1, 7))
def test_trace_copies_equal_reference(seed):
    cases = [
        ("zipf_trace", dict(N=300, T=2000, alpha=0.9)),
        ("shifting_zipf_trace", dict(N=300, T=2000, alpha=1.1, phases=3)),
        ("scan_mix_trace", dict(N=300, T=2000, alpha=1.0, scan_frac=0.3,
                                scan_len=50)),
        ("churn_trace", dict(N=300, T=2000, alpha=1.05, mean_phase=300,
                             drift=0.2)),
    ]
    for name, kw in cases:
        np.testing.assert_array_equal(getattr(pt, name)(seed=seed, **kw),
                                      getattr(rt, name)(seed=seed, **kw),
                                      err_msg=name)
    np.testing.assert_array_equal(pt.object_sizes(500, seed=seed),
                                  rt.object_sizes(500, seed=seed))
    sizes = rt.object_sizes(500, seed=seed)
    np.testing.assert_array_equal(pt.fetch_costs(sizes), rt.fetch_costs(sizes))


@pytest.mark.parametrize("family", sorted(rt.DATASET_FAMILIES))
def test_dataset_families_equal_reference(family):
    assert pt.DATASET_FAMILIES[family] == rt.DATASET_FAMILIES[family]
    spec = rt.make_trace(family)
    np.testing.assert_array_equal(pt.family_trace(family, 3000, seed=5),
                                  spec.generate(3000, seed=5))
    assert pt.family_footprint(family) == spec.n_keys
    for regime in ("S", "L"):
        assert pt.k_for(spec.n_keys, regime) == ref_k_for(spec.n_keys, regime)


def test_spec_parser_copy_equals_reference():
    for spec in ("dac", "dac(eps=0.25,growth=2)", "admit(dac(eps=0.5),x=1)",
                 " lru ( ) "):
        assert port_specs.parse_spec(spec) == ref_specs.parse_spec(spec)
        arg = ref_specs.parse_spec(spec)[1]
        assert port_specs.split_top(arg) == ref_specs.split_top(arg)

    def fn(self, eps: float = 0.5, growth: int = 4, on: bool = False):
        pass

    for argstr in ("eps=1,growth=4.0", "on=true", None):
        assert port_specs.build_kwargs("policy", "x", fn, argstr) == \
            ref_specs.build_kwargs("policy", "x", fn, argstr)
    for bad in ("growth=2.5", "nope=1"):
        with pytest.raises(ValueError):
            port_specs.build_kwargs("policy", "x", fn, bad)
