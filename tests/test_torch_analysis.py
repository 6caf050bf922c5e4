"""The port's analysis layer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* lint: every lint and waiver fixture of ``tests/test_analysis.py`` through
  both linters with equal results, the torch forms of ``empty-sentinel``
  and ``traced-branch`` (caught and exempt), both linters equal on every
  file of the analysis scope, and the port's tree clean;
* contracts: every registry spec, the budgeted paths, the tier and the
  fleet clean beside the reference, the float64-default-dtype sub-pass
  beside the reference's x64 pass, and torch versions of the reference's
  broken toy policies each caught by the rule that catches the
  reference's toy;
* retrace: the engine audit clean for dac and lru with the counts the
  module states, a dtype-less scalar in a step caught as a new program, a
  count mismatch as ``retrace-count``;
* the gate: ``python -m repro_torch.analysis --device cpu`` and
  ``--lint-only`` exit 0.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import analysis as ref
from repro.bench import results
from repro.core import policy as ref_policy
from repro_torch import analysis as port
from repro_torch.analysis import contracts, retrace
from repro_torch.core import Engine, Policy, padded_row, step_info
from repro_torch.core.policy import EMPTY, LANE

ROOT = Path(__file__).resolve().parents[1]
SCOPE = sorted(p for d in ("src", "benchmarks", "tools")
               for p in (ROOT / d).rglob("*.py")
               if "__pycache__" not in p.parts)


def rules_of(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# lint: the reference's fixtures through both linters
# ---------------------------------------------------------------------------

# (id, source, path, the rules tests/test_analysis.py expects)
REFERENCE_CASES = [
    ("wallclock_bad", "import time\ndef f():\n    return time.time()\n",
     "m.py", ["wallclock"]),
    ("wallclock_datetime",
     "import datetime\nstamp = datetime.datetime.now()\n", "m.py",
     ["wallclock"]),
    ("wallclock_good_perf_counter", "import time\nt0 = time.perf_counter()\n",
     "m.py", []),
    ("unseeded_rng_legacy_numpy",
     "import numpy as np\nx = np.random.rand(3)\n", "m.py", ["unseeded-rng"]),
    ("unseeded_rng_stdlib", "import random\nx = random.choice([1, 2])\n",
     "m.py", ["unseeded-rng"]),
    ("unseeded_default_rng",
     "import numpy as np\nrng = np.random.default_rng()\n", "m.py",
     ["unseeded-rng"]),
    ("seeded_default_rng",
     "import numpy as np\nrng = np.random.default_rng(17)\n", "m.py", []),
    ("seeded_generator_draws_pass",
     "import numpy as np\nrng = np.random.default_rng(0)\n"
     "x = rng.normal(size=3)\ny = rng.choice([1, 2])\n", "m.py", []),
    ("jax_random_is_seeded_by_key",
     "import jax\nx = jax.random.normal(jax.random.PRNGKey(0), (3,))\n",
     "m.py", []),
    ("schema_literal_bad", f'schema = "{results.SCHEMA_V1}"\n', "m.py",
     ["schema-literal"]),
    ("schema_literal_docstring_exempt",
     f'"""Payloads use ``{results.SCHEMA_V2}`` records."""\n', "m.py", []),
    ("schema_literal_defining_module_exempt",
     f'SCHEMA_V1 = "{results.SCHEMA_V1}"\n', "src/repro/bench/results.py",
     []),
    ("schema_literal_other_module", f'SCHEMA_V1 = "{results.SCHEMA_V1}"\n',
     "other.py", ["schema-literal"]),
    ("empty_sentinel_bad", "import jax.numpy as jnp\nx = jnp.int32(-1)\n",
     "m.py", ["empty-sentinel"]),
    ("empty_sentinel_other_values_pass",
     "import jax.numpy as jnp\n"
     "a = jnp.int32(-2)\nb = jnp.int32(0)\nc = jnp.float32(-1)\n", "m.py", []),
    ("atomic_json_bad", "import json\ndef save(p, d):\n"
     "    with open(p, 'w') as f:\n        json.dump(d, f)\n", "m.py",
     ["atomic-json"]),
    ("atomic_json_writer_body_exempt",
     "import json\ndef atomic_write_json(p, d):\n"
     "    with open(p, 'w') as f:\n        json.dump(d, f)\n", "m.py", []),
    ("json_dumps_passes", "import json\ns = json.dumps({'a': 1})\n", "m.py",
     []),
    ("traced_branch_bad", "import jax.numpy as jnp\ndef f(x):\n"
     "    if jnp.any(x > 0):\n        return 1\n    return 0\n", "m.py",
     ["traced-branch"]),
    ("traced_branch_while", "import jax.numpy as jnp\ndef f(x):\n"
     "    while jnp.sum(x) > 0:\n        x = x - 1\n", "m.py",
     ["traced-branch"]),
    ("traced_branch_metadata_ok", "import jax.numpy as jnp\ndef f(x):\n"
     "    if jnp.dtype(x.dtype) == jnp.dtype(jnp.int32):\n"
     "        return 1\n    return 0\n", "m.py", []),
    # TestWaivers
    ("same_line_waiver",
     "import time\nt = time.time()  # repolint: waive[wallclock] -- stamp\n",
     "m.py", []),
    ("line_above_waiver",
     "import time\n# repolint: waive[wallclock] -- provenance stamp\n"
     "t = time.time()\n", "m.py", []),
    ("waiver_is_rule_specific",
     "import time\nt = time.time()  # repolint: waive[atomic-json] -- wrong\n",
     "m.py", ["unused-waiver", "wallclock"]),
    ("stale_waiver_reported",
     "x = 1  # repolint: waive[wallclock] -- nothing here\n", "m.py",
     ["unused-waiver"]),
    ("waiver_in_docstring_is_inert",
     '"""Docs show `# repolint: waive[wallclock]` syntax."""\n'
     "import time\nt = time.time()\n", "m.py", ["wallclock"]),
    ("multi_rule_waiver", "import time, json\n"
     "# repolint: waive[wallclock,atomic-json] -- demo\n"
     "t = json.dump({'t': time.time()}, open('x', 'w'))\n", "m.py", []),
]


@pytest.mark.parametrize("src,path,want",
                         [c[1:] for c in REFERENCE_CASES],
                         ids=[c[0] for c in REFERENCE_CASES])
def test_reference_fixture_through_both_linters(src, path, want):
    got = port.lint_source(src, path=path)
    assert got == ref.lint_source(src, path=path)
    assert rules_of(got) == want


def test_stale_waiver_location_matches_reference():
    src = "x = 1  # repolint: waive[wallclock] -- nothing here\n"
    assert port.lint_source(src, path="m.py")[0].where == "m.py:1"


# (id, source, rules from the port; the reference sees no torch form)
TORCH_CASES = [
    ("full_minus_one",
     "import torch\nx = torch.full((4,), -1, dtype=torch.int32)\n",
     ["empty-sentinel"]),
    ("tensor_minus_one",
     "import torch\nx = torch.tensor(-1, dtype=torch.int32)\n",
     ["empty-sentinel"]),
    ("new_full_minus_one",
     "import torch\ny = x.new_full((2,), -1, dtype=torch.int32)\n",
     ["empty-sentinel"]),
    ("full_like_fill_keyword",
     "import torch\ny = torch.full_like(x, fill_value=-1, dtype=torch.int)\n",
     ["empty-sentinel"]),
    ("full_empty_constant_ok",
     "import torch\nfrom repro_torch.core import EMPTY\n"
     "x = torch.full((4,), EMPTY, dtype=torch.int32)\n", []),
    ("full_minus_one_int64_ok",
     "import torch\nx = torch.full((4,), -1, dtype=torch.int64)\n", []),
    ("tensor_minus_one_no_dtype_ok", "import torch\nx = torch.tensor(-1)\n",
     []),
    ("full_minus_two_ok",
     "import torch\nx = torch.full((4,), -2, dtype=torch.int32)\n", []),
    ("no_torch_import_ok", "x = torch.full((4,), -1, dtype=torch.int32)\n"
     "if torch.any(x > 0):\n    y = 1\n", []),
    ("branch_torch_any",
     "import torch\ndef f(x):\n    if torch.any(x > 0):\n        return 1\n",
     ["traced-branch"]),
    ("branch_while_torch_all",
     "import torch\ndef f(x):\n    while torch.all(x > 0):\n"
     "        x = x - 1\n", ["traced-branch"]),
    ("branch_item", "import torch\ndef f(x):\n    if x.item() > 0:\n"
     "        return 1\n", ["traced-branch"]),
    ("branch_method_any", "import torch\ndef f(a, b):\n"
     "    if (a == b).any():\n        return 1\n", ["traced-branch"]),
    ("branch_torch_equal", "import torch\ndef f(a, b):\n"
     "    if not torch.equal(a, b):\n        return 1\n", ["traced-branch"]),
    ("branch_metadata_ok", "import numpy as np\nimport torch\ndef f(x, d):\n"
     "    if torch.is_tensor(x) and torch.device(d).type == 'cpu':\n"
     "        return 1\n"
     "    if torch.is_grad_enabled() or torch.cuda.is_available():\n"
     "        return 2\n"
     "    if x.dtype == torch.int32 and torch.finfo(torch.float32).eps:\n"
     "        return 3\n"
     "    if np.all(np.asarray([1])) and np.any(x.shape):\n"
     "        return 4\n", []),
]


@pytest.mark.parametrize("src,want", [c[1:] for c in TORCH_CASES],
                         ids=[c[0] for c in TORCH_CASES])
def test_torch_forms(src, want):
    assert rules_of(port.lint_source(src, path="t.py")) == want
    assert ref.lint_source(src, path="t.py") == []


def test_torch_only_finding_is_repaired_not_waived():
    """A waiver of a torch-only finding silences the port's linter and is
    an ``unused-waiver`` to the reference's, which fails its gate."""
    src = ("import torch\ndef f(x):\n"
           "    if x.item():  # repolint: waive[traced-branch] -- no\n"
           "        return 1\n")
    assert port.lint_source(src, path="t.py") == []
    assert rules_of(ref.lint_source(src, path="t.py")) == ["unused-waiver"]


@pytest.mark.parametrize("path", SCOPE, ids=lambda p: str(p.relative_to(ROOT)))
def test_linters_agree_on_file(path):
    got = port.lint_file(path, root=ROOT)
    assert got == ref.lint_file(path, root=ROOT)
    assert got == []


def test_port_lint_tree_is_clean():
    assert port.lint_tree(ROOT) == []
    assert len(SCOPE) > 150


def test_finding_and_rules_copy_reference():
    assert port.Finding._fields == ref.Finding._fields
    f = port.Finding("wallclock", "a.py:3", "boom")
    assert str(f) == str(ref.Finding("wallclock", "a.py:3", "boom")) == \
        "a.py:3: [wallclock] boom"
    assert port.RULES == ref.RULES


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------

def test_registry_specs_equal_reference():
    assert port.registry_specs() == ref.registry_specs()
    assert len(port.registry_specs()) == 30


@pytest.mark.parametrize("spec", ref.registry_specs())
def test_policy_contracts(spec):
    assert ref.check_policy(spec) == []
    assert port.check_policy(spec, device="cpu") == []


@pytest.mark.parametrize("spec", ["dynamicadaptiveclimb",
                                  "admit(dynamicadaptiveclimb)"])
def test_budgeted_contracts(spec):
    assert ref.check_policy(spec, budgeted=True) == []
    assert port.check_policy(spec, device="cpu", budgeted=True) == []


def test_tier_and_fleet_contracts():
    assert ref.check_tier() == [] and ref.check_fleet() == []
    assert port.check_tier(device="cpu") == []
    assert port.check_fleet(device="cpu") == []


@pytest.mark.parametrize("spec", ref.registry_specs())
def test_default_dtype_subpass(spec):
    with jax.enable_x64(True):
        assert ref.check_policy(spec) == []
    previous = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        assert port.check_policy(spec, device="cpu") == []
    finally:
        torch.set_default_dtype(previous)
    assert torch.get_default_dtype() == previous


def test_full_verify_contracts_is_clean():
    assert port.verify_contracts(devices=("cpu",)) == []
    assert torch.get_default_dtype() == torch.float32


def test_int64_documented_leaves_and_index_values():
    """LRU's int64 timestamps pass; an int64 leaf it does not document,
    and an int64 sum outside an index computation, are f64-leaks."""
    assert contracts.INT64_LEAVES == {"lru": ("last", "t"),
                                      "blru": ("last", "t")}
    fs = port.check_policy(_WideCount(), device="cpu")
    assert rules_of(fs) == ["f64-leak"]
    assert any("state leaf ['n']" in f.message for f in fs)
    assert any("aten.sum" in f.message for f in fs)


# --- toy policies, each breaking one contract, beside the reference's ------

class _ToyRank(Policy):
    """Minimal well-formed rank-row policy (the control fixture)."""

    name = "toyrank"

    def init(self, K, lanes=1, device="cuda"):
        return {"cache": padded_row(K, lanes, device)}

    def step(self, state, req):
        cache = state["cache"]
        hit = (cache == req.key.unsqueeze(-1)).any(-1)
        first = torch.where(hit, cache[:, 0], req.key)
        cache = torch.cat([first.unsqueeze(-1), cache[:, 1:]], -1)
        return {"cache": cache}, step_info(hit, req)


class _CarryDrift(_ToyRank):
    name = "carrydrift"

    def step(self, state, req):
        new, info = super().step(state, req)
        return {"cache": new["cache"].to(torch.float32)}, info


class _StructureDrift(_ToyRank):
    name = "structuredrift"

    def step(self, state, req):
        new, info = super().step(state, req)
        return dict(new, extra=torch.zeros_like(req.key)), info


class _HostRead(_ToyRank):
    """The reference's debug-callback toy: a step that reads to the host."""

    name = "hostread"

    def step(self, state, req):
        if int(req.key[0].item()) < 0:
            req = req._replace(key=req.key + 1)
        return super().step(state, req)


class _UnpaddedRow(_ToyRank):
    name = "unpaddedrow"

    def init(self, K, lanes=1, device="cuda"):
        return {"cache": torch.full((lanes, K), EMPTY, dtype=torch.int32,
                                    device=device)}


class _MissingAdaptKeys(_ToyRank):
    name = "missingadapt"
    ADAPT_KEYS = ("jump",)


class _WideCount(_ToyRank):
    name = "widecount"

    def init(self, K, lanes=1, device="cuda"):
        return dict(super().init(K, lanes, device),
                    n=torch.zeros(lanes, dtype=torch.int64, device=device))

    def step(self, state, req):
        new, info = super().step(state, req)
        n = state["n"] + (new["cache"] == req.key.unsqueeze(-1)).sum(-1)
        return dict(new, n=n), info


class _DeviceCopy(_ToyRank):
    """Copies a tensor to another device inside the step (on the card, a
    host-to-device copy: a sync)."""

    name = "devicecopy"

    def step(self, state, req):
        req.key.to("meta")
        return super().step(state, req)


def test_copy_across_devices_caught():
    fs = port.check_policy(_DeviceCopy(), device="cpu")
    assert rules_of(fs) == ["forbidden-primitive"]
    assert any("across cpu/meta" in f.message for f in fs)


class _RefToy(ref_policy.Policy):
    name = "reftoy"

    def init(self, K):
        return {"cache": ref_policy.padded_row(K)}

    def step(self, state, req):
        cache = state["cache"]
        hit = jnp.any(cache == req.key)
        cache = jnp.where(hit, cache, cache.at[0].set(req.key))
        return {"cache": cache}, ref_policy.step_info(hit, req)


class _RefCarryDrift(_RefToy):
    def step(self, state, req):
        new, info = super().step(state, req)
        return {"cache": new["cache"].astype(jnp.float32)}, info


class _RefStructureDrift(_RefToy):
    def step(self, state, req):
        new, info = super().step(state, req)
        return dict(new, extra=jnp.int32(0)), info


class _RefDebugCallback(_RefToy):
    def step(self, state, req):
        jax.debug.print("key={k}", k=req.key)
        return super().step(state, req)


class _RefUnpaddedRow(_RefToy):
    def init(self, K):
        return {"cache": jnp.full((K,), ref_policy.EMPTY, jnp.int32)}


class _RefMissingAdaptKeys(_RefToy):
    ADAPT_KEYS = ("jump",)


TOYS = [  # (id, port toy, reference toy, K, rule)
    ("control", _ToyRank, _RefToy, 8, None),
    ("carry_aval", _CarryDrift, _RefCarryDrift, 8, "carry-aval"),
    ("carry_structure", _StructureDrift, _RefStructureDrift, 8,
     "carry-structure"),
    ("forbidden_primitive", _HostRead, _RefDebugCallback, 8,
     "forbidden-primitive"),
    ("row_width", _UnpaddedRow, _RefUnpaddedRow, 5, "row-width"),
    ("adapt_keys", _MissingAdaptKeys, _RefMissingAdaptKeys, 8, "adapt-keys"),
]


@pytest.mark.parametrize("toy,ref_toy,K,rule", [t[1:] for t in TOYS],
                         ids=[t[0] for t in TOYS])
def test_toy_caught_by_the_reference_rule(toy, ref_toy, K, rule):
    assert LANE % K or rule != "row-width"
    want = [] if rule is None else [rule]
    assert rules_of(ref.check_policy(ref_toy(), K=K)) == want
    fs = port.check_policy(toy(), K=K, device="cpu")
    assert rules_of(fs) == want
    if rule == "carry-aval":
        assert any("float32" in f.message for f in fs)
    if rule == "forbidden-primitive":
        assert any(p in f.message for f in fs
                   for p in contracts.FORBIDDEN_PRIMITIVES)


# ---------------------------------------------------------------------------
# retrace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,name", [("dac", "dynamicadaptiveclimb"),
                                         ("lru", "lru")])
def test_engine_retrace_audit_is_clean(policy, name):
    findings, report = port.audit_engine(policy, device="cpu")
    assert findings == []
    assert report == retrace.ENGINE_EXPECTED[name]["cpu"]


class _ScalarStep(_ToyRank):
    """Makes a tensor from a Python scalar without a dtype: its type
    follows the scalar's, as a weak type's aval does in the reference."""

    name = "scalarstep"

    def __init__(self, shift=0):
        self.shift = shift

    def step(self, state, req):
        req = req._replace(key=req.key + torch.tensor(self.shift))
        return super().step(state, req)


def test_audit_catches_a_dtype_less_scalar():
    """``np.int32(0)`` and ``0`` make equal policies and equal replays,
    but the Python int makes an int64 tensor: another step program."""
    eng = Engine(device="cpu")
    keys = np.arange(8, dtype=np.int32) % 3
    assert _ScalarStep(np.int32(0)) == _ScalarStep(0)
    programs = retrace.StepPrograms()
    prime = [("np.int32", lambda: eng.replay(_ScalarStep(np.int32(0)),
                                             keys, 4))]
    assert port.audit_jit(
        {"programs": programs}, "toy", prime,
        [("same spelling", lambda: eng.replay(_ScalarStep(np.int32(0)),
                                              keys, 4))]) == []
    fs = port.audit_jit({"programs": programs}, "toy", prime,
                        [("python int", lambda: eng.replay(_ScalarStep(0),
                                                           keys, 4))])
    assert rules_of(fs) == ["retrace"]


def test_audit_expected_count_mismatch():
    programs = retrace.StepPrograms()
    double = programs.track(lambda x: x * 2)
    fs = port.audit_jit({"programs": programs}, "toy",
                        prime=[("i32", lambda: double(torch.ones(2)))],
                        variants=[], expected={"programs": 2})
    assert rules_of(fs) == ["retrace-count"]


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def _gate(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})


def test_gate_on_the_cpu_exits_clean():
    proc = _gate("--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: 0 finding(s)" in proc.stdout
    assert "contracts: 0 finding(s)" in proc.stdout
    assert proc.stdout.count("finding(s), counts") == 2


def test_gate_lint_only_imports_no_torch_or_jax():
    proc = _gate("--lint-only")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: 0 finding(s)" in proc.stdout
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch.analysis', '--lint-only']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', run_name='__main__',"
            " alter_sys=True)\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
