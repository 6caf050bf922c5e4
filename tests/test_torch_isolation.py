"""The port stands alone: it imports neither ``jax`` nor the reference
package, and its copies of the reference's plain code (trace generators,
``k_for``, the spec parser, the architecture configs and shape cells)
equal the originals.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import specs as ref_specs  # noqa: E402
from repro.bench.scenario import k_for as ref_k_for  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
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
    # the training slice's modules are in the walk
    assert {"repro_torch.data.tokens", "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.checkpoint",
            "repro_torch.checkpoint.manager", "repro_torch.train",
            "repro_torch.train.train_step", "repro_torch.train.trainer",
            "repro_torch.train.compression",
            "repro_torch.launch.train"} <= set(MODULES)
    # and the multi-GPU slice's
    assert {"repro_torch.launch.mesh",
            "repro_torch.models.sharding"} <= set(MODULES)
    # and the analysis layer's
    assert {"repro_torch.analysis", "repro_torch.analysis.findings",
            "repro_torch.analysis.lint", "repro_torch.analysis.contracts",
            "repro_torch.analysis.retrace",
            "repro_torch.analysis.__main__"} <= set(MODULES)
    # and the launch layer's dry run
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.launch.profile",
            "repro_torch.launch.report"} <= set(MODULES)


@pytest.mark.parametrize("entry", ["repro_torch.launch.train",
                                   "repro_torch.launch.serve",
                                   "repro_torch.launch.dryrun",
                                   "repro_torch.launch.profile",
                                   "repro_torch.launch.report"])
def test_launch_entry_points_import_without_jax_or_reference(entry):
    """``python -m`` of each launch entry point (its ``--help``) loads
    neither jax nor the reference package."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{entry!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({entry!r}, run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage: " in out.stdout


@pytest.mark.parametrize("entry", ["repro_torch.campaign",
                                   "repro_torch.campaign.make_manifest"])
def test_campaign_entry_points_import_without_jax_or_reference(entry):
    """``python -m`` of each campaign entry point (its ``--help``) loads
    neither jax nor the reference package."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{entry!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({entry!r}, run_name='__main__',\n"
        "                     alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert 'repro_torch.campaign' in sys.modules\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage: python -m " + entry in out.stdout


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py", ROOT / "decode_sweep.py",
                            ROOT / "graph_sweep.py"],
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


@pytest.mark.parametrize("table", ["ARCHS", "SMOKE_ARCHS"])
def test_config_copies_equal_reference(table):
    ref, port = getattr(ref_configs, table), getattr(port_configs, table)
    assert list(port) == list(ref)
    for name, cfg in ref.items():
        assert dataclasses.asdict(port[name]) == dataclasses.asdict(cfg), name
        assert port[name].head_dim == cfg.head_dim
        assert port[name].n_periods == cfg.n_periods
        assert str(port[name].dtype).removeprefix("torch.") == \
            str(cfg.dtype)
        assert port_configs.get_arch(name, smoke=table == "SMOKE_ARCHS") \
            == port[name]


def test_finding_and_lint_rules_copy_reference():
    """The port's ``Finding`` and the six lint rules it copies (plus the
    waiver audit's) are the reference's."""
    from repro.analysis import findings as rf
    from repro.analysis import lint as rl
    from repro_torch.analysis import findings as pf
    from repro_torch.analysis import lint as pl
    assert pf.Finding._fields == rf.Finding._fields
    assert str(pf.Finding("r", "w", "m")) == str(rf.Finding("r", "w", "m"))
    assert pl.RULES == rl.RULES and len(pl.RULES) == 7
    assert pl._WAIVER_RE.pattern == rl._WAIVER_RE.pattern
    assert pl._SCHEMA_HOME == rl._SCHEMA_HOME == "repro/bench/results.py"


def test_shape_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(KeyError):
        port_configs.get_arch("no-such-arch")


from repro.data import ingest as ri  # noqa: E402
from repro_torch.data import ingest as pi  # noqa: E402

CORPUS = sorted((ROOT / "benchmarks" / "corpus").iterdir())


@pytest.mark.parametrize("seed", (0, 3))
def test_whole_trace_module_copy_equals_reference(seed):
    """The generators the first copy lacked, on seeded inputs."""
    cases = [
        ("tenants_trace", dict(N=64, T=500, n_tenants=3)),
        ("fleet_trace", dict(N=64, T=600, n_lanes=3, rate=0.05,
                             mean_session=80)),
        ("flood_trace", dict(N=64, T=500, alpha=0.9)),
        ("scanstorm_trace", dict(N=64, T=700, alpha=0.9, mean_phase=200,
                                 scan_len=32)),
        ("diurnal_trace", dict(N=64, T=500, period=128)),
        ("thrash_trace", dict(N=64, T=500, loop=40)),
    ]
    for name, kw in cases:
        np.testing.assert_array_equal(getattr(pt, name)(seed=seed, **kw),
                                      getattr(rt, name)(seed=seed, **kw),
                                      err_msg=name)
    np.testing.assert_array_equal(pt.bimodal_sizes(300, seed=seed, split=90),
                                  rt.bimodal_sizes(300, seed=seed, split=90))
    np.testing.assert_array_equal(pt.dataset_family("metakv", T=300,
                                                    n_traces=2, seed=seed),
                                  rt.dataset_family("metakv", T=300,
                                                    n_traces=2, seed=seed))


def test_trace_registry_copy_equals_reference():
    assert sorted(pt.TRACES) == sorted(rt.TRACES)
    assert pt.TRACE_ALIASES == rt.TRACE_ALIASES
    assert (pt.COLD_RANGE_FAMILIES, pt.TIER_FAMILIES, pt.FLEET_FAMILIES) == \
        (rt.COLD_RANGE_FAMILIES, rt.TIER_FAMILIES, rt.FLEET_FAMILIES)
    specs = ["zipf(N=128,alpha=1.0)", "wiki", "tencent(alpha=0.8)",
             "tenants(N=64,n_tenants=2)", "fleet(N=64,n_lanes=3)",
             "flood(N=64,alpha=0.9)", "scanstorm(N=64,alpha=1)",
             "diurnal(N=64)", "thrash(N=64,loop=9)",
             "file(path=benchmarks/corpus/kv.csv.gz)"]
    for spec in specs:
        r, p = rt.make_trace(spec), pt.make_trace(spec)
        assert (str(p), p.family, p.params) == (str(r), r.family, r.params)
        assert (p.n_keys, p.is_tier, p.is_fleet, p.is_file, p.n_tenants) \
            == (r.n_keys, r.is_tier, r.is_fleet, r.is_file, r.n_tenants)
        if not (p.is_tier or p.is_fleet):
            np.testing.assert_array_equal(p.generate_batch(1000, (0, 4)),
                                          r.generate_batch(1000, (0, 4)))
    for bad in ("nope", "zipf(N=3)", "zipf(N=3,alpha=1,x=2)"):
        with pytest.raises(ValueError) as ref:
            rt.make_trace(bad)
        with pytest.raises(ValueError) as port:
            pt.make_trace(bad)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("path", CORPUS, ids=lambda p: p.name)
def test_ingest_copy_equals_reference_on_corpus(path):
    assert pi.detect_format(path) == ri.detect_format(path)
    assert pi.count_requests(path) == ri.count_requests(path)
    assert dataclasses.asdict(pi.characterize(path)) == \
        dataclasses.asdict(ri.characterize(path))
    ref, port = ri.load_trace(path), pi.load_trace(path)
    for f in ref._fields:
        r, p = getattr(ref, f), getattr(port, f)
        if r is None:
            assert p is None, f
        else:
            np.testing.assert_array_equal(p, r, err_msg=f)
    for r, p in zip(ri.iter_chunks(path, chunk=777, limit=3000),
                    pi.iter_chunks(path, chunk=777, limit=3000)):
        for f in r._fields:
            a, b = getattr(r, f), getattr(p, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(b, a, err_msg=f)


def test_ingest_writers_equal_reference(tmp_path):
    keys = rt.zipf_trace(N=50, T=400, alpha=1.0, seed=2)
    sizes = (np.arange(50) * 37 % 251 + 1)[keys]
    costs = rt.fetch_costs(sizes)
    for fn, name, args in (
            ("write_oracle_general", "t.oracleGeneral.bin", (keys, sizes)),
            ("write_csv", "t.csv", (keys, sizes, costs)),
            ("write_keys", "t.keys.txt", (keys,))):
        for side, mod in (("ref", ri), ("port", pi)):
            (tmp_path / side).mkdir(exist_ok=True)
            getattr(mod, fn)(str(tmp_path / side / name), *args)
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), fn


@pytest.mark.parametrize("seed", (0, 5))
def test_token_pipeline_copy_equals_reference(seed):
    """The port's ``data/tokens.py`` gives the reference's batches bit for
    bit: tokens, labels and stub-frontend embeddings, for several steps
    and host shardings."""
    from repro.data.tokens import TokenPipeline as RefPipeline
    from repro_torch.data.tokens import TokenPipeline
    for vocab, B, S, embed_dim in ((256, 8, 16, 0), (1000, 4, 33, 24)):
        ref = RefPipeline(vocab, B, S, seed=seed, embed_dim=embed_dim)
        port = TokenPipeline(vocab, B, S, seed=seed, embed_dim=embed_dim)
        for step in (0, 3, 17):
            for n_hosts in (1, 2, 4):
                for host in range(n_hosts):
                    want = ref.batch(step, host_id=host, n_hosts=n_hosts)
                    got = port.batch(step, host_id=host, n_hosts=n_hosts)
                    assert sorted(got) == sorted(want)
                    for k in want:
                        assert got[k].dtype == want[k].dtype
                        np.testing.assert_array_equal(got[k], want[k])


def test_oracle_copy_equals_reference():
    """The port's Python oracle is the reference's module, byte for byte,
    and gives the same hits and Belady curve."""
    from repro.core import oracle as ro
    from repro_torch.core import oracle as po
    assert (PORT / "core" / "oracle.py").read_bytes() == \
        (ROOT / "src" / "repro" / "core" / "oracle.py").read_bytes()
    assert sorted(po.ORACLES) == sorted(ro.ORACLES)
    keys = rt.zipf_trace(N=40, T=600, alpha=0.9, seed=4)
    sizes = rt.object_sizes(40, seed=4)[keys]
    for name in sorted(ro.ORACLES):
        a = ro.oracle_replay(name, keys, 6, sizes=sizes)
        b = po.oracle_replay(name, keys, 6, sizes=sizes)
        np.testing.assert_array_equal(b["hits"], a["hits"], err_msg=name)
        assert b == {**a, "hits": b["hits"]}, name
    np.testing.assert_array_equal(po.belady_opt(keys, 6),
                                  ro.belady_opt(keys, 6))
