"""Port parity: the sweep and report layer (``repro_torch.bench``).

``Scenario`` / ``Sweep`` configs, ``materialize`` and ``stream_chunks``
against the reference's; the port's ``run_sweep`` records against the
reference's ``run_sweep`` records for all 15 policies on a synthetic
scenario (lognormal sizes, fetch costs) and on a corpus file, through the
port's materialized and streamed paths; the report tables on equal
records; payload validation.

Tolerances.  Counts, and so miss and hit ratios, are exact.  Byte and
penalty ratios are exact on the corpus file, whose sizes keep every
float32 running sum exact, and within ``rtol=1e-6`` on lognormal sizes
(ROADMAP's stated tolerance for float32 sums).  ``wall_s`` and the
provenance differ by design and are not compared.
"""
import copy
import functools
import json

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import bench as rb  # noqa: E402
from repro_torch import bench as pb  # noqa: E402
from repro_torch.bench import results as presults  # noqa: E402
from repro_torch.core import Engine  # noqa: E402

POLICIES = ("dynamicadaptiveclimb", "adaptiveclimb", "sieve", "arc",
            "tinylfu", "twoq", "lirs", "lhd", "lfu", "hyperbolic", "clock",
            "climb", "lru", "blru", "fifo")
CORPUS = "benchmarks/corpus/kv.csv.gz"


def scenarios(mod):
    return (
        mod.Scenario("zipf", trace="zipf(N=300,alpha=0.9)", T=400,
                     K=("L", 6), size_model="lognormal(median_kb=8)",
                     cost_model="fetch"),
        mod.Scenario("kv", trace=f"file(path={CORPUS})", T=500, K=("L",)),
    )


def sweep(mod):
    return mod.Sweep("parity", policies=POLICIES, scenarios=scenarios(mod),
                     seeds=(0, 1), observe=True)


@functools.lru_cache(maxsize=None)
def ref_records():
    return rb.run_sweep(sweep(rb), stream=False).records


@functools.lru_cache(maxsize=None)
def port_records(stream):
    return pb.run_sweep(sweep(pb), engine=Engine(device="cpu"),
                        stream=stream).records


def test_configs_equal_reference():
    assert sweep(pb).to_config() == sweep(rb).to_config()
    for ref, port in zip(scenarios(rb), scenarios(pb)):
        assert port.to_config() == ref.to_config()
        assert port.capacities() == ref.capacities()
        assert pb.Scenario.from_config(port.to_config()) == port
    assert list(sweep(pb).cells())[5][2:] == list(sweep(rb).cells())[5][2:]
    tier = dict(name="flux", trace="tenants(N=256,n_tenants=4)", T=1000,
                budget=(64, "S"), size_model="bimodal", cost_model="fetch")
    assert pb.TierScenario(**tier).to_config() == \
        rb.TierScenario(**tier).to_config()
    assert pb.TierScenario(**tier).budgets() == \
        rb.TierScenario(**tier).budgets()
    fleet = dict(name="pool", trace="fleet(N=256,n_lanes=4)", T=1000,
                 budget=(64, "L"))
    assert pb.FleetScenario(**fleet).to_config() == \
        rb.FleetScenario(**fleet).to_config()
    for mod in (pb, rb):
        mod_tier = mod.TierSweep("t", entries=(("dac", "greedy"),),
                                 scenarios=(mod.TierScenario(**tier),))
        mod_fleet = mod.FleetSweep("f", entries=(("dac", "auction"),),
                                   scenarios=(mod.FleetScenario(**fleet),))
        configs = (mod_tier.to_config(), mod_fleet.to_config())
        if mod is pb:
            port_configs = configs
    assert port_configs == configs
    serve = dict(name="kv", arch="deepseek-7b", prompt=96, gen=32)
    assert pb.ServeScenario(**serve).to_config() == \
        rb.ServeScenario(**serve).to_config()
    assert pb.ServeScenario(**serve).budgets() == \
        rb.ServeScenario(**serve).budgets()
    assert (pb.SMALL_FRAC, pb.LARGE_FRAC) == (rb.SMALL_FRAC, rb.LARGE_FRAC)
    assert sorted(pb.SIZE_MODELS) == sorted(rb.SIZE_MODELS)
    assert sorted(pb.COST_MODELS) == sorted(rb.COST_MODELS)


@pytest.mark.parametrize("bad", [
    dict(trace="tenants(N=64,n_tenants=2)"), dict(cost_model="fetch"),
    dict(size_model="nope"), dict(trace="nope(N=3)"),
    dict(trace=f"file(path={CORPUS})", T=10**7)])
def test_scenario_errors_match_reference(bad):
    kw = dict(name="x", trace="zipf(N=64,alpha=1.0)", T=100)
    kw.update(bad)
    with pytest.raises(ValueError) as ref:
        rb.Scenario(**kw)
    with pytest.raises(ValueError) as port:
        pb.Scenario(**kw)
    # the port's messages name its own layers after the dash
    assert str(port.value).split(" — ")[0] == str(ref.value).split(" — ")[0]


@pytest.mark.parametrize("which", (0, 1))
def test_materialize_and_stream_chunks_equal_reference(which):
    ref_sc, port_sc = scenarios(rb)[which], scenarios(pb)[which]
    ref = rb.materialize(ref_sc, seeds=(0, 1))
    port = pb.materialize(port_sc, seeds=(0, 1), device="cpu")
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    chunks = list(pb.stream_chunks(port_sc, (0, 1), chunk=128,
                                   device="cpu"))
    for r, p in zip(ref, zip(*chunks)):
        np.testing.assert_array_equal(torch.cat(p, -1).numpy(),
                                      np.asarray(r))
    assert pb.should_stream(port_sc) == rb.should_stream(ref_sc)


def _cell(records, policy, scenario, k_label):
    (rec,) = [r for r in records if (r["policy"], r["scenario"],
                                     r["K_label"]) == (policy, scenario,
                                                       k_label)]
    return rec


@pytest.mark.parametrize("stream", (False, True),
                         ids=("materialized", "streamed"))
@pytest.mark.parametrize("policy", POLICIES)
def test_run_sweep_records_equal_reference(policy, stream):
    ref, port = ref_records(), port_records(stream)
    assert len(port) == len(ref)
    for r in (r for r in ref if r["policy"] == policy):
        p = _cell(port, policy, r["scenario"], r["K_label"])
        assert {k: v for k, v in p.items() if k not in ("metrics",
                                                         "wall_s")} == \
            {k: v for k, v in r.items() if k not in ("metrics", "wall_s")}
        assert sorted(p["metrics"]) == sorted(r["metrics"])
        exact = r["scenario"] == "kv"
        for name, want in r["metrics"].items():
            if exact or name in ("miss_ratio", "hit_ratio", "avg_k"):
                assert p["metrics"][name] == want, name
            else:
                np.testing.assert_allclose(p["metrics"][name], want,
                                           rtol=1e-6, err_msg=name)


def test_report_tables_equal_reference():
    recs = copy.deepcopy(ref_records())
    pols = list(POLICIES)
    for fn, args in (("mrr_matrix", (recs, pols)),
                     ("winners", (recs, pols)),
                     ("metric_cdf", (recs, pols)),
                     ("robustness_frontier", (recs, pols)),
                     ("pivot", (recs, "byte_miss_ratio", pols))):
        assert getattr(pb.report, fn)(*args) == \
            getattr(rb.report, fn)(*args), fn
    assert pb.report.winners(recs, pols, margin=True) == \
        rb.report.winners(recs, pols, margin=True)
    tier = [{"policy": p, "arbiter": a, "scenario": "flux",
             "budget_label": "S", "budget": 64, "seeds": [0, 1],
             "metrics": {"byte_miss_ratio": [m, m / 2]},
             "tenants": [{"tenant": 0, "metrics": {
                 "avg_k": [4.0, 6.0], "miss_ratio": [m, m],
                 "byte_miss_ratio": [m, m]}}]}
            for p, a, m in [("fifo", "static", 0.5), ("dac", "greedy", 0.25),
                            ("lru", "static", 0.25)]]
    entries = [("dac", "greedy"), ("lru", "static")]
    assert pb.report.tier_mrr_matrix(tier, entries) == \
        rb.report.tier_mrr_matrix(tier, entries)
    assert pb.report.tier_winners(tier, entries, margin=True) == \
        rb.report.tier_winners(tier, entries, margin=True)
    assert pb.report.tenant_occupancy(tier[1]) == \
        rb.report.tenant_occupancy(tier[1])
    ks = np.arange(24).reshape(12, 2)
    assert pb.report.occupancy_timeline(ks, 5) == \
        rb.report.occupancy_timeline(ks, 5)
    ref_lines, port_lines = [], []
    table = rb.report.mrr_matrix(recs, pols)
    rb.report.print_table(table, pols, out=ref_lines.append)
    pb.report.print_table(table, pols, out=port_lines.append)
    assert port_lines == ref_lines


def test_payload_validates_and_round_trips(tmp_path):
    res = pb.run_sweep(sweep(pb), engine=Engine(device="cpu"))
    assert (presults.SCHEMA_V1, presults.SCHEMA_V2) == \
        (rb.results.SCHEMA_V1, rb.results.SCHEMA_V2)
    payload = res.save(extras={"n": 1}, results_dir=str(tmp_path))
    assert payload["provenance"]["backend"] == "cpu"
    assert payload["config"] == sweep(rb).to_config()
    path = tmp_path / "parity.json"
    assert presults.load(str(path)) == json.loads(json.dumps(payload))
    v2 = res.payload(schema=presults.SCHEMA_V2)
    assert presults.validate(v2)["schema"] == rb.results.SCHEMA_V2


def _mutations():
    def drop(key):
        return lambda p: p.pop(key)

    def rec(fn):
        return lambda p: fn(p["records"][0])

    return {
        "schema": lambda p: p.update(schema="repro.bench.result/v9"),
        "no_records": drop("records"),
        "no_provenance_torch": lambda p: p["provenance"].pop("torch"),
        "provenance_count_str": lambda p: p["provenance"].update(
            device_count="1"),
        "no_metrics": rec(lambda r: r.pop("metrics")),
        "empty_metric": rec(lambda r: r["metrics"].update(miss_ratio=[])),
        "seed_length": rec(lambda r: r["metrics"].update(
            miss_ratio=[0.5, 0.5, 0.5])),
        "bool_metric": rec(lambda r: r["metrics"].update(
            miss_ratio=[True, False])),
        "seeds_not_ints": rec(lambda r: r.update(seeds=["a", "b"])),
        "K_float": rec(lambda r: r.update(K=1.5)),
        "tenants_in_v1": rec(lambda r: r.update(
            tenants=[{"tenant": 0, "metrics": {"miss_ratio": [0.1, 0.2]}}])),
        "record_not_dict": lambda p: p["records"].append(3),
    }


@pytest.mark.parametrize("name", sorted(_mutations()))
def test_malformed_payload_is_refused(name):
    recs = [r for r in port_records(False) if r["policy"] == "lru"]
    payload = presults.build_payload("x", config={}, records=recs,
                                     device="cpu")
    presults.validate(payload)
    bad = copy.deepcopy(payload)
    _mutations()[name](bad)
    with pytest.raises(ValueError, match="result schema violation"):
        presults.validate(bad)


def test_tier_and_fleet_runners_name_the_roadmap():
    # the tier and fleet runners are ported (ROADMAP A9, A10) and exported;
    # so is the fleet's lane sharding (A13.1), whose mesh must be a
    # DeviceMesh, as run_sweep's must
    from repro_torch.bench import runner
    assert pb.run_tier_sweep is runner.run_tier_sweep
    assert pb.run_fleet_sweep is runner.run_fleet_sweep
    from repro_torch.fleet import FleetTier, replay_fleet
    with pytest.raises(TypeError, match="DeviceMesh"):
        replay_fleet(FleetTier("dac(k_min=4)", n_lanes=2, budget=32),
                     np.zeros((8, 2), np.int32), mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        runner.run_sweep(pb.Sweep("m", policies=("lru",), seeds=(0, 1),
                                  scenarios=(pb.Scenario(
                                      "z", trace="zipf(N=64,alpha=1.0)",
                                      T=50, K=(8,)),)), mesh=object())
