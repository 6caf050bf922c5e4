"""Port parity: the shared-budget multi-tenant tier (``repro_torch.tier``).

``replay_tier`` against the reference's for every arbiter and for
hard-partitioned non-resizing policies on ``tenants(...)`` streams, at
``[T, N]`` and ``[S, T, N]``: per-tenant metrics, time-mean occupancy and
the occupancy trace, exactly.  ``run_tier_sweep`` records equal the
reference's.  The graph loop's bookkeeping holds for the tier's nested
carry (the capture replaced by its body, as on the CPU there is no graph).
Then the laws of ``tests/test_tier.py`` on the port.
"""
import functools

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import bench as rb  # noqa: E402
from repro import tier as rtier  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch.bench import (Scenario, TierScenario,  # noqa: E402
                               TierSweep, results, run_tier_sweep)
from repro_torch.core import Engine, Request, make_policy  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.data.traces import make_trace, tenants_trace  # noqa: E402
from repro_torch.tier import (ARBITERS, CacheTier, make_arbiter,  # noqa: E402
                              replay_tier)
from repro_torch.tier import tier as tier_mod  # noqa: E402

ENGINE = Engine(device="cpu")
N_TENANTS, K0, GROWTH = 4, 8, 4
BUDGET = N_TENANTS * K0 * GROWTH          # static share == K0 * GROWTH


@functools.lru_cache(maxsize=None)
def streams(S=2, T=600, n=N_TENANTS):
    """``[S, T, n]`` tenants(...) keys and lognormal sizes / fetch costs."""
    keys = np.stack([rt.tenants_trace(N=64, T=T, n_tenants=n, period=256,
                                      lo=8, seed=s) for s in range(S)])
    table = rt.object_sizes(64, seed=1)
    return keys, table[keys], rt.fetch_costs(table)[keys]


def assert_result_equal(got, ref, what):
    for f in ref.metrics._fields:
        want = np.asarray(getattr(ref.metrics, f))
        np.testing.assert_array_equal(
            getattr(got.metrics, f).numpy().astype(want.dtype), want,
            err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(got.avg_k.numpy(), np.asarray(ref.avg_k),
                                  err_msg=f"{what}: avg_k")
    if ref.obs is not None:
        np.testing.assert_array_equal(got.obs["k"].numpy(),
                                      np.asarray(ref.obs["k"]),
                                      err_msg=f"{what}: obs k")


ENTRIES = [("dac", "static"), ("dac", "greedy"), ("dac", "proportional"),
           ("dac(k_min=4,eps=0.25)", "greedy"), ("lru", "static"),
           ("climb", "static"), ("admit(dac)", "static"),
           ("sieve", "static")]


@pytest.mark.parametrize("batched", (False, True))
@pytest.mark.parametrize("policy,arbiter", ENTRIES)
def test_replay_tier_equals_reference(policy, arbiter, batched):
    keys, sizes, costs = streams()
    if not batched:
        keys, sizes, costs = keys[1], sizes[1], costs[1]
    budget = 40
    ref = rtier.replay_tier(rtier.CacheTier(policy, n_tenants=N_TENANTS,
                                            budget=budget, arbiter=arbiter),
                            keys, sizes=sizes, costs=costs, observe=True)
    got = replay_tier(CacheTier(policy, n_tenants=N_TENANTS, budget=budget,
                                arbiter=arbiter),
                      keys, sizes=sizes, costs=costs, observe=True,
                      device="cpu")
    assert_result_equal(got, ref, f"{policy}+{arbiter}")
    for name in ("miss_ratio", "byte_miss_ratio", "agg_miss_ratio",
                 "agg_byte_miss_ratio", "agg_penalty_ratio"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("arbiter", ("greedy", "proportional", "static"))
def test_arbiters_equal_reference(arbiter, seed):
    """The port's arbiter on random ``[S, N]`` tier states against the
    reference's, tier by tier."""
    rng = np.random.default_rng(seed)
    S, n, budget = 5, 8, 512
    k = rng.integers(2, budget // n + 1, (S, n)).astype(np.int32)
    demanding = rng.random((S, n)) < 0.6
    got = make_arbiter(arbiter)(torch.from_numpy(k),
                                torch.from_numpy(demanding), budget, n)
    ref = rtier.make_arbiter(arbiter)
    for s in range(S):
        want = ref(jnp.asarray(k[s]), jnp.asarray(demanding[s]), budget, n)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", (7, 64, 2000))
@pytest.mark.parametrize("policy,arbiter", [("dac", "greedy"),
                                            ("lru", "static"),
                                            ("admit(dac)", "static")])
def test_graph_loop_bookkeeping(policy, arbiter, chunk, monkeypatch):
    """The CUDA graph loop's static buffers, copies and eager tail over the
    tier's nested carry and its occupancy sink give the plain loop's
    result (the capture replaced by its body)."""
    keys, sizes, costs = streams()
    tier = CacheTier(policy, n_tenants=N_TENANTS, budget=40, arbiter=arbiter)
    want = replay_tier(tier, keys, sizes=sizes, costs=costs, observe=True,
                       device="cpu")
    monkeypatch.setattr(sim, "_capture", lambda body: body)
    monkeypatch.setattr(tier_mod, "run_steps", lambda run, reqs, carry,
                        sinks, _: sim._replay_graphed(run, reqs, carry,
                                                      sinks, chunk))
    got = replay_tier(tier, keys, sizes=sizes, costs=costs, observe=True,
                      device="cpu")
    for f, x, y in zip(want.metrics._fields, got.metrics, want.metrics):
        assert torch.equal(x, y), f
    assert torch.equal(got.avg_k, want.avg_k)
    assert torch.equal(got.obs["k"], want.obs["k"])


def test_run_tier_sweep_equals_reference():
    kw = dict(entries=(("dac(k_min=4)", "greedy"),
                       ("dac(k_min=4)", "proportional"),
                       ("dac(k_min=4)", "static"), ("lru", "static"),
                       ("fifo", "static")), seeds=(0, 1))
    sc = dict(trace="tenants(N=64,n_tenants=4,period=256,lo=8)", T=500,
              budget=(48, "L"), size_model="lognormal(median_kb=16,sigma=1.5)")
    ref = rb.run_tier_sweep(rb.TierSweep("t", scenarios=(
        rb.TierScenario("flux", **sc),), **kw))
    got = run_tier_sweep(TierSweep("t", scenarios=(TierScenario("flux", **sc),),
                                   **kw), engine=ENGINE)
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in (*ref.records, *got.records)]
    assert strip[:len(ref.records)] == strip[len(ref.records):]
    results.validate(got.payload())


# ---------------------------------------------------------------------------
# the laws of tests/test_tier.py, on the port
# ---------------------------------------------------------------------------

def _mixed_streams(n=N_TENANTS, T=2500, seed=0):
    def one(rng):
        segs = []
        while sum(len(s) for s in segs) < T:
            wide = rng.random() < 0.5
            segs.append(rng.integers(0, 400 if wide else 3, 150))
        return np.concatenate(segs)[:T].astype(np.int32)
    return np.stack([one(np.random.default_rng(seed * 100 + t))
                     for t in range(n)], axis=1)


def test_static_tier_bit_identical_to_independent_replays():
    streams_ = _mixed_streams()
    tier = CacheTier("dac", n_tenants=N_TENANTS, budget=BUDGET,
                     arbiter="static", k0=K0)
    res = replay_tier(tier, streams_, device="cpu")
    single = ENGINE.replay(make_policy("dac"), streams_.T, K0,
                           collect_info=False)
    for f, x, y in zip(single.metrics._fields, res.metrics, single.metrics):
        assert torch.equal(x, y), f


def test_budgeted_step_with_pinned_cap_matches_step():
    pol = make_policy("dac(growth=2)")
    st_a = pol.init(8, device="cpu")
    st_b = dict(pol.init(8, device="cpu"),
                cap=torch.full((1,), 16, dtype=torch.int32))
    rng = np.random.default_rng(3)
    for key in rng.integers(0, 40, 600):
        req = Request.of([int(key)], device="cpu")
        st_a, info_a = pol.step(st_a, req)
        st_b, info_b = pol.step_budgeted(st_b, req)
        for name in ("k", "jump", "cache"):
            assert torch.equal(st_a[name], st_b[name]), name
        assert torch.equal(info_a.hit, info_b.hit)


@pytest.mark.parametrize("arbiter", sorted(ARBITERS))
def test_sum_k_never_exceeds_budget(arbiter):
    streams_ = _mixed_streams(T=3000)
    budget = N_TENANTS * K0 * 2
    if make_arbiter(arbiter).needs_utility:
        with pytest.raises(ValueError, match="utility"):
            CacheTier("dac", n_tenants=N_TENANTS, budget=budget,
                      arbiter=arbiter, k0=K0)
        return
    tier = CacheTier("dac", n_tenants=N_TENANTS, budget=budget,
                     arbiter=arbiter, k0=K0)
    ks = replay_tier(tier, streams_, observe=True,
                     device="cpu").obs["k"].numpy()
    assert ks.shape == (streams_.shape[0], N_TENANTS)
    assert (ks >= tier.policy.k_min).all()
    assert (ks.sum(axis=1) <= budget).all()
    if arbiter != "static":
        assert (ks.max(axis=0) > budget // N_TENANTS).any()


@pytest.mark.parametrize("arbiter", ["greedy", "proportional"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_grants_never_exceed_free_pool(arbiter, seed):
    arb = make_arbiter(arbiter)
    rng = np.random.default_rng(seed)
    n, budget = 8, 512
    k = rng.integers(2, budget // n + 1, n).astype(np.int32)
    demanding = rng.random(n) < 0.6
    caps = arb(torch.from_numpy(k), torch.from_numpy(demanding), budget,
               n).numpy()
    assert (caps >= k).all()
    assert (caps - k).sum() <= max(budget - k.sum(), 0)
    assert (caps[~demanding] == k[~demanding]).all()


def test_static_arbiter_caps_bounded_by_share():
    k = torch.tensor([2, 8, 16, 5], dtype=torch.int32)
    caps = make_arbiter("static")(k, torch.ones(4, dtype=torch.bool),
                                  budget=64, n_tenants=4)
    assert bool((caps <= 16).all()) and bool((caps >= k).all())


def test_over_budget_static_share_rejected():
    with pytest.raises(ValueError, match="exceeds the budget"):
        CacheTier("dac", n_tenants=2, budget=32, arbiter="static(share=32)")
    CacheTier("dac", n_tenants=2, budget=32, arbiter="static(share=8)")


def test_tier_budget_regime_letters_are_usable():
    sc = TierScenario("f", trace="tenants(N=256,n_tenants=4)", T=100,
                      budget=("S", "L"))
    for B in sc.budgets():
        CacheTier("dac", n_tenants=4, budget=B)


def test_non_resizable_policy_requires_static_arbiter():
    with pytest.raises(ValueError, match="static"):
        CacheTier("lru", n_tenants=2, budget=32, arbiter="greedy")
    tier = CacheTier("lru", n_tenants=2, budget=32, arbiter="static")
    streams_ = _mixed_streams(n=2, T=500)
    res = replay_tier(tier, streams_, device="cpu")
    single = ENGINE.replay("lru", streams_.T, 16, collect_info=False)
    assert torch.equal(res.metrics.hits, single.metrics.hits)


def test_tenants_trace_registry_round_trip():
    spec = make_trace("tenants(N=128,n_tenants=4)")
    assert spec.is_tier and spec.n_tenants == 4 and spec.n_keys == 128
    assert make_trace(str(spec)) == spec
    keys = spec.generate(T=200, seed=1)
    assert keys.shape == (200, 4) and keys.dtype == np.int32
    np.testing.assert_array_equal(keys, spec.generate(T=200, seed=1))
    assert spec.generate_batch(T=100, seeds=(0, 1)).shape == (2, 100, 4)
    assert (keys >= 0).all() and (keys < 128).all()


def test_tenants_phase_shift_rotates_wide_phase():
    keys = tenants_trace(N=256, T=4000, n_tenants=4, alpha=0.5,
                         period=4000, duty=0.25, lo=8, seed=0)
    widest = [int(np.argmax([len(np.unique(keys[lo:lo + 1000, t]))
                             for t in range(4)]))
              for lo in range(0, 4000, 1000)]
    assert sorted(widest) == [0, 1, 2, 3], widest


def test_scenario_rejects_tier_family_and_vice_versa():
    with pytest.raises(ValueError, match="TierScenario"):
        Scenario("x", trace="tenants(N=64,n_tenants=2)", T=100)
    with pytest.raises(ValueError, match="multi-tenant"):
        TierScenario("x", trace="zipf(N=64,alpha=1.0)", T=100)


def test_replay_tier_shape_validation():
    tier = CacheTier("dac", n_tenants=4, budget=64)
    with pytest.raises(ValueError, match="n_tenants"):
        replay_tier(tier, np.zeros((100, 3), np.int32), device="cpu")
    with pytest.raises(ValueError, match="T, N"):
        replay_tier(tier, np.zeros((100,), np.int32), device="cpu")
    with pytest.raises(TypeError, match="CacheTier"):
        ENGINE.replay_tier("dac", np.zeros((10, 4), np.int32))


def _tiny_sweep(seeds=(0, 1)):
    sc = TierScenario(
        "flux", trace="tenants(N=64,n_tenants=2,period=512,lo=8)",
        T=600, budget=(32,))
    return TierSweep("tiny", entries=(("dac", "greedy"), ("lru", "static")),
                     scenarios=(sc,), seeds=seeds)


def test_tier_sweep_config_round_trip():
    sw = _tiny_sweep()
    assert TierSweep.from_config(sw.to_config()) == sw


def test_run_tier_sweep_records_and_v2_schema():
    res = run_tier_sweep(_tiny_sweep(), engine=ENGINE)
    assert len(res.records) == 2
    payload = res.payload()
    assert payload["schema"] == results.SCHEMA_V2
    results.validate(payload)
    rec = res.select(policy="dac", arbiter="greedy")[0]
    assert rec["n_tenants"] == 2 and rec["budget"] == 32
    assert len(rec["tenants"]) == 2
    for ten in rec["tenants"]:
        assert len(ten["metrics"]["miss_ratio"]) == 2
        assert len(ten["metrics"]["avg_k"]) == 2


def test_run_tier_sweep_matches_per_seed_loop():
    sw = _tiny_sweep(seeds=(0, 1, 2))
    rec = run_tier_sweep(sw, engine=ENGINE).select(policy="dac",
                                                   arbiter="greedy")[0]
    sc = sw.scenarios[0]
    spec = make_trace(sc.trace)
    tier = CacheTier("dac", n_tenants=2, budget=32, arbiter="greedy")
    for i, seed in enumerate(sw.seeds):
        single = replay_tier(tier, spec.generate(sc.T, seed=seed),
                             device="cpu")
        assert rec["metrics"]["miss_ratio"][i] == float(
            single.agg_miss_ratio)
        for ten in rec["tenants"]:
            assert ten["metrics"]["miss_ratio"][i] == float(
                single.miss_ratio[ten["tenant"]])


def test_v1_schema_rejects_tenant_records():
    payload = results.build_payload(
        "x", config={}, records=[
            {"metrics": {"miss_ratio": [0.1]}, "seeds": [0],
             "tenants": [{"tenant": 0, "metrics": {"miss_ratio": [0.1]}}]}],
        device="cpu")
    with pytest.raises(ValueError, match="v2"):
        results.validate(payload)


def test_v2_schema_rejects_malformed_tenants():
    def v2(records):
        return results.build_payload("x", config={}, records=records,
                                     schema=results.SCHEMA_V2, device="cpu")
    good = {"metrics": {"m": [0.1]}, "seeds": [0],
            "tenants": [{"tenant": 0, "metrics": {"m": [0.1]}}]}
    results.validate(v2([good]))
    bad_missing = {"metrics": {"m": [0.1]},
                   "tenants": [{"metrics": {"m": [0.1]}}]}
    with pytest.raises(ValueError, match="tenant"):
        results.validate(v2([bad_missing]))
    bad_len = {"metrics": {"m": [0.1]}, "seeds": [0],
               "tenants": [{"tenant": 0, "metrics": {"m": [0.1, 0.2]}}]}
    with pytest.raises(ValueError, match="len"):
        results.validate(v2([bad_len]))
