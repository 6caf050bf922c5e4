"""Port parity: the dynamic multi-tenant fleet (``repro_torch.fleet``).

``replay_fleet`` against the reference's unsharded replay for the static,
greedy, proportional and auction arbiters (and hard-partitioned LRU and
FIFO) on ``fleet(...)`` streams with churn, at ``[T, N]`` and
``[S, T, N]``: per-lane metrics, occupancy, alive fractions, penalty
histograms and the occupancy / alive traces.  All of them are compared
exactly, the float telemetry too: the port sums in the reference's order
(the auction's total left to right, time means as a multiply by the
float32 reciprocal, as XLA compiles them), so no tolerance is needed.
``run_fleet_sweep`` records equal the reference's, the penalty buckets
equal the reference's next to every power of two, and the graph loop's
bookkeeping holds for the fleet's nested carry.  Then the single-device
laws of ``tests/test_fleet.py`` on the port (its sharded law is
``tests/test_torch_sharded_fleet.py``; here ``mesh=``'s argument checks).
"""
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import bench as rb  # noqa: E402
from repro import fleet as rfleet  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro.tier import make_arbiter as ref_arbiter  # noqa: E402
from repro_torch.bench import (FleetScenario, FleetSweep,  # noqa: E402
                               Scenario, TierScenario, results,
                               run_fleet_sweep)
from repro_torch.core import Engine  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.data.traces import fleet_trace, tenants_trace  # noqa: E402
from repro_torch.fleet import (BINS, FleetTier, jain_index,  # noqa: E402
                               penalty_bucket, penalty_quantile,
                               replay_fleet, window_records)
from repro_torch.fleet import fleet as fleet_mod  # noqa: E402
from repro_torch.tier import (AuctionArbiter, CacheTier,  # noqa: E402
                              ProportionalArbiter, replay_tier)

ENGINE = Engine(device="cpu")


def _trace(T=3000, n_lanes=8, seed=0, **kw):
    kw.setdefault("rate", 0.02)
    kw.setdefault("mean_session", 500)
    kw.setdefault("lo", 8)
    return fleet_trace(N=128, T=T, n_lanes=n_lanes, seed=seed, **kw)


@functools.lru_cache(maxsize=None)
def churn(S=2, T=1000):
    """``[S, T, 8]`` fleet keys with many arrivals and departures, with
    lognormal sizes and fetch costs (idle positions gather the table's
    last entry, as ``materialize`` does)."""
    keys = np.stack([rt.fleet_trace(N=128, T=T, n_lanes=8, rate=0.03,
                                    mean_session=150, lo=8, seed=s)
                     for s in range(S)])
    table = rt.object_sizes(128, seed=1)
    return keys, table[keys], rt.fetch_costs(table)[keys]


def assert_fleet_equal(got, ref, what):
    for f in ref.metrics._fields:
        want = np.asarray(getattr(ref.metrics, f))
        np.testing.assert_array_equal(
            getattr(got.metrics, f).numpy().astype(want.dtype), want,
            err_msg=f"{what}: {f}")
    for f in ("avg_k", "alive_frac", "hist"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{what}: {f}")
    if ref.obs is not None:
        for f in ("k", "alive"):
            np.testing.assert_array_equal(got.obs[f].numpy(),
                                          np.asarray(ref.obs[f]),
                                          err_msg=f"{what}: obs {f}")


ENTRIES = [("dac(k_min=4)", "auction"), ("dac(k_min=4)", "greedy"),
           ("dac(k_min=4)", "proportional"), ("dac(k_min=4)", "static"),
           ("dac(k_min=8,eps=0.25)", "auction"), ("lru", "static"),
           ("fifo", "static")]


@pytest.mark.parametrize("batched", (False, True))
@pytest.mark.parametrize("policy,arbiter", ENTRIES)
def test_replay_fleet_equals_reference(policy, arbiter, batched):
    keys, sizes, costs = churn()
    if not batched:
        keys, sizes, costs = keys[0], sizes[0], costs[0]
    ref = rfleet.replay_fleet(
        rfleet.FleetTier(policy, n_lanes=8, budget=96, arbiter=arbiter),
        keys, sizes=sizes, costs=costs, observe=True)
    got = replay_fleet(FleetTier(policy, n_lanes=8, budget=96,
                                 arbiter=arbiter),
                       keys, sizes=sizes, costs=costs, observe=True,
                       device="cpu")
    assert_fleet_equal(got, ref, f"{policy}+{arbiter}")
    for q in (0.5, 0.99):
        np.testing.assert_array_equal(got.agg_penalty_quantile(q),
                                      ref.agg_penalty_quantile(q))
        np.testing.assert_array_equal(got.penalty_quantile(q),
                                      ref.penalty_quantile(q))
    np.testing.assert_array_equal(got.jain, ref.jain)


def test_auction_equals_reference_on_random_markets():
    """The port's auction on random ``[S, N]`` markets (utility-priced,
    contended pools) against the reference's, market by market."""
    rng = np.random.default_rng(5)
    S, n = 64, 12
    k = rng.integers(2, 40, (S, n)).astype(np.int32)
    demanding = rng.random((S, n)) < 0.7
    util = (rng.random((S, n)) * rng.choice([1e-3, 1.0, 50.0], (S, n))
            ).astype(np.float32)
    budget = torch.from_numpy(k.sum(-1, keepdims=True)
                              + rng.integers(0, 64, (S, 1)))
    got = AuctionArbiter()(torch.from_numpy(k), torch.from_numpy(demanding),
                           budget, n, utility=torch.from_numpy(util))
    ref = ref_arbiter("auction")
    for s in range(S):
        want = ref(jnp.asarray(k[s]), jnp.asarray(demanding[s]),
                   jnp.int32(int(budget[s, 0])), n,
                   utility=jnp.asarray(util[s]))
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


def test_penalty_bucket_equals_reference_next_to_powers_of_two():
    """``floor(log2(x))`` as the reference rounds it: at 2^j exactly, at
    2^j (1 +- ulp) and a few ulps further, over the tracked range and past
    both clamps, and at random penalties."""
    xs = []
    for j in range(-8, 30):
        p = np.float32(2.0) ** j
        xs.append(p)
        lo = hi = p
        for _ in range(4):
            lo = np.nextafter(lo, np.float32(0))
            hi = np.nextafter(hi, np.float32(np.inf))
            xs += [lo, hi]
    rng = np.random.default_rng(0)
    xs = np.concatenate([np.array(xs, np.float32), np.float32([0.0, 1e-30]),
                         (2.0 ** rng.uniform(-8, 30, 20000)).astype(
                             np.float32)])
    want = np.asarray(jax.jit(rfleet.penalty_bucket)(jnp.asarray(xs)))
    got = penalty_bucket(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, want)
    # the rounding the port reproduces: just below 2^-3 lands in 2^-3's
    # bucket, not the one below
    below = np.nextafter(np.float32(0.125), np.float32(0))
    assert int(penalty_bucket(torch.tensor([below]))[0]) == \
        int(penalty_bucket(torch.tensor([0.125]))[0])


@pytest.mark.parametrize("chunk", (7, 64))
@pytest.mark.parametrize("policy,arbiter", [("dac(k_min=4)", "auction"),
                                            ("lru", "static")])
def test_graph_loop_bookkeeping(policy, arbiter, chunk, monkeypatch):
    """The CUDA graph loop's bookkeeping over the fleet's nested carry and
    its two sinks gives the plain loop's result (the capture replaced by
    its body)."""
    keys, sizes, costs = churn()
    tier = FleetTier(policy, n_lanes=8, budget=96, arbiter=arbiter)
    want = replay_fleet(tier, keys, sizes=sizes, costs=costs, observe=True,
                        device="cpu")
    monkeypatch.setattr(sim, "_capture", lambda body: body)
    monkeypatch.setattr(fleet_mod, "run_steps", lambda run, reqs, carry,
                        sinks, _: sim._replay_graphed(run, reqs, carry,
                                                      sinks, chunk))
    got = replay_fleet(tier, keys, sizes=sizes, costs=costs, observe=True,
                       device="cpu")
    for f, x, y in zip(want.metrics._fields, got.metrics, want.metrics):
        assert torch.equal(x, y), f
    for f in ("avg_k", "alive_frac", "hist"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("k", "alive"):
        assert torch.equal(got.obs[f], want.obs[f]), f


def test_run_fleet_sweep_equals_reference():
    kw = dict(entries=(("dac(k_min=4)", "auction"), ("dac(k_min=4)", "greedy"),
                       ("dac(k_min=4)", "static"), ("lru", "static")),
              seeds=(0, 1))
    sc = dict(trace="fleet(N=64,n_lanes=6,rate=0.02,mean_session=200,lo=8)",
              T=700, budget=(64,), size_model="lognormal(median_kb=16,sigma=1.5)",
              cost_model="fetch(base_ms=2.0,per_mb_ms=8.0)")
    ref = rb.run_fleet_sweep(rb.FleetSweep("f", scenarios=(
        rb.FleetScenario("pool", **sc),), **kw))
    got = run_fleet_sweep(FleetSweep("f", scenarios=(
        FleetScenario("pool", **sc),), **kw), engine=ENGINE)
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in (*ref.records, *got.records)]
    assert strip[:len(ref.records)] == strip[len(ref.records):]
    results.validate(got.payload())


def test_window_records_equal_reference():
    keys = _trace(T=800)
    ref = rfleet.replay_fleet(rfleet.FleetTier("dac(k_min=4)", n_lanes=8,
                                               budget=96), keys,
                              observe=True)
    got = replay_fleet(FleetTier("dac(k_min=4)", n_lanes=8, budget=96), keys,
                       observe=True, device="cpu")
    assert window_records(got.obs, 5) == rfleet.window_records(ref.obs, 5)


def test_mesh_names_the_roadmap():
    # the sharded fleet is ported (ROADMAP A13.1; its law against the
    # reference's is tests/test_torch_sharded_fleet.py): a mesh must be a
    # DeviceMesh, and takes one [T, N] stream
    fl = FleetTier("dac(k_min=4)", n_lanes=8, budget=96)
    with pytest.raises(TypeError, match="DeviceMesh"):
        replay_fleet(fl, _trace(T=50), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="single"):
        replay_fleet(fl, np.stack([_trace(T=50)] * 2), mesh=object(),
                     device="cpu")


# ---------------------------------------------------------------------------
# the single-device laws of tests/test_fleet.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arbiter", ["auction", "greedy", "proportional"])
def test_conservation_under_churn(arbiter):
    fl = FleetTier("dac(k_min=4)", n_lanes=8, budget=96, arbiter=arbiter)
    res = replay_fleet(fl, _trace(), observe=True, device="cpu")
    ks, alive = res.obs["k"].numpy(), res.obs["alive"].numpy()
    assert ks.sum(axis=1).max() <= 96
    assert ks[alive].min() >= 4


def test_departed_lane_returns_slots():
    fl = FleetTier("dac(k_min=4)", n_lanes=8, budget=96)
    res = replay_fleet(fl, _trace(), observe=True, device="cpu")
    ks, alive = res.obs["k"].numpy(), res.obs["alive"].numpy()
    assert (ks[~alive] == 0).all()
    assert (~alive[1:] & alive[:-1]).sum() > 0
    assert int(res.metrics.requests.sum()) == alive.sum()


def test_freed_capacity_is_regranted():
    n, budget, T = 4, 64, 4000
    keys = np.full((T, n), -1, np.int32)
    wide = np.random.default_rng(0).integers(0, 128, size=T).astype(np.int32)
    keys[: T // 4] = wide[: T // 4, None]
    keys[T // 4:, 0] = wide[T // 4:]
    fl = FleetTier("dac(k_min=4)", n_lanes=n, budget=budget,
                   arbiter="auction")
    ks = replay_fleet(fl, keys, observe=True, device="cpu").obs["k"].numpy()
    assert ks.sum(axis=1).max() <= budget
    assert ks[-1, 0] > budget // n
    assert (ks[-1, 1:] == 0).all()


def test_fleet_deterministic():
    keys = _trace(T=2000)
    fl = FleetTier("dac(k_min=4)", n_lanes=8, budget=96, arbiter="auction")
    a = replay_fleet(fl, keys, observe=True, device="cpu")
    b = replay_fleet(fl, keys, observe=True, device="cpu")
    assert torch.equal(a.obs["k"], b.obs["k"])
    for x, y in zip(a.metrics, b.metrics):
        assert torch.equal(x, y)
    assert torch.equal(a.hist, b.hist)


def test_auction_uniform_utility_matches_proportional():
    auction, prop = AuctionArbiter(), ProportionalArbiter()
    rng = np.random.default_rng(1)
    for _ in range(50):
        n = int(rng.integers(2, 9))
        k = torch.from_numpy(rng.integers(0, 32, n).astype(np.int32))
        demanding = torch.from_numpy(rng.integers(0, 2, n).astype(bool))
        budget = int(rng.integers(int(k.sum()), int(k.sum()) + 64))
        assert torch.equal(auction(k, demanding, budget, n),
                           prop(k, demanding, budget, n))


def test_auction_prices_by_utility():
    k = torch.tensor([4, 4, 4, 4], dtype=torch.int32)
    demanding = torch.tensor([True, True, True, False])
    caps = AuctionArbiter()(k, demanding, 28, 4,
                            utility=torch.tensor([9.0, 3.0, 0.0, 5.0]))
    g = (caps - 4).tolist()
    assert g[0] >= g[1] >= g[2]
    assert g[3] == 0
    assert sum(g) <= 28 - 12


def test_batched_seed_axis_matches_single():
    keys = np.stack([_trace(T=1000, seed=s) for s in (0, 1)])
    fl = FleetTier("dac(k_min=4)", n_lanes=8, budget=96)
    batched = replay_fleet(fl, keys, device="cpu")
    for s in range(2):
        single = replay_fleet(fl, keys[s], device="cpu")
        for bx, sx in zip(batched.metrics, single.metrics):
            assert torch.equal(bx[s], sx)
        assert torch.equal(batched.hist[s], single.hist)


def test_non_resizable_requires_static_and_holds_share():
    with pytest.raises(ValueError, match="static"):
        FleetTier("lru", n_lanes=4, budget=64, arbiter="greedy")
    fl = FleetTier("lru", n_lanes=4, budget=64, arbiter="static")
    res = replay_fleet(fl, _trace(n_lanes=4), observe=True, device="cpu")
    ks, alive = res.obs["k"].numpy(), res.obs["alive"].numpy()
    assert (ks[alive] == 16).all() and (ks[~alive] == 0).all()


def test_fleet_tier_validation():
    with pytest.raises(ValueError, match="k_min"):
        FleetTier("dac(k_min=16)", n_lanes=8, budget=64)
    with pytest.raises(ValueError, match="n_lanes"):
        FleetTier("dac", n_lanes=0, budget=64)
    with pytest.raises(TypeError, match="FleetTier"):
        ENGINE.replay_fleet("dac", _trace())
    with pytest.raises(ValueError, match="n_lanes"):
        replay_fleet(FleetTier("dac(k_min=4)", n_lanes=4, budget=64),
                     _trace(n_lanes=8), device="cpu")


def test_scenario_family_routing():
    with pytest.raises(ValueError, match="FleetScenario"):
        Scenario("x", trace="fleet(N=64,n_lanes=2)", T=100)
    with pytest.raises(ValueError, match="multi-tenant"):
        TierScenario("x", trace="fleet(N=64,n_lanes=2)", T=100)
    with pytest.raises(ValueError, match="dynamic-fleet"):
        FleetScenario("x", trace="zipf(N=64,alpha=1.0)", T=100)
    sc = FleetScenario("x", trace="fleet(N=64,n_lanes=2)", T=100)
    assert sc.n_lanes == 2
    assert FleetScenario.from_config(sc.to_config()) == sc
    sw = FleetSweep("w", entries=(("dac", "auction"),), scenarios=(sc,))
    assert FleetSweep.from_config(sw.to_config()) == sw


def test_fleet_trace_has_dead_gap_between_sessions():
    keys = _trace(T=5000, rate=0.05, mean_session=200)
    for lane in range(keys.shape[1]):
        col = keys[:, lane]
        starts = np.flatnonzero((col[1:] >= 0) & (col[:-1] < 0)) + 1
        ends = np.flatnonzero((col[1:] < 0) & (col[:-1] >= 0)) + 1
        for e in ends:
            nxt = starts[starts >= e]
            if nxt.size:
                assert nxt[0] > e


def test_telemetry_quantiles_and_jain():
    hist = np.zeros((BINS,))
    hist[0], hist[10] = 98, 2
    assert penalty_quantile(hist, 0.5) == 0.0
    assert penalty_quantile(hist, 0.99) == pytest.approx(2.0 ** 6)
    assert jain_index(np.array([3.0, 3.0, 3.0])) == pytest.approx(1.0)
    assert jain_index(np.array([6.0, 0.0, 0.0])) == pytest.approx(1 / 3)
    assert jain_index(np.array([5.0, 5.0, 0.0]),
                      mask=np.array([True, True, False])) == \
        pytest.approx(1.0)


def test_fleet_histogram_counts_served_steps():
    fl = FleetTier("dac(k_min=4)", n_lanes=8, budget=96)
    res = replay_fleet(fl, _trace(T=1500), observe=True, device="cpu")
    assert int(res.hist.sum()) == int(res.obs["alive"].sum())


def test_kv_cache_resize_respects_caps():
    """serve side: a ``[B]`` cap vector gates each sequence's doubling in
    the port's ``serving/kv_cache.resize(cap=)``."""
    from repro_torch.serving import kv_cache as kvc
    B, Bmax = 3, 64
    ctrl = kvc.control_init(B, Bmax, k0=8, device="cpu")
    for pos in range(16):
        ctrl, _ = kvc.insert(ctrl, torch.full((B,), pos, dtype=torch.int32))
        ctrl = kvc.resize(ctrl, k_min=4,
                          cap=torch.tensor([8, 12, 64], dtype=torch.int32))
    assert ctrl["k_active"].tolist() == [8, 12, 16]


def test_fleet_matches_tier_on_always_alive_stream():
    keys = tenants_trace(N=64, T=1500, n_tenants=4, lo=8, seed=2)
    budget = 128
    ft = FleetTier("dac(k_min=4)", n_lanes=4, budget=budget,
                   arbiter="static", k0=budget // 4)
    tt = CacheTier("dac(k_min=4)", n_tenants=4, budget=budget,
                   arbiter="static", k0=budget // 4)
    fres = replay_fleet(ft, keys, device="cpu")
    tres = replay_tier(tt, keys, device="cpu")
    assert torch.equal(fres.metrics.hits, tres.metrics.hits)
    assert torch.equal(fres.metrics.requests, tres.metrics.requests)
