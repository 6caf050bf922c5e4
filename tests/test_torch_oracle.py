"""The port's own Python oracle (``repro_torch.core.oracle``, a copy of the
reference's, held equal to it by ``tests/test_torch_isolation.py``) against
the port's policies: the three laws of ``tests/test_policies_vs_oracle.py``.
Then the three laws of ``tests/test_dac_resize.py`` on the port's DAC (the
stepwise resize invariants, the trajectory through the engine, no shrink
below ``k_min``); the smoke holds them through kernel B1 on the card.

Everything here runs the port alone, on the CPU: it needs no ``jax``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (EMPTY, POLICIES, DynamicAdaptiveClimb, Engine,
                              Request, make_policy)
from repro_torch.core.oracle import (ORACLES, OracleDynamicAdaptiveClimb,
                                     oracle_replay)
from repro_torch.data.traces import (object_sizes, scan_mix_trace,
                                     shifting_zipf_trace, zipf_trace)

ENGINE = Engine(device="cpu")
T = 1500


def _traces():
    """The reference law's six adversarial traces, as the lanes of one
    ``[6, T]`` replay."""
    return {
        "zipf_small_universe": zipf_trace(N=32, T=T, alpha=0.9, seed=1),
        "zipf_big_universe": zipf_trace(N=4096, T=T, alpha=0.8, seed=2),
        "shifting": shifting_zipf_trace(N=256, T=T, alpha=1.1, phases=5,
                                        seed=3),
        "scans": scan_mix_trace(N=128, T=T, alpha=1.0, scan_frac=0.3,
                                scan_len=64, seed=4),
        "uniform": np.random.default_rng(5).integers(
            0, 64, size=T).astype(np.int32),
        "repeat_heavy": np.tile(np.arange(7, dtype=np.int32), T // 7 + 1)[:T],
    }


@pytest.mark.parametrize("K", [4, 16, 33])
@pytest.mark.parametrize("policy_name", sorted(POLICIES))
def test_matches_oracle(policy_name, K):
    traces = _traces()
    got = ENGINE.replay(policy_name, np.stack(list(traces.values())),
                        K).hits.numpy()
    for lane, (tname, trace) in enumerate(traces.items()):
        oracle = ORACLES[policy_name](K)
        expected = np.array([oracle.step(int(k)) for k in trace])
        mism = np.nonzero(expected != got[lane])[0]
        assert mism.size == 0, (
            f"{policy_name} K={K} trace={tname}: first mismatch at "
            f"t={mism[0]} (oracle={expected[mism[:5]]}, "
            f"port={got[lane][mism[:5]]})")


@pytest.mark.parametrize("eps", [0.25, 0.5, 1.0])
def test_dac_eps_matches_oracle(eps):
    K = 16
    trace = shifting_zipf_trace(N=200, T=3000, alpha=1.2, phases=6, seed=7)
    oracle = OracleDynamicAdaptiveClimb(K, eps=eps)
    expected = np.array([oracle.step(int(k)) for k in trace])
    got = ENGINE.replay(f"dac(eps={eps})", trace, K).hits.numpy()
    assert (expected == got).all()


@pytest.mark.parametrize("policy_name", ["lru", "arc",
                                         "dynamicadaptiveclimb"])
def test_sized_metrics_match_oracle(policy_name):
    """Byte-miss and penalty aggregates equal the oracle's replay weighted
    by the same per-object sizes."""
    K = 16
    trace = shifting_zipf_trace(N=128, T=2000, alpha=1.0, phases=4, seed=9)
    sizes = object_sizes(128, seed=9)[trace]
    res = ENGINE.replay(policy_name, trace, K, sizes=sizes, costs=sizes)
    ref = oracle_replay(policy_name, trace, K, sizes=sizes, costs=sizes)
    np.testing.assert_array_equal(res.hits.numpy(), ref["hits"])
    assert res.miss_ratio == pytest.approx(ref["miss_ratio"], rel=1e-6)
    assert res.byte_miss_ratio == pytest.approx(ref["byte_miss_ratio"],
                                                rel=1e-5)
    assert res.total_penalty == pytest.approx(ref["penalty"], rel=1e-5)


# ---------------------------------------------------------------------------
# the DAC resize laws of tests/test_dac_resize.py, on the port
# ---------------------------------------------------------------------------

def _mixed_trace(rng, T=1200):
    """Alternating thrash / concentration segments (grows and shrinks)."""
    segs = []
    while sum(len(s) for s in segs) < T:
        if rng.random() < 0.5:
            segs.append(rng.integers(0, 400, 150))
        else:
            segs.append(rng.integers(0, 3, 150))
    return np.concatenate(segs)[:T].astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("K,eps,growth,k_min", [
    (8, 0.5, 4, 2), (16, 0.25, 2, 2), (16, 1.0, 8, 4), (32, 0.5, 1, 2),
])
def test_resize_invariants_stepwise(seed, K, eps, growth, k_min):
    pol = DynamicAdaptiveClimb(eps=eps, growth=growth, k_min=k_min)
    state = pol.init(K, device="cpu")
    rng = np.random.default_rng(seed)
    prev_k = K
    saw_shrink = saw_grow = False
    for key in _mixed_trace(rng):
        state, _ = pol.step(state, Request.of([int(key)], device="cpu"))
        k = int(state["k"][0])
        jump, jump2 = int(state["jump"][0]), int(state["jump2"][0])
        assert k_min <= k <= K * growth
        assert k in (prev_k, 2 * prev_k, prev_k // 2), (prev_k, k)
        saw_grow |= k == 2 * prev_k
        saw_shrink |= k == prev_k // 2
        # every rank past the active size is EMPTY
        assert bool((state["cache"][0, k:] == EMPTY).all()), k
        assert -(k // 2) <= jump <= 2 * k
        assert -(k // 2) <= jump2 <= 0
        prev_k = k
    if growth > 1:
        assert saw_grow
    assert saw_shrink


@pytest.mark.parametrize("growth", [1, 4])
def test_resize_trajectory_via_engine(growth):
    trace = _mixed_trace(np.random.default_rng(7), T=6000)
    K = 16
    res = ENGINE.replay(f"dac(growth={growth})", trace, K, observe=True)
    ks, jumps = res.obs["k"].numpy(), res.obs["jump"].numpy()
    assert ks.min() >= 2 and ks.max() <= K * growth
    assert (jumps <= 2 * ks).all()
    assert (jumps >= -(ks // 2)).all()
    assert set(np.unique(ks[1:] / ks[:-1])).issubset({0.5, 1.0, 2.0})


def test_shrink_never_below_k_min():
    pol = DynamicAdaptiveClimb(eps=1.0, growth=2, k_min=8)
    state = pol.init(16, device="cpu")
    for key in np.tile(np.arange(2, dtype=np.int32), 500):
        state, _ = pol.step(state, Request.of([int(key)], device="cpu"))
        assert int(state["k"][0]) >= 8
    assert int(state["k"][0]) == 8


def test_oracle_replay_of_every_registered_policy():
    """Every registry name has an oracle, and ``oracle_replay`` lifts it
    over a sized trace."""
    assert set(ORACLES) == set(POLICIES)
    trace = zipf_trace(N=64, T=300, alpha=1.0, seed=0)
    for name in sorted(POLICIES):
        out = oracle_replay(name, trace, 8)
        want = ENGINE.replay(make_policy(name), trace, 8)
        np.testing.assert_array_equal(out["hits"], want.hits.numpy())
        assert torch.is_tensor(want.hits)
