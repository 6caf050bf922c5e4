"""Port parity: the ten slot baselines of the last policy slice.

BLRU, LFU, Clock, Sieve, TwoQ, ARC, TinyLFU, Hyperbolic, LIRS and LHD
against the reference's ``_scan_replay`` on five trace families at two
capacities (one at or below 4), two seeds each: per-step ``StepInfo``
(hits, evicted keys, bytes and penalties) and the final state, exactly.
Each policy's hit sequence is also held against the reference's
step-by-step Python oracle, and a state the reference built mid-trace
continues in the port (``state_from_reference``) to the same result.

The reference replays all lanes of one (policy, K) pair in one jitted
scan, cached for the module, so each case reads its own lanes.
"""
import functools

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import Request as RefRequest  # noqa: E402
from repro.core import make_policy as ref_policy  # noqa: E402
from repro.core.oracle import ORACLES  # noqa: E402
from repro.core.simulator import _scan_replay  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch.core import (POLICIES, Request, make_policy,  # noqa: E402
                              replay_lanes)
from repro_torch.core.state_io import state_from_reference  # noqa: E402

T = 600
SEEDS = (0, 1)
KS = (3, 16)
NEW = ("blru", "lfu", "clock", "sieve", "twoq", "arc", "tinylfu",
       "hyperbolic", "lirs", "lhd")
FAMILIES = ("zipf", "shifting_zipf", "churn", "scan_mix", "narrow_wide")


def trace(family, seed):
    if family == "zipf":
        return rt.zipf_trace(N=96, T=T, alpha=1.0, seed=seed)
    if family == "shifting_zipf":
        return rt.shifting_zipf_trace(N=96, T=T, alpha=0.9, phases=3,
                                      seed=seed)
    if family == "churn":
        return rt.churn_trace(N=96, T=T, alpha=1.1, mean_phase=150,
                              drift=0.3, seed=seed)
    if family == "scan_mix":
        return rt.scan_mix_trace(N=96, T=T, alpha=1.0, scan_frac=0.3,
                                 scan_len=24, seed=seed)
    narrow = rt.zipf_trace(N=4, T=T // 2, alpha=1.2, seed=seed)
    wide = rt.zipf_trace(N=4000, T=T - T // 2, alpha=0.6, seed=seed)
    return np.concatenate([narrow, wide]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def all_keys():
    """``[families x seeds, T]``: lane ``f * len(SEEDS) + s``."""
    return np.stack([trace(f, s) for f in FAMILIES for s in SEEDS])


def lanes_of(family):
    j = FAMILIES.index(family) * len(SEEDS)
    return slice(j, j + len(SEEDS))


def ref_scan(spec, keys, K):
    pol = ref_policy(spec)
    res, st = jax.vmap(lambda r: _scan_replay(
        pol, r, K, observe=False, collect_info=True))(
        RefRequest.of(jnp.asarray(keys)))
    return res, {k: np.asarray(v) for k, v in st.items()}


@functools.lru_cache(maxsize=None)
def ref_run(spec, K):
    return ref_scan(spec, all_keys(), K)


@functools.lru_cache(maxsize=None)
def port_run(spec, K):
    keys = all_keys()
    pol = make_policy(spec)
    st = pol.init(K, lanes=keys.shape[0], device="cpu")
    res, st = replay_lanes(pol, Request.of(keys, device="cpu"), st,
                           collect_info=True)
    return res, {k: v.numpy() for k, v in st.items()}


def test_registry_holds_every_reference_name():
    from repro.core import ALIASES as RA
    from repro.core import POLICIES as RP
    from repro_torch.core import ALIASES
    assert sorted(POLICIES) == sorted(RP)
    assert ALIASES == RA
    for name in NEW:
        assert type(make_policy(name)).__name__ == \
            type(ref_policy(name)).__name__


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("spec", NEW)
def test_steps_and_final_state_match_reference(spec, family, K):
    ref, ref_state = ref_run(spec, K)
    port, port_state = port_run(spec, K)
    lanes = lanes_of(family)
    for f in ref.info._fields:
        np.testing.assert_array_equal(
            getattr(port.info, f).numpy()[lanes],
            np.asarray(getattr(ref.info, f))[lanes], err_msg=f)
    assert set(port_state) == set(ref_state)
    for k in ref_state:
        assert port_state[k].shape == ref_state[k].shape, k
        np.testing.assert_array_equal(port_state[k][lanes],
                                      ref_state[k][lanes], err_msg=k)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("spec", NEW)
def test_state_layout_matches_reference(spec, K):
    """Same key names, shapes and dtypes as the reference's ``init``
    (timestamps of LRU and BLRU int64, as the reference under x64)."""
    ref = ref_policy(spec).init(K)
    port = make_policy(spec).init(K, lanes=1, device="cpu")
    assert set(ref) == set(port)
    for k, v in ref.items():
        assert tuple(port[k].shape) == (1,) + tuple(v.shape), k
        want = str(v.dtype)
        if spec == "blru" and k in ("last", "t"):
            want = "int64"
        assert str(port[k].dtype).removeprefix("torch.") == want, k


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("spec", NEW)
def test_hits_match_python_oracle(spec, K):
    port, _ = port_run(spec, K)
    hits = port.info.hit.numpy()
    keys = all_keys()
    for lane in range(0, keys.shape[0], 3):
        oracle = ORACLES[spec](K)
        want = np.array([oracle.step(int(k)) for k in keys[lane]])
        np.testing.assert_array_equal(hits[lane], want,
                                      err_msg=f"lane {lane}")


@pytest.mark.parametrize("spec", NEW)
def test_reference_state_continues_in_port(spec):
    """The reference replays the first half; its state carries into the
    port, which replays the second half: the same as the reference's
    whole run."""
    K, cut = 16, T // 2
    keys = all_keys()
    _, mid = ref_scan(spec, keys[:, :cut], K)
    pol = make_policy(spec)
    st = state_from_reference(pol, mid, device="cpu")
    res, st = replay_lanes(pol, Request.of(keys[:, cut:], device="cpu"), st,
                           collect_info=True)
    ref, ref_state = ref_run(spec, K)
    np.testing.assert_array_equal(res.info.hit.numpy(),
                                  np.asarray(ref.info.hit)[:, cut:])
    np.testing.assert_array_equal(res.info.evicted_key.numpy(),
                                  np.asarray(ref.info.evicted_key)[:, cut:])
    for k, v in ref_state.items():
        np.testing.assert_array_equal(st[k].numpy(), v, err_msg=k)


def test_tinylfu_hash_matches_reference_on_edge_keys():
    """EMPTY (0xFFFFFFFF as uint32) hashes as 0 + 1 wrapping to 0, and the
    largest int32 key stays exact in int64."""
    keys = np.array([-1, 0, 1, 7, 2**24 + 3, 2**31 - 1], np.int32)
    ref, port = ref_policy("tinylfu"), make_policy("tinylfu")
    for W in (16, 1 << 15):
        want = np.stack([np.asarray(ref._hash(jnp.int32(k), W))
                         for k in keys])
        got = port._hash(torch.tensor(keys), W).numpy()
        np.testing.assert_array_equal(got, want)
