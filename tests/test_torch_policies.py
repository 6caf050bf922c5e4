"""Port parity: whole replays of each ported policy.

Per-step ``StepInfo`` and the final state of climb, ac, dac (``step`` and
``step_budgeted``), fifo and lru against the reference on zipf,
shifting-zipf, churn and scan-mix traces from the reference's generators.
Every comparison is exact; DAC's runs include both grows and shrinks.
"""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import Request as RefRequest  # noqa: E402
from repro.core import make_policy as ref_policy  # noqa: E402
from repro.core.simulator import _scan_replay  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch.core import Request, make_policy, replay_lanes  # noqa: E402

T = 600


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
    # narrow then wide: DAC halves on the hits, then doubles on the misses
    narrow = rt.zipf_trace(N=4, T=T // 2, alpha=1.2, seed=seed)
    wide = rt.zipf_trace(N=4000, T=T - T // 2, alpha=0.6, seed=seed)
    return np.concatenate([narrow, wide]).astype(np.int32)


FAMILIES = ("zipf", "shifting_zipf", "churn", "scan_mix", "narrow_wide")
SPECS = ("climb", "ac", "dac(eps=0.5,growth=4)", "dac(eps=0.3,growth=2)",
         "fifo", "lru")


def ref_replay(spec, keys, K):
    pol = ref_policy(spec)
    res, state = jax.vmap(lambda r: _scan_replay(
        pol, r, K, observe=True, collect_info=True))(
        RefRequest.of(jnp.asarray(keys)))
    return res, {k: np.asarray(v) for k, v in state.items()}


def port_replay(spec, keys, K):
    pol = make_policy(spec)
    st = pol.init(K, lanes=keys.shape[0], device="cpu")
    res, state = replay_lanes(pol, Request.of(keys, device="cpu"), st,
                              observe=True, collect_info=True)
    return res, {k: v.numpy() for k, v in state.items()}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("spec", SPECS)
def test_replay_steps_and_final_state_match(spec, family):
    keys = np.stack([trace(family, s) for s in (0, 1)])
    K = 16
    ref, ref_state = ref_replay(spec, keys, K)
    port, port_state = port_replay(spec, keys, K)
    for f in ref.info._fields:
        np.testing.assert_array_equal(getattr(port.info, f).numpy(),
                                      np.asarray(getattr(ref.info, f)),
                                      err_msg=f)
    assert set(ref_state) == set(port_state)
    for k in ref_state:
        np.testing.assert_array_equal(port_state[k], ref_state[k],
                                      err_msg=k)
    if ref.obs is not None:
        for k in ref.obs:
            np.testing.assert_array_equal(port.obs[k].numpy(),
                                          np.asarray(ref.obs[k]))


def test_dac_grows_and_shrinks_in_parity_runs():
    keys = np.stack([trace("narrow_wide", s) for s in (0, 1)])
    port, _ = port_replay("dac(eps=0.5,growth=4)", keys, 16)
    k = port.obs["k"].numpy()
    assert (np.diff(k, axis=1) < 0).any() and (np.diff(k, axis=1) > 0).any()


@pytest.mark.parametrize("cap_kind", ("deny", "partial", "free"))
@pytest.mark.parametrize("family", ("shifting_zipf", "narrow_wide"))
def test_dac_step_budgeted_matches(family, cap_kind):
    """``step_budgeted`` under a fixed per-lane cap (denying, partially
    granting or never binding), step by step."""
    K, growth = 16, 4
    keys = np.stack([trace(family, s) for s in (2, 3)])
    cap = {"deny": K, "partial": 3 * K - 5, "free": K * growth}[cap_kind]
    rpol, ppol = ref_policy("dac(growth=4)"), make_policy("dac(growth=4)")
    rstate = dict(rpol.init(K), cap=jnp.int32(cap))
    rstate = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), rstate)

    def body(st, key):
        return jax.vmap(rpol.step_budgeted)(st, RefRequest.of(key))

    rstate, rinfo = jax.lax.scan(body, rstate, jnp.asarray(keys.T))
    pstate = dict(ppol.init(K, lanes=2, device="cpu"),
                  cap=torch.full((2,), cap, dtype=torch.int32))
    infos = []
    for t in range(keys.shape[1]):
        pstate, info = ppol.step_budgeted(
            pstate, Request.of(keys[:, t], device="cpu"))
        infos.append(info)
    for q, f in enumerate(rinfo._fields):
        got = torch.stack([i[q] for i in infos]).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(rinfo, f)))
    for k in rstate:
        np.testing.assert_array_equal(pstate[k].numpy(),
                                      np.asarray(rstate[k]))
