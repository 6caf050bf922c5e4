"""Port parity: the rank-row primitives and the fused rank step.

``repro_torch.core.policy`` (``find``, ``promote``, ``demote``,
``rank_step``; on CPU tensors ``rank_step`` runs the plain version of the
CUDA kernel) against ``repro.core.policy`` (jnp branch) and, on a few
cases, the reference's Pallas kernel under the interpreter.  Every
comparison is exact.
"""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import make_policy as ref_policy  # noqa: E402
from repro.core import policy as rp  # noqa: E402
from repro.kernels.policy_step import fused_policy_step  # noqa: E402
from repro_torch.core import make_policy as port_policy  # noqa: E402
from repro_torch.core import policy as pp  # noqa: E402
from repro_torch.core.state_io import (state_from_reference,  # noqa: E402
                                       state_to_numpy)
from repro_torch.kernels import policy_step as kps  # noqa: E402

KS = (1, 7, 127, 128, 129, 1000)
PLANS = ("climb", "ac", "dac", "dac_budgeted")


def make_case(plan, K, fill, B, seed, tight=False):
    """A batched reference state ``{name: ndarray[B, ...]}`` for ``plan``
    at capacity ``K`` plus one key per lane: misses, hits at random and
    top ranks, and the ``EMPTY`` key; DAC lanes sit at assorted active
    sizes with scalars on both sides of the grow and shrink thresholds."""
    rng = np.random.default_rng(seed)
    kmax = K
    W = K if tight else rp.lane_pad(K)
    rows = np.full((B, W), -1, np.int32)
    keys = np.zeros(B, np.int32)
    st = {n: np.zeros(B, np.int32) for n in
          ("len", "jump", "jump2", "k", "kmax", "cap")}
    for b in range(B):
        k = K if plan in ("climb", "ac") else max(1, K >> int(rng.integers(3)))
        n = {"empty": 0, "mid": k // 2, "full": k}[fill]
        rows[b, :n] = rng.permutation(10 * K + 10)[:n]
        kind = b % 4
        if kind == 0 or n == 0:
            keys[b] = 10 * K + 20 + b
        elif kind == 1:
            keys[b] = rows[b, rng.integers(n)]
        elif kind == 2:
            keys[b] = rows[b, rng.integers(max(1, n // 4))]
        else:
            keys[b] = -1 if not tight else 10 * K + 40 + b
        half = k // 2
        st["len"][b] = k
        if plan == "ac":
            st["jump"][b] = rng.integers(1, k + 1)
        elif plan.startswith("dac"):
            if b % 3 == 0:
                st["jump"][b], st["jump2"][b] = 2 * k - 1, 0
            elif b % 3 == 1:
                st["jump"][b] = -half + 1
                st["jump2"][b] = -int(np.ceil(np.float32(0.5) * half)) + 1
                if n:
                    keys[b] = rows[b, 0]
            else:
                st["jump"][b] = rng.integers(-half, 2 * k + 1)
                st["jump2"][b] = rng.integers(-half, 1)
            st["k"][b], st["kmax"][b] = k, kmax
            st["cap"][b] = rng.integers(k, 2 * k + 2)
    names = {"climb": ("len",), "ac": ("jump", "len"),
             "dac": ("jump", "jump2", "k", "kmax"),
             "dac_budgeted": ("jump", "jump2", "k", "kmax", "cap")}[plan]
    return dict(cache=rows, **{n: st[n] for n in names}), keys


def ref_step(plan, state, keys):
    pol = ref_policy("dac" if plan.startswith("dac") else plan)
    fn = pol.step_budgeted if plan == "dac_budgeted" else pol.step
    js = {k: jnp.asarray(v) for k, v in state.items()}
    new, info = jax.vmap(fn)(js, rp.Request.of(jnp.asarray(keys)))
    return ({k: np.asarray(v) for k, v in new.items()},
            {f: np.asarray(getattr(info, f)) for f in info._fields})


def port_step(plan, state, keys):
    pol = port_policy("dac" if plan.startswith("dac") else plan)
    fn = pol.step_budgeted if plan == "dac_budgeted" else pol.step
    st = state_from_reference(pol, state, device="cpu")
    new, info = fn(st, pp.Request.of(keys, device="cpu"))
    return (state_to_numpy(new),
            {f: getattr(info, f).numpy() for f in info._fields})


def assert_same(ref, port):
    assert set(ref) == set(port)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("K", KS)
def test_find_promote_demote_match_reference(K):
    rng = np.random.default_rng(K)
    B, W = 5, rp.lane_pad(K)
    rows = np.full((B, W), -1, np.int32)
    for b in range(B):
        n = int(rng.integers(0, K + 1))
        rows[b, :n] = rng.permutation(4 * K + 4)[:n]
    keys = np.where(rng.random(B) < 0.5, rows[:, 0], -1).astype(np.int32)
    keys[0] = 4 * K + 9
    hit, i = pp.find(torch.from_numpy(rows), torch.from_numpy(keys))
    for b in range(B):
        rh, ri = rp.find(jnp.asarray(rows[b]), jnp.int32(keys[b]))
        assert bool(hit[b]) == bool(rh) and int(i[b]) == int(ri)
    src = rng.integers(0, K, size=B).astype(np.int32)
    t = (src * rng.random(B)).astype(np.int32)
    dst = np.minimum(src + rng.integers(0, 3, size=B), K - 1).astype(np.int32)
    got_p = pp.promote(torch.from_numpy(rows), torch.from_numpy(src),
                       torch.from_numpy(t), torch.from_numpy(keys)).numpy()
    got_d = pp.demote(torch.from_numpy(rows), torch.from_numpy(src),
                      torch.from_numpy(dst), torch.from_numpy(keys)).numpy()
    for b in range(B):
        np.testing.assert_array_equal(got_p[b], np.asarray(rp.promote(
            jnp.asarray(rows[b]), src[b], t[b], keys[b])))
        np.testing.assert_array_equal(got_d[b], np.asarray(rp.demote(
            jnp.asarray(rows[b]), src[b], dst[b], keys[b])))


@pytest.mark.parametrize("fill", ("empty", "mid", "full"))
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("plan", PLANS)
def test_rank_step_matches_reference(plan, K, fill):
    """Three consecutive steps of each plan on 8 lanes with per-lane
    scalars: rows, scalars, hit bits and evicted keys agree exactly."""
    state, keys = make_case(plan, K, fill, B=8, seed=K * 7 + len(fill))
    ref_state, port_state = state, state
    for s in range(3):
        ref_state, ref_info = ref_step(plan, ref_state, keys)
        port_state, port_info = port_step(plan, port_state, keys)
        assert_same(ref_state, port_state)
        assert_same(ref_info, port_info)
        keys = np.where(np.arange(len(keys)) % 2 == 0,
                        ref_state["cache"][:, 0], keys + 1).astype(np.int32)


def test_dac_plans_grow_and_shrink():
    """The crafted lanes really cross both resize thresholds."""
    grew = shrank = 0
    for plan in ("dac", "dac_budgeted"):
        for K in (7, 128, 1000):
            state, keys = make_case(plan, K, "mid", B=8, seed=K)
            new, _ = port_step(plan, state, keys)
            grew += int((new["k"] > state["k"]).sum())
            shrank += int((new["k"] < state["k"]).sum())
    assert grew > 0 and shrank > 0


@pytest.mark.parametrize("K", (7, 129, 1000))
def test_rank_step_raw_outputs_on_tight_rows(K):
    """``rank_step`` itself (unmasked evicted occupant, new scalars) on
    rows of width K, against the reference's jnp ``rank_step``."""
    state, keys = make_case("dac", K, "full", B=6, seed=K, tight=True)
    ref_plan = ref_policy("dac")._plan(budgeted=False)
    port_plan = port_policy("dac").plan()
    names = ("jump", "jump2", "k", "kmax")
    got = pp.rank_step(torch.from_numpy(state["cache"]),
                       torch.from_numpy(keys),
                       tuple(torch.from_numpy(state[n]) for n in names),
                       port_plan)
    want = jax.vmap(lambda c, k, *s: rp.rank_step(c, k, s, ref_plan))(
        jnp.asarray(state["cache"]), jnp.asarray(keys),
        *(jnp.asarray(state[n]) for n in names))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("fill", ("empty", "mid", "full"))
@pytest.mark.parametrize("K", (7, 128, 1000))
@pytest.mark.parametrize("plan", PLANS)
def test_step_as_one_request_replay(plan, K, fill):
    """On the card a step is a replay of one request
    (``step_from_replay``); its outputs, the raw evicted occupant
    included, equal the plain step's, which the tests above hold against
    the reference."""
    state, keys = make_case(plan, K, fill, B=8, seed=K + len(fill))
    names = [n for n in state if n != "cache"]
    pol = port_policy("dac" if plan.startswith("dac") else plan)
    port_plan = (pol.plan(budgeted=plan == "dac_budgeted")
                 if plan.startswith("dac") else pol.plan())
    cache = torch.from_numpy(state["cache"])
    scalars = tuple(torch.from_numpy(state[n]) for n in names)
    key = torch.from_numpy(keys).reshape(-1, 1)
    zeros = torch.zeros_like(key)
    out = kps.replay_plain(cache, torch.stack(scalars, -1), key, zeros,
                           zeros.float(), port_plan, collect_info=True,
                           observe=False)
    got = kps.step_from_replay(out, key)
    want = kps.step_plain(cache, key[:, 0], scalars, port_plan)
    assert bool(want[2].any()) or fill == "empty"
    for g, w in zip((got[0], *got[1], *got[2:]),
                    (want[0], *want[1], *want[2:])):
        assert torch.equal(g, w)


def test_wipe_at_lane_boundary():
    """A DAC shrink from k=256 to 128 wipes exactly from rank 128, a
    128-lane tile boundary, as the reference does."""
    K = 512
    rows = np.full((2, K), -1, np.int32)
    rows[:, :256] = np.arange(256)
    state = {"cache": rows, "jump": np.full(2, -127, np.int32),
             "jump2": np.full(2, -63, np.int32), "k": np.full(2, 256, np.int32),
             "kmax": np.full(2, K, np.int32)}
    keys = np.array([3, 200], np.int32)
    ref_state, ref_info = ref_step("dac", state, keys)
    port_state, port_info = port_step("dac", state, keys)
    assert_same(ref_state, port_state)
    assert_same(ref_info, port_info)
    assert port_state["k"].tolist() == [128, 256]
    assert (port_state["cache"][0, 128:] == -1).all()
    assert (port_state["cache"][0, :128] != -1).all()


@pytest.mark.parametrize("plan,K", [("dac", 129), ("dac_budgeted", 256),
                                    ("dac", 7)])
def test_port_matches_pallas_kernel_interpret(plan, K):
    """The reference's Pallas kernel (interpreted; rows padded and sliced
    back by the kernel) agrees with the port's step."""
    state, keys = make_case(plan, K, "full", B=3, seed=K, tight=True)
    names = ("jump", "jump2", "k", "kmax") + (
        ("cap",) if plan == "dac_budgeted" else ())
    ref_plan = ref_policy("dac")._plan(budgeted=plan == "dac_budgeted")
    want = jax.vmap(lambda c, k, *s: fused_policy_step(
        c, k, s, ref_plan, interpret=True))(
        jnp.asarray(state["cache"]), jnp.asarray(keys),
        *(jnp.asarray(state[n]) for n in names))
    got = pp.rank_step(
        torch.from_numpy(state["cache"]), torch.from_numpy(keys),
        tuple(torch.from_numpy(state[n]) for n in names),
        port_policy("dac").plan(budgeted=plan == "dac_budgeted"))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
