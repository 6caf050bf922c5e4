"""Port parity: the size-aware admission layer (``admit(<base>, ...)``).

The port's ``AdmissionPolicy`` against the reference's ``_scan_replay``
over the four hostile families (flood, scanstorm, diurnal, thrash) with
lognormal and bimodal sizes, for the bases lru, dac and sieve under the
filters off, tinylfu and ghost: per-step hit bits, evicted keys, bytes and
penalties, and the final state (both sketches, the window counters, the
ghost ring and its head, the nested base state), exactly.  A state the
reference built mid-trace continues in the port through
``state_from_reference``.  Then the laws of ``tests/test_admission.py``
on the port, merged into parametrised cases where they repeat.

The reference replays all lanes of one spec in one jitted scan, cached
for the module, so each case reads its own lanes.
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
from repro.core.simulator import _scan_replay  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch.core import (EMPTY, POLICIES, AdmissionPolicy,  # noqa: E402
                              Engine, Request, make_policy, replay_lanes)
from repro_torch.core.admission import FILTERS  # noqa: E402
from repro_torch.core.state_io import (state_from_reference,  # noqa: E402
                                       state_to_numpy)

ENGINE = Engine(device="cpu")
N, T, K = 48, 500, 8
SEEDS = (0, 1)
FAMILIES = ("flood", "scanstorm", "diurnal", "thrash")
SIZINGS = ("lognormal", "bimodal")
BASES = ("lru", "dac", "sieve")


def trace(family, seed):
    if family == "flood":
        return rt.flood_trace(N=N, T=T, alpha=0.9, flood_frac=0.35,
                              burst_len=16, phases=4, seed=seed)
    if family == "scanstorm":
        return rt.scanstorm_trace(N=N, T=T, alpha=0.9, mean_phase=150,
                                  drift=0.2, storm_frac=0.25, scan_len=24,
                                  seed=seed)
    if family == "diurnal":
        return rt.diurnal_trace(N=N, T=T, period=120, lo=6, seed=seed)
    return rt.thrash_trace(N=N, T=T, loop=12, seed=seed)


def size_table(sizing):
    if sizing == "lognormal":
        return rt.object_sizes(2 * N, seed=3)
    return rt.bimodal_sizes(2 * N, seed=3, split=N)


@functools.lru_cache(maxsize=None)
def lanes():
    """``[lanes, T]`` keys, sizes and costs: lane order family-major, then
    sizing, then seed."""
    keys, sizes = [], []
    for fam in FAMILIES:
        for sizing in SIZINGS:
            table = size_table(sizing)
            for s in SEEDS:
                k = trace(fam, s)
                keys.append(k)
                sizes.append(table[k])
    keys, sizes = np.stack(keys), np.stack(sizes)
    return keys, sizes, rt.fetch_costs(sizes)


def lanes_of(family, sizing):
    j = (FAMILIES.index(family) * len(SIZINGS)
         + SIZINGS.index(sizing)) * len(SEEDS)
    return slice(j, j + len(SEEDS))


def ref_scan(spec, keys, sizes, costs, state=None):
    pol = ref_policy(spec)
    reqs = RefRequest.of(jnp.asarray(keys), sizes=sizes, costs=costs)
    if state is None:
        fn = jax.vmap(lambda r: _scan_replay(pol, r, K, observe=False,
                                             collect_info=True))
        res, st = fn(reqs)
    else:
        fn = jax.vmap(lambda r, s: _scan_replay(
            pol, r, K, observe=False, collect_info=True, state=s))
        res, st = fn(reqs, state)
    return res, jax.tree_util.tree_map(np.asarray, st)


@functools.lru_cache(maxsize=None)
def ref_run(spec):
    return ref_scan(spec, *lanes())


@functools.lru_cache(maxsize=None)
def port_run(spec):
    keys, sizes, costs = lanes()
    pol = make_policy(spec)
    reqs = Request.of(keys, sizes=sizes, costs=costs, device="cpu")
    return replay_lanes(pol, reqs, pol.init(K, keys.shape[0], "cpu"))


def assert_tree_equal(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k], f"{where}[{k!r}]")
        else:
            np.testing.assert_array_equal(
                np.asarray(got[k]).astype(np.asarray(want[k]).dtype),
                np.asarray(want[k]), err_msg=f"{where}[{k!r}]")


@pytest.mark.parametrize("sizing", SIZINGS)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("base", BASES)
def test_admission_equals_reference_scan(base, filt, family, sizing):
    spec = f"admit({base},filter={filt})"
    (ref, ref_state), (got, got_state) = ref_run(spec), port_run(spec)
    sl = lanes_of(family, sizing)
    for f in ref.info._fields:
        np.testing.assert_array_equal(
            getattr(got.info, f).numpy()[sl],
            np.asarray(getattr(ref.info, f))[sl], err_msg=f"{spec}: {f}")
    for f in ("requests", "hits"):
        np.testing.assert_array_equal(
            getattr(got.metrics, f).numpy()[sl],
            np.asarray(getattr(ref.metrics, f))[sl], err_msg=f"{spec}: {f}")
    # the float totals of a collect_info replay are sums over the stacked
    # per-step info (equal above), whose order torch.sum and jnp.sum choose
    # differently: rtol 1e-6, the port's documented difference (ROADMAP C)
    for f in ("bytes_total", "bytes_missed", "cost_total", "penalty"):
        np.testing.assert_allclose(
            getattr(got.metrics, f).numpy()[sl],
            np.asarray(getattr(ref.metrics, f))[sl], rtol=1e-6,
            err_msg=f"{spec}: {f}")
    port_np = state_to_numpy(got_state)
    want = jax.tree_util.tree_map(lambda x: x[sl], ref_state)
    got_sl = jax.tree_util.tree_map(lambda x: x[sl], port_np)
    assert_tree_equal(got_sl, want, spec)


@pytest.mark.parametrize("filt", ("tinylfu", "ghost"))
@pytest.mark.parametrize("base", ("lru", "dac"))
def test_gate_rejects_on_hostile_traces(base, filt):
    """The parity above is not vacuous: the gate keeps misses out (a miss
    with no eviction once the bare base evicts on every miss)."""
    got, _ = port_run(f"admit({base},filter={filt})")
    bare, _ = port_run(f"admit({base},filter=off)")
    kept_out = (~got.info.hit & (got.info.evicted_key == EMPTY)
                & (bare.info.evicted_key != EMPTY))
    assert int(kept_out.sum()) > 0


@pytest.mark.parametrize("spec", ("admit(dac)", "admit(lru,filter=tinylfu)",
                                  "admit(sieve,size_norm=false)"))
def test_mid_trace_state_continues_in_the_port(spec):
    """The reference's nested state after T/2 requests, carried into the
    port, gives the reference's second half and final state."""
    keys, sizes, costs = lanes()
    h = T // 2
    ref_half, ref_mid = ref_scan(spec, keys[:, :h], sizes[:, :h],
                                 costs[:, :h])
    ref_rest, ref_end = ref_scan(spec, keys[:, h:], sizes[:, h:],
                                 costs[:, h:], state=jax.tree_util.tree_map(
                                     jnp.asarray, ref_mid))
    pol = make_policy(spec)
    mid = state_from_reference(pol, ref_mid, device="cpu")
    reqs = Request.of(keys[:, h:], sizes=sizes[:, h:], costs=costs[:, h:],
                      device="cpu")
    got, end = replay_lanes(pol, reqs, mid)
    np.testing.assert_array_equal(got.info.hit.numpy(),
                                  np.asarray(ref_rest.info.hit))
    np.testing.assert_array_equal(got.info.evicted_key.numpy(),
                                  np.asarray(ref_rest.info.evicted_key))
    assert_tree_equal(state_to_numpy(end), ref_end, spec)


# ---------------------------------------------------------------------------
# the laws of tests/test_admission.py, on the port
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(7)
KEYS = _rng.integers(0, 48, size=(2, 320)).astype(np.int32)
SIZES = _rng.integers(1, 9000, size=(2, 320)).astype(np.float64)


def _equal(a, b, label):
    assert (a is None) == (b is None)
    if a is None:
        return
    for f, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{label}: {f}"


@pytest.mark.parametrize("lanes_in", ("single", "batched"))
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_filter_off_bit_identical(name, lanes_in):
    """The pass-through wrapper is invisible, per step and per lane, on a
    single-lane replay and on a lane batch."""
    keys, sizes = (KEYS[0], SIZES[0]) if lanes_in == "single" else \
        (KEYS, SIZES)
    wrapped = make_policy(f"admit({name},filter=off)")
    ref = ENGINE.replay(name, keys, 8, sizes=sizes)
    got = ENGINE.replay(wrapped, keys, 8, sizes=sizes)
    _equal(got.info, ref.info, name)
    _equal(got.metrics, ref.metrics, name)


@pytest.mark.parametrize("filt", [f for f in FILTERS if f != "off"])
def test_gated_replay_deterministic(filt):
    """The same trace gives the same decisions, and the lane batch
    reproduces each single-lane replay exactly."""
    pol = make_policy(f"admit(dac,filter={filt})")
    a = ENGINE.replay(pol, KEYS, 8, sizes=SIZES)
    b = ENGINE.replay(pol, KEYS, 8, sizes=SIZES)
    _equal(a.info, b.info, f"repeat/{filt}")
    for lane in range(KEYS.shape[0]):
        single = ENGINE.replay(pol, KEYS[lane], 8, sizes=SIZES[lane])
        for f, x, y in zip(a.info._fields, a.info, single.info):
            assert torch.equal(x[lane], y), f"lane {lane}/{filt}: {f}"


@pytest.mark.parametrize("filt", FILTERS)
def test_hits_never_gated(filt):
    """When everything fits (the victim always EMPTY) the gate never fires:
    any filter replays bit-identically to the bare base."""
    keys = _rng.integers(0, 6, size=400).astype(np.int32)
    ref = ENGINE.replay("lru", keys, 8)
    got = ENGINE.replay(make_policy(f"admit(lru,filter={filt})"), keys, 8)
    _equal(got.info, ref.info, f"fits/{filt}")
    _equal(got.metrics, ref.metrics, f"fits/{filt}")


def test_hit_steps_commit_unchanged():
    res = ENGINE.replay(make_policy("admit(dac)"), KEYS[0], 8,
                        sizes=SIZES[0])
    hit = res.info.hit
    assert bool(hit.any())
    assert bool((res.info.evicted_key[hit] == EMPTY).all())
    assert bool((res.info.bytes_missed[hit] == 0).all())


def test_rejected_miss_still_charges_bytes():
    """A gated miss reports no eviction but still pays its size; and the
    gate did reject (fewer evictions than the bare base)."""
    res = ENGINE.replay(make_policy("admit(lru,filter=tinylfu)"), KEYS[0],
                        8, sizes=SIZES[0])
    miss = ~res.info.hit.numpy()
    np.testing.assert_array_equal(res.info.bytes_missed.numpy()[miss],
                                  SIZES[0][miss])
    bare = ENGINE.replay("lru", KEYS[0], 8, sizes=SIZES[0])
    assert int((res.info.evicted_key != EMPTY).sum()) < \
        int((bare.info.evicted_key != EMPTY).sum())


def test_gating_changes_behaviour():
    bare = ENGINE.replay("lru", KEYS[0], 8, sizes=SIZES[0])
    gated = ENGINE.replay(make_policy("admit(lru)"), KEYS[0], 8,
                          sizes=SIZES[0])
    assert not torch.equal(bare.info.evicted_key, gated.info.evicted_key)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_hasattr_mirrors_base(name):
    base, wrapped = make_policy(name), make_policy(f"admit({name})")
    for attr in ("step_budgeted", "observables"):
        assert hasattr(wrapped, attr) == hasattr(base, attr), attr


def _with_cap(state, cap):
    return dict(state, cap=torch.full((1,), cap, dtype=torch.int32))


def test_step_budgeted_off_parity():
    """filter=off budgeted stepping equals the bare base with the same cap
    threaded through ``state["base"]["cap"]``."""
    wrapped, bare = make_policy("admit(dac,filter=off)"), make_policy("dac")
    sw = {"base": _with_cap(wrapped.init(8, device="cpu")["base"], 12)}
    sb = _with_cap(bare.init(8, device="cpu"), 12)
    for k in KEYS[0][:120]:
        r = Request.of([int(k)], device="cpu")
        sw, iw = wrapped.step_budgeted(sw, r)
        sb, ib = bare.step_budgeted(sb, r)
        assert torch.equal(iw.hit, ib.hit)
        assert torch.equal(iw.evicted_key, ib.evicted_key)
    assert torch.equal(sw["base"]["cache"], sb["cache"])


def test_step_budgeted_gated_runs_and_observes():
    wrapped = make_policy("admit(dac)")
    st = wrapped.init(8, device="cpu")
    st = {"base": _with_cap(st["base"], 12), "adm": st["adm"]}
    for k in KEYS[0][:80]:
        st, _ = wrapped.step_budgeted(st, Request.of([int(k)], device="cpu"))
    obs = wrapped.observables(st)
    assert set(obs) == {"k", "jump"}
    assert int(obs["k"][0]) >= 2


def test_step_budgeted_gated_equals_reference():
    """The gated budgeted path step by step against the reference's, the
    cap pinned below the doubling."""
    spec = "admit(dac(growth=2),filter=ghost)"
    port, ref = make_policy(spec), ref_policy(spec)
    sp = port.init(8, device="cpu")
    sp = {"base": _with_cap(sp["base"], 12), "adm": sp["adm"]}
    sr = ref.init(8)
    sr = {"base": dict(sr["base"], cap=jnp.int32(12)), "adm": sr["adm"]}
    step = jax.jit(ref.step_budgeted)
    for k, size in zip(KEYS[0][:200], SIZES[0][:200]):
        sp, ip = port.step_budgeted(sp, Request.of([int(k)], sizes=[size],
                                                   device="cpu"))
        sr, ir = step(sr, RefRequest.of(jnp.int32(int(k)), sizes=size))
        assert bool(ip.hit[0]) == bool(ir.hit)
        assert int(ip.evicted_key[0]) == int(ir.evicted_key)
    assert_tree_equal(jax.tree_util.tree_map(lambda x: x[0],
                                             state_to_numpy(sp)),
                      jax.tree_util.tree_map(np.asarray, sr), spec)


def test_adapt_keys_keep_controller_live():
    """DAC's resize controller observes rejected misses: a flood of
    oversized one-hit wonders does not freeze ``k`` at its minimum."""
    n = 256
    base = _rng.zipf(1.2, size=2000) % n
    flood = n + np.arange(2000) % n
    mask = _rng.random(2000) < 0.4
    keys = np.where(mask, flood, base).astype(np.int32)
    sizes = np.where(keys >= n, 65536.0, 4096.0)
    res = ENGINE.replay(make_policy("admit(dac)"), keys, 32, sizes=sizes,
                        observe=True)
    assert int(res.obs["k"].max()) > 32


def test_nested_base_spec_survives():
    pol = make_policy("admit(dac(eps=0.25,growth=2),filter=tinylfu,"
                      "size_norm=false)")
    assert isinstance(pol, AdmissionPolicy)
    assert pol.base.eps == 0.25 and pol.base.growth == 2
    assert pol.filter == "tinylfu" and pol.size_norm is False


def test_admit_specs_equal_and_hash():
    a = make_policy("admit(dac(eps=0.25),filter=ghost)")
    b = make_policy("admit(dac(eps=0.25))")
    assert a == b and hash(a) == hash(b)
    assert a != make_policy("admit(dac(eps=0.5))")


@pytest.mark.parametrize("spec", [
    "admit()", "admit(filter=tinylfu)", "admit(lru,filter=sometimes)",
    "admit(lru,rows=9)", "admit(lru,nope=1)", "admit(nosuchpolicy)",
    "admit(lru,ghost_boost=-1)"])
def test_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as ref:
        ref_policy(spec)
    with pytest.raises(ValueError) as port:
        make_policy(spec)
    if "nosuchpolicy" not in spec:       # the known-names lists differ
        assert str(port.value) == str(ref.value)
    else:
        assert "unknown policy" in str(port.value)


def test_estimator_state_shapes_fixed():
    """Sketch width is the power-of-two ceiling of K * width_factor, the
    ghost ring ``ghost_factor * K`` keys, all EMPTY at first; the
    reference's shapes with a lane axis."""
    spec = "admit(lru,width_factor=3,ghost_factor=2)"
    st = make_policy(spec).init(10, lanes=2, device="cpu")
    assert tuple(st["adm"]["sketch"].shape) == (2, 4, 32)
    assert tuple(st["adm"]["bytes"].shape) == (2, 4, 32)
    assert tuple(st["adm"]["ghost"].shape) == (2, 20)
    assert bool((st["adm"]["ghost"] == EMPTY).all())
    ref = ref_policy(spec).init(10)
    for k in ("sketch", "bytes", "ghost", "adds", "window", "head"):
        assert tuple(st["adm"][k].shape[1:]) == ref["adm"][k].shape, k
        assert str(st["adm"][k].dtype).removeprefix("torch.") == \
            str(ref["adm"][k].dtype), k
    off = make_policy("admit(lru,filter=off)")
    assert set(off.init(10, device="cpu")) == {"base"}
