"""Port parity: the replay engine.

``repro_torch.core.Engine`` against ``repro.core.Engine``: ``replay`` over
``[T]`` and ``[B, T]`` with ``collect_info`` on and off and ``observe``;
``replay_stream`` with dense and iterator input; ``mrr``/``miss_ratio``;
state carried across from the reference mid-trace.

Tolerances.  Counts and per-step info are compared exactly (the port
counts in int64, the reference in int32: values are compared).  Float
totals are compared exactly where both sides sum in the same order
(``collect_info=False``: one request at a time, as ``_acc_step``) or where
every partial sum is exact (sizes under 256 B, unit costs).  With
``collect_info=True`` and heavy-tailed sizes the reference sums with
``jnp.sum``, whose order XLA chooses, and the port with ``torch.sum``:
there the totals agree to ``rtol=1e-6`` (float32 rounding of a
differently ordered sum).
"""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import Engine as RefEngine  # noqa: E402
from repro.core import Request as RefRequest  # noqa: E402
from repro.core import make_policy as ref_policy  # noqa: E402
from repro.core import miss_ratio as ref_miss_ratio  # noqa: E402
from repro.core import mrr as ref_mrr  # noqa: E402
from repro.core.simulator import _scan_replay  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch.core import (Engine, Request, make_policy,  # noqa: E402
                              miss_ratio, mrr, replay_lanes)
from repro_torch.core.state_io import (state_from_reference,  # noqa: E402
                                       state_to_numpy)

SPECS = ("dac", "ac", "climb", "fifo", "lru")


def inputs(B, T, sized, seed=0):
    keys = np.stack([rt.shifting_zipf_trace(N=200, T=T, alpha=0.9, phases=2,
                                            seed=seed + b) for b in range(B)])
    if sized == "small":       # < 256 B: every float32 partial sum exact
        sizes = (np.arange(400) % 250 + 1)[keys]
        costs = None
    elif sized == "heavy":     # lognormal bytes and fetch costs
        table = rt.object_sizes(400, seed=seed)
        sizes, costs = table[keys], rt.fetch_costs(table)[keys]
    else:
        sizes = costs = None
    return keys, sizes, costs


def port_engine():
    return Engine(device="cpu")


def check_metrics(ref, port, exact):
    for f in ref._fields:
        r = np.asarray(getattr(ref, f))
        p = getattr(port, f)
        p = p.numpy() if torch.is_tensor(p) else np.asarray(p)
        if f in ("requests", "hits") or exact:
            np.testing.assert_array_equal(p, r, err_msg=f)
        else:
            np.testing.assert_allclose(p, r, rtol=1e-6, err_msg=f)


@pytest.mark.parametrize("collect_info", (True, False))
@pytest.mark.parametrize("sized", ("unit", "small", "heavy"))
@pytest.mark.parametrize("spec", SPECS)
def test_replay_batch_matches(spec, sized, collect_info):
    keys, sizes, costs = inputs(3, 400, sized)
    ref = RefEngine().replay(spec, keys, 12, sizes=sizes, costs=costs,
                             observe=True, collect_info=collect_info)
    port = port_engine().replay(spec, keys, 12, sizes=sizes, costs=costs,
                                observe=True, collect_info=collect_info)
    check_metrics(ref.metrics, port.metrics,
                  exact=not collect_info or sized != "heavy")
    if collect_info:
        for f in ref.info._fields:
            np.testing.assert_array_equal(getattr(port.info, f).numpy(),
                                          np.asarray(getattr(ref.info, f)))
    else:
        assert port.info is None
    assert (ref.obs is None) == (port.obs is None)
    if ref.obs is not None:
        for k in ref.obs:
            np.testing.assert_array_equal(port.obs[k].numpy(),
                                          np.asarray(ref.obs[k]))
    np.testing.assert_array_equal(port.miss_ratio, ref.miss_ratio)
    np.testing.assert_allclose(port.byte_miss_ratio, ref.byte_miss_ratio,
                               rtol=0 if not collect_info else 1e-6)


@pytest.mark.parametrize("collect_info", (True, False))
@pytest.mark.parametrize("spec", ("dac(eps=0.5,growth=4)", "fifo"))
def test_replay_single_trace_matches(spec, collect_info):
    keys, sizes, costs = inputs(1, 300, "small")
    ref = RefEngine().replay(spec, keys[0], 8, sizes=sizes[0],
                             observe=True, collect_info=collect_info)
    port = port_engine().replay(spec, keys[0], 8, sizes=sizes[0],
                                observe=True, collect_info=collect_info)
    assert port.metrics.hits.dim() == 0
    check_metrics(ref.metrics, port.metrics, exact=True)
    assert port.hit_ratio == ref.hit_ratio
    assert port.miss_ratio == ref.miss_ratio
    assert port.penalty_ratio == ref.penalty_ratio
    if collect_info:
        np.testing.assert_array_equal(port.hits.numpy(),
                                      np.asarray(ref.hits))
        assert miss_ratio(port.hits) == ref_miss_ratio(ref.hits)
    if ref.obs is not None:
        np.testing.assert_array_equal(port.obs["k"].numpy(),
                                      np.asarray(ref.obs["k"]))


@pytest.mark.parametrize("sized", ("small", "heavy"))
@pytest.mark.parametrize("spec", ("dac", "climb", "lru"))
def test_replay_stream_dense_matches(spec, sized):
    keys, sizes, costs = inputs(2, 700, sized)
    ref = RefEngine().replay_stream(spec, keys, 10, sizes=sizes, costs=costs,
                                    chunk=256, observe=True)
    port = port_engine().replay_stream(spec, keys, 10, sizes=sizes,
                                       costs=costs, chunk=256, observe=True)
    # per-chunk float32 sums in step order, chunks summed in float64
    check_metrics(ref.metrics, port.metrics, exact=True)
    assert port.metrics.requests.dtype == np.int64
    if ref.obs is not None:
        for k in ref.obs:
            np.testing.assert_array_equal(port.obs[k], ref.obs[k])


def test_replay_stream_iterator_matches():
    keys, sizes, costs = inputs(1, 600, "heavy")
    k, s, c = keys[0], sizes[0], costs[0]

    def chunks():
        for lo in range(0, 600, 200):
            yield k[lo:lo + 200], s[lo:lo + 200], c[lo:lo + 200]

    ref = RefEngine().replay_stream("dac", chunks(), 16, observe=True)
    port = port_engine().replay_stream("dac", chunks(), 16, observe=True)
    check_metrics(ref.metrics, port.metrics, exact=True)
    assert port.obs["k"] == ref.obs["k"]
    with pytest.raises(ValueError):
        port_engine().replay_stream("dac", chunks(), 16, chunk=10)


def test_mrr_and_miss_ratio_match():
    for a, b in [(0.2, 0.4), (0.4, 0.2), (0.0, 0.0), (0.3, 0.0), (0.0, 0.3)]:
        assert mrr(a, b) == ref_mrr(a, b)
    hits = np.random.default_rng(0).random(101) < 0.3
    assert miss_ratio(torch.from_numpy(hits)) == ref_miss_ratio(hits)


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine()
    Engine(device="cpu")


def test_unported_policy_names_the_roadmap():
    # admission is ported (ROADMAP A8) and so is the sharded fleet (A13.1):
    # a mesh passes through Engine.replay_fleet and must be a DeviceMesh
    assert make_policy("admit(dac,filter=tinylfu)").name == "admit"
    from repro_torch.fleet import FleetTier
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(device="cpu").replay_fleet(
            FleetTier("dac(k_min=4)", n_lanes=2, budget=32),
            np.zeros((8, 2), np.int32), mesh=object())
    with pytest.raises(ValueError, match="unknown policy"):
        make_policy("nope")


def test_request_rejects_oversized_sizes():
    with pytest.raises(ValueError, match="int32"):
        Request.of([1, 2], sizes=np.array([1, 2**31]), device="cpu")


@pytest.mark.parametrize("spec", ("dac(eps=0.5,growth=4)", "ac", "climb",
                                  "fifo", "lru"))
def test_state_carried_across_mid_trace(spec):
    """Replay half a trace in the reference, carry its state into the port
    and finish there: the same as the reference finishing it."""
    keys, sizes, _ = inputs(2, 600, "small", seed=3)
    pol_r, pol_p = ref_policy(spec), make_policy(spec)
    first, second = keys[:, :300], keys[:, 300:]

    def ref_run(k, state):
        return jax.vmap(lambda r, st: _scan_replay(
            pol_r, r, 12, observe=False, collect_info=True, state=st))(
            RefRequest.of(jnp.asarray(k)), state)

    _, mid = jax.vmap(lambda r: _scan_replay(
        pol_r, r, 12, observe=False, collect_info=True))(
        RefRequest.of(jnp.asarray(first)))
    ref_res, ref_end = ref_run(second, mid)
    carried = state_from_reference(
        pol_p, {k: np.asarray(v) for k, v in mid.items()}, device="cpu")
    port_res, port_end = replay_lanes(
        pol_p, Request.of(second, device="cpu"), carried, collect_info=True)
    np.testing.assert_array_equal(port_res.info.hit.numpy(),
                                  np.asarray(ref_res.info.hit))
    np.testing.assert_array_equal(port_res.info.evicted_key.numpy(),
                                  np.asarray(ref_res.info.evicted_key))
    end = state_to_numpy(port_end)
    for k in ref_end:
        np.testing.assert_array_equal(end[k], np.asarray(ref_end[k]))
