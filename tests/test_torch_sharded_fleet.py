"""The port's sharded fleet (``replay_fleet(mesh=...)``) against the
reference's own sharded fleet, bit for bit.

The reference's sharded replay (``src/repro/fleet/fleet.py::
_replay_fleet_sharded``) runs in a subprocess with 4 forced XLA host
devices.  On this jax its ``_shard_map`` hands ``manual_axes`` as a tuple
to ``jax.shard_map(axis_names=...)``, which now wants a set, so the
subprocess wraps it to pass ``frozenset(manual_axes)`` (a test-side shim;
the reference is not edited).  The port runs in a 4-rank gloo world on
the CPU (a ``file://`` rendezvous under ``tmp_path``), in the eager loop
and, for the shorter cases, in the graph loop's bookkeeping (the capture
replaced by its body, 32 steps a graph, so the re-deal steps cut the
chunks, also where ``rebalance`` is not a multiple of 32).  Metrics, ``avg_k``,
``alive_frac``, the histograms and the observed ``k`` and ``alive`` must
equal the reference's exactly, float telemetry included.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

import _torch_worlds as worlds  # noqa: E402
from repro_torch.fleet import FleetTier, replay_fleet  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
# (policy, arbiter, budget, rebalance, T); the first is the reference
# test's own (test_fleet.py::test_sharded_fleet_conserves_and_rebalances)
CASES = [("dac(k_min=4)", "auction", 96, 200, 2500),
         ("dac(k_min=4)", "greedy", 96, 75, 600),
         ("dac(k_min=4)", "proportional", 120, 33, 500),
         ("dac(k_min=4)", "static", 96, 200, 300)]
GRAPH_MAX_T = 1000      # the graph loop's bookkeeping at these T
FIELDS = ("requests", "hits", "bytes_total", "bytes_missed", "cost_total",
          "penalty", "avg_k", "alive_frac", "hist", "obs.k", "obs.alive")

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import Mesh
import repro.fleet.fleet as ff
from repro.train.train_step import _shard_map
# the shim: jax.shard_map(axis_names=) takes a set, not the tuple the
# reference passes
ff._shard_map = (lambda f, mesh, in_specs, out_specs, manual_axes:
                 _shard_map(f, mesh, in_specs, out_specs,
                            frozenset(manual_axes)))
from repro.data.traces import fleet_trace
from repro.fleet import FleetTier, replay_fleet
cases, out_file = eval(sys.argv[1]), sys.argv[2]
mesh = Mesh(np.array(jax.devices()), ("data",))
out = {}
for i, (pol, arb, budget, rebalance, T) in enumerate(cases):
    keys = fleet_trace(N=128, T=T, n_lanes=8, rate=0.02, mean_session=500,
                       lo=8, seed=0)
    fl = FleetTier(pol, n_lanes=8, budget=budget, arbiter=arb)
    res = replay_fleet(fl, keys, observe=True, mesh=mesh,
                       rebalance=rebalance)
    for f, x in zip(res.metrics._fields, res.metrics):
        out[f"{i}/{f}"] = np.asarray(x)
    out[f"{i}/avg_k"] = np.asarray(res.avg_k)
    out[f"{i}/alive_frac"] = np.asarray(res.alive_frac)
    out[f"{i}/hist"] = np.asarray(res.hist)
    out[f"{i}/obs.k"] = np.asarray(res.obs["k"])
    out[f"{i}/obs.alive"] = np.asarray(res.obs["alive"])
errors = []
short = FleetTier("dac(k_min=16)", n_lanes=8, budget=128)
short.budget = 120      # below the constructor's floor (see the test)
for tier, n_lanes in ((FleetTier("dac(k_min=4)", n_lanes=6, budget=96), 6),
                      (short, 8)):
    keys = fleet_trace(N=128, T=50, n_lanes=n_lanes, rate=0.02,
                       mean_session=500, lo=8, seed=0)
    try:
        replay_fleet(tier, keys, mesh=mesh)
    except ValueError as e:
        errors.append(str(e))
out["errors"] = np.array(errors)
np.savez(out_file, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_fleet") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, repr(CASES),
                          str(out)], env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    return np.load(out)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    init = tmp_path_factory.mktemp("port_fleet") / "init"
    return M.launch_world(worlds.fleet_world, 4, (CASES, 32, GRAPH_MAX_T),
                          init_file=str(init), device="cpu",
                          timeout=TIMEOUT)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sharded_fleet_equals_reference(reference, port, case):
    """4 shards of 8 lanes: every rank's gathered result, eager and
    through the graph loop, equals the reference's sharded replay."""
    for out in port:
        eager, graphed = out[CASES[case]]
        for f in FIELDS:
            want = reference[f"{case}/{f}"]
            runs = [("eager", eager)] + ([("graph", graphed)]
                                          if graphed is not None else [])
            for name, got in runs:
                np.testing.assert_array_equal(
                    got[f], want.astype(got[f].dtype),
                    err_msg=f"{CASES[case]} {name} {f}")
        assert (graphed is None) == (CASES[case][4] > GRAPH_MAX_T)
    ks = port[0][CASES[case]][0]["obs.k"]
    assert ks.shape == (CASES[case][4], 8)
    assert ks.sum(axis=1).max() <= CASES[case][2]


def test_sharded_fleet_guards(reference, port):
    """Lanes that do not divide over the shards, and a per-shard budget
    that cannot float its lanes at ``k_min``, raise the reference's
    ``ValueError`` s.  ``FleetTier`` itself refuses ``budget // n_lanes <
    k_min``, which keeps the per-shard guard from firing for a tier it
    built, so the test lowers a built tier's budget to reach it."""
    want = list(reference["errors"])
    assert len(want) == 2
    for out in port:
        assert [out["errors"]["lanes"], out["errors"]["budget"]] == want
    assert "per-shard" in want[1] and "divide evenly" in want[0]


def test_sharded_fleet_argument_errors():
    """A mesh that is not a ``DeviceMesh`` raises ``TypeError``; a mesh
    takes one ``[T, N]`` stream."""
    fl = FleetTier("dac(k_min=4)", n_lanes=2, budget=32)
    with pytest.raises(TypeError, match="DeviceMesh"):
        replay_fleet(fl, np.zeros((8, 2), np.int32), mesh=object(),
                     device="cpu")
    with pytest.raises(ValueError, match="single"):
        replay_fleet(fl, np.zeros((2, 8, 2), np.int32), mesh=object(),
                     device="cpu")
