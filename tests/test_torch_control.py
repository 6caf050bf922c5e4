"""Port parity: Alg. 2's scalar control law.

``repro_torch.core.control`` against ``repro.core.control`` over
exhaustive grids of small int32 domains (``jump``, ``jump2``, ``i``,
``k``), with and without an arbiter ``cap``, for several ``eps``; every
output must be equal.  The shrink threshold rounds ``eps`` to float32
before the multiply, which a wide ``k`` sweep checks.
"""
import itertools

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import control as rc  # noqa: E402
from repro_torch.core import control as pc  # noqa: E402


def grid(**axes):
    """Flattened cartesian product of int32 axes."""
    mesh = np.meshgrid(*axes.values(), indexing="ij")
    return {k: m.ravel().astype(np.int32) for k, m in zip(axes, mesh)}


def both(x):
    return jnp.asarray(x), torch.from_numpy(x)


def assert_outputs_equal(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for r, p in zip(ref_out, port_out):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


G = grid(jump=np.arange(-9, 18), jump2=np.arange(-9, 3), i=np.arange(0, 9),
         k=np.arange(1, 9))


def test_hit_update_exhaustive():
    rj, pj = both(G["jump"])
    r2, p2 = both(G["jump2"])
    ri, pi = both(G["i"])
    rk, pk = both(G["k"])
    assert_outputs_equal(rc.hit_update(rj, r2, ri, rk),
                         pc.hit_update(pj, p2, pi, pk))


def test_miss_update_exhaustive():
    rj, pj = both(G["jump"])
    r2, p2 = both(G["jump2"])
    rk, pk = both(G["k"])
    assert_outputs_equal(rc.miss_update(rj, r2, rk),
                         pc.miss_update(pj, p2, pk))


@pytest.mark.parametrize("k_min", (1, 2))
@pytest.mark.parametrize("eps", (0.25, 0.5, 0.3))
@pytest.mark.parametrize("capped", (False, True))
def test_resize_update_exhaustive(eps, k_min, capped):
    g = grid(jump=np.arange(-12, 26), jump2=np.arange(-12, 3),
             k=np.arange(1, 13), kmax=np.array([4, 7, 16, 24]),
             cap=np.arange(0, 26) if capped else np.array([0]))
    rj, pj = both(g["jump"])
    r2, p2 = both(g["jump2"])
    rk, pk = both(g["k"])
    rm, pm = both(g["kmax"])
    rcap, pcap = both(g["cap"]) if capped else (None, None)
    assert_outputs_equal(
        rc.resize_update(rj, r2, rk, eps=eps, k_min=k_min, kmax=rm, cap=rcap),
        pc.resize_update(pj, p2, pk, eps=eps, k_min=k_min, kmax=pm,
                         cap=pcap))


@pytest.mark.parametrize("eps", (0.1, 0.3, 0.7, 1 / 3))
def test_shrink_threshold_rounds_eps_to_float32(eps):
    """Over a wide k sweep the shrink decision sits exactly on the
    threshold, where a float64 product would flip some of them."""
    k = np.arange(2, 40001, dtype=np.int32)
    half = k // 2
    thresh = -np.ceil(np.float32(eps) * half.astype(np.float32)).astype(
        np.int32)
    jump, jump2 = -half, thresh
    out_r = rc.resize_update(jnp.asarray(jump), jnp.asarray(jump2),
                             jnp.asarray(k), eps=eps, k_min=1,
                             kmax=jnp.asarray(4 * k))
    out_p = pc.resize_update(torch.from_numpy(jump), torch.from_numpy(jump2),
                             torch.from_numpy(k), eps=eps, k_min=1,
                             kmax=torch.from_numpy(4 * k))
    assert_outputs_equal(out_r, out_p)
    assert bool(out_p[4].all())          # every lane on the threshold shrinks


@pytest.mark.parametrize("i,k", list(itertools.product((0, 1, 5), (1, 2, 9))))
def test_dac_plan_matches_reference_per_scalar(i, k):
    """The whole DAC plan (both paths, resize and wipe) on a scalar grid,
    through the policies' own plan functions."""
    from repro.core import make_policy as ref_policy
    from repro_torch.core import make_policy as port_policy
    g = grid(jump=np.arange(-6, 2 * k + 2), jump2=np.arange(-6, 2),
             kmax=np.array([k, 2 * k, 4 * k]))
    n = g["jump"].size
    for hit in (False, True):
        for budgeted in (False, True):
            ref_plan = ref_policy("dac(eps=0.3)")._plan(budgeted)
            port_plan = port_policy("dac(eps=0.3)").plan(budgeted).law
            cap = np.full(n, 2 * k - 1, np.int32)
            sc = [g["jump"], g["jump2"], np.full(n, k, np.int32), g["kmax"]]
            sc += [cap] if budgeted else []
            want = ref_plan(jnp.full(n, hit), jnp.full(n, i, jnp.int32),
                            tuple(jnp.asarray(s) for s in sc))
            got = port_plan(torch.full((n,), hit),
                            torch.full((n,), i, dtype=torch.int32),
                            tuple(torch.from_numpy(s) for s in sc))
            for r, p in zip(want[:3], got[:3]):
                np.testing.assert_array_equal(
                    np.broadcast_to(p.numpy(), (n,)),
                    np.broadcast_to(np.asarray(r), (n,)))
            assert_outputs_equal(want[3], got[3])
