"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the
reference's ``models/moe.py`` on the CPU.

Weights come from the reference's ``moe_init`` and are carried across
exactly (``convert.to_torch``); inputs from a numpy seed.  ``capacity``,
the router's expert indices and the capacity law's slots and drops are
held equal; gates within 1e-6 and ``moe_apply`` within 1e-5 in f32 (the
two sides sum the router's and the experts' products in different orders;
the largest difference seen is ~1e-7 on outputs of magnitude ~1).
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models.config import MoESpec as RMoESpec  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS as PORT_SMOKE  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import MoESpec  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402

GATE_TOL = 1e-6
TOL = 1e-5
MOE_ARCHS = ["deepseek-v2-236b", "mixtral-8x22b", "jamba-1.5-large-398b"]


def _carry(tree):
    return jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), tree)


def _cfgs(name, **moe_kw):
    rcfg, pcfg = REF_SMOKE[name], PORT_SMOKE[name]
    if moe_kw:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **moe_kw))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
            pcfg.moe, **moe_kw))
    return rcfg, pcfg


def _x(B, S, d, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal((B, S, d))
         * scale).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


def test_capacity_equals_reference():
    for E, k, cf in [(8, 2, 1.25), (160, 6, 1.25), (16, 2, 1.0),
                     (4, 2, 2.0), (64, 8, 1.5)]:
        rc = dataclasses.replace(REF_SMOKE["mixtral-8x22b"],
                                 moe=RMoESpec(n_experts=E, top_k=k,
                                              d_ff_expert=8,
                                              capacity_factor=cf))
        pc = dataclasses.replace(PORT_SMOKE["mixtral-8x22b"],
                                 moe=MoESpec(n_experts=E, top_k=k,
                                             d_ff_expert=8,
                                             capacity_factor=cf))
        for n in [1, 2, 7, 8, 16, 33, 100, 512, 2048, 4608, 32768]:
            assert moe.capacity(n, pc) == rmoe.capacity(n, rc), (E, k, cf, n)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_route_equals_reference(name):
    rcfg, pcfg = _cfgs(name)
    p = rmoe.moe_init(jax.random.PRNGKey(3), rcfg, jnp.float32)
    _, xj, xt = _x(3, 40, rcfg.d_model, seed=1)
    ridx, rgates, rprobs = rmoe.route(xj, p["router"], rcfg)
    idx, gates, probs = moe.route(xt, to_torch(np.asarray(p["router"]),
                                               "cpu"), pcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates),
                               atol=GATE_TOL, rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs),
                               atol=GATE_TOL, rtol=0)
    assert gates.dtype == probs.dtype == torch.float32


def test_router_runs_in_f32_in_a_bf16_model():
    """The router's weight is f32 in a bf16 model, and x is cast to f32
    before the product: the same indices as the reference from bf16 x."""
    rcfg, pcfg = _cfgs("deepseek-v2-236b")
    p = rmoe.moe_init(jax.random.PRNGKey(4), rcfg, jnp.bfloat16)
    assert p["router"].dtype == jnp.float32
    x, _, _ = _x(2, 24, rcfg.d_model, seed=2)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = to_torch(np.asarray(xj), "cpu")
    ridx, rgates, _ = rmoe.route(xj, p["router"], rcfg)
    idx, gates, _ = moe.route(xt, to_torch(np.asarray(p["router"]), "cpu"),
                              pcfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(rgates),
                               atol=GATE_TOL, rtol=0)


def _ref_dispatch(idx, E, C):
    """The reference's capacity law, copied from inside its ``moe_apply``
    (which exposes no dispatch function of its own).  What ties this copy
    to the reference is ``test_moe_apply_equals_reference``, which holds
    the port's whole ``moe_apply`` against the reference's, drops
    included."""
    B, N = idx.shape
    oh = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    pos_excl = jnp.cumsum(oh, axis=1) - oh
    pos = (pos_excl * oh).sum(-1)
    keep = pos < C
    return idx * C + jnp.minimum(pos, C - 1), keep


@pytest.mark.parametrize("E,C,N,seed", [(4, 8, 64, 0), (8, 8, 200, 1),
                                        (160, 8, 48, 2), (3, 16, 100, 3)])
def test_dispatch_equals_reference_law(E, C, N, seed):
    idx = np.random.default_rng(seed).integers(0, E, (3, N))
    rslot, rkeep = _ref_dispatch(jnp.asarray(idx), E, C)
    slot, keep = moe.dispatch(torch.from_numpy(idx), E, C)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))


@pytest.mark.parametrize("name,B,S,cf,n_shared", [
    ("mixtral-8x22b", 2, 40, 0.5, None),       # capacity drops tokens
    ("mixtral-8x22b", 2, 24, 1.25, None),
    ("deepseek-v2-236b", 2, 32, 1.25, None),   # n_shared = 1
    ("deepseek-v2-236b", 2, 48, 0.5, 0),       # drops, no shared experts
    ("deepseek-v2-236b", 3, 16, 1.25, 2),
    ("jamba-1.5-large-398b", 2, 40, 0.5, None),
])
def test_moe_apply_equals_reference(name, B, S, cf, n_shared):
    kw = {"capacity_factor": cf}
    if n_shared is not None:
        kw["n_shared"] = n_shared
    rcfg, pcfg = _cfgs(name, **kw)
    p = rmoe.moe_init(jax.random.PRNGKey(5), rcfg, jnp.float32)
    _, xj, xt = _x(B, S, rcfg.d_model, seed=S)
    want = rmoe.moe_apply(xj, p, rcfg)
    got = moe.moe_apply(xt, _carry(p), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    idx, _, _ = moe.route(xt, _carry(p)["router"], pcfg)
    _, keep = moe.dispatch(idx.reshape(B, -1), pcfg.moe.n_experts,
                           moe.capacity(S, pcfg))
    if cf < 1:
        assert not bool(keep.all())            # the case drops tokens


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_decode_regroups_the_batch(name):
    """S == 1, B > 1: the whole batch is one dispatch group, as in the
    reference (at B = 8, C = capacity(8))."""
    rcfg, pcfg = _cfgs(name)
    p = rmoe.moe_init(jax.random.PRNGKey(6), rcfg, jnp.float32)
    _, xj, xt = _x(8, 1, rcfg.d_model, seed=8)
    want = rmoe.moe_apply(xj, p, rcfg)
    got = moe.moe_apply(xt, _carry(p), pcfg)
    assert got.shape == (8, 1, pcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    # grouped: equal to one group of 8 tokens
    one = moe.moe_apply(xt.reshape(1, 8, -1), _carry(p), pcfg)
    np.testing.assert_array_equal(got.reshape(1, 8, -1).numpy(),
                                  one.numpy())


def test_moe_routes_topk_and_capacity():
    """``tests/test_models.py``'s law on the port."""
    rcfg, cfg = _cfgs("mixtral-8x22b")
    m = cfg.moe
    p = _carry(rmoe.moe_init(jax.random.PRNGKey(11), rcfg, jnp.float32))
    _, _, x = _x(2, 16, cfg.d_model, seed=11)
    idx, gates, probs = moe.route(x, p["router"], cfg)
    assert idx.shape == (2, 16, m.top_k)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert (idx[..., 0] != idx[..., 1]).all()
    assert moe.capacity(16, cfg) >= 16 * m.top_k / m.n_experts


def test_moe_identity_when_experts_zero():
    rcfg, cfg = _cfgs("mixtral-8x22b")
    p = _carry(rmoe.moe_init(jax.random.PRNGKey(11), rcfg, jnp.float32))
    p["w_down"] = torch.zeros_like(p["w_down"])
    _, _, x = _x(2, 8, cfg.d_model, seed=12)
    assert float(moe.moe_apply(x, p, cfg).abs().max()) < 1e-6
