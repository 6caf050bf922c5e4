"""Port parity: multi-head latent attention (``repro_torch.models.mla``)
against the reference's ``models/mla.py`` on the CPU.

Weights come from the reference's ``mla_init`` and are carried across
exactly; inputs from a numpy seed.  Everything is held within 1e-5 in f32
(the two sides sum the projections and the softmax in different orders;
the largest difference seen is ~1e-7 on values of magnitude ~1).  On the
CPU the prefill's attention is kernel B2's plain version.
"""
import dataclasses
import math

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import SMOKE_ARCHS as REF_SMOKE  # noqa: E402
from repro.models import mla as rmla  # noqa: E402
from repro_torch.configs import SMOKE_ARCHS as PORT_SMOKE  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402

TOL = 1e-5
NAME = "deepseek-v2-236b"


def _cfgs(q_lora=True):
    rcfg, pcfg = REF_SMOKE[NAME], PORT_SMOKE[NAME]
    if not q_lora:
        rcfg = dataclasses.replace(rcfg, q_lora_rank=0)
        pcfg = dataclasses.replace(pcfg, q_lora_rank=0)
    return rcfg, pcfg


def _setup(q_lora, B, S, seed):
    rcfg, pcfg = _cfgs(q_lora)
    rp = rmla.mla_init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    pp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), rp)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return (rcfg, pcfg, rp, pp, jnp.asarray(x), torch.from_numpy(x),
            jnp.asarray(pos), torch.from_numpy(pos.copy()))


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("q_lora", [True, False])
def test_latent_and_apply_equal_reference(q_lora):
    rcfg, pcfg, rp, pp, xj, xt, pj, pt = _setup(q_lora, 2, 24, seed=1)
    rl, rk = rmla.mla_latent(xj, rp, rcfg, pj)
    lat, kr = mla.mla_latent(xt, pp, pcfg, pt)
    assert lat.shape == (2, 24, pcfg.kv_lora_rank)
    assert kr.shape == (2, 24, 1, pcfg.qk_rope_head_dim)
    _close(lat, rl, "latent")
    _close(kr, rk, "k_rope")
    want = rmla.mla_apply(xj, rp, rcfg, pj)
    got, cache = mla.mla_apply(xt, pp, pcfg, pt, want_cache=True)
    _close(got, want, "mla_apply")
    np.testing.assert_array_equal(cache["latent"].numpy(), lat.numpy())
    np.testing.assert_array_equal(cache["krope"].numpy(), kr[:, :, 0].numpy())


def test_prefill_scale_is_b2s_default():
    """``mla_apply`` leaves B2 its default scale ``1/sqrt(D)``.  q is
    ``[q_nope | q_rope]``, so D = dn + dr and that default is the
    reference's ``1/sqrt(dn + dr)``: the kernel and its plain version see
    the scale the reference uses."""
    rcfg, pcfg = _cfgs()
    seen = []
    orig = fa.attention_dense

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], v.shape[-1], kw.get("scale")))
        return orig(q, k, v, **kw)
    _, _, _, pp, _, xt, _, pt = _setup(True, 1, 8, seed=2)
    fa.attention_dense = spy
    try:
        mla.mla_apply(xt, pp, pcfg, pt)
    finally:
        fa.attention_dense = orig
    (d, dv, scale), = seen
    assert scale is None
    assert (d, dv) == (pcfg.qk_nope_head_dim + pcfg.qk_rope_head_dim,
                       pcfg.v_head_dim)
    ref_scale = 1.0 / math.sqrt(rcfg.qk_nope_head_dim + rcfg.qk_rope_head_dim)
    assert 1.0 / math.sqrt(d) == ref_scale


def _decode_inputs(rng, B, L, r, dr, empty_row=True):
    lat = rng.standard_normal((B, L, r)).astype(np.float32)
    kr = rng.standard_normal((B, L, dr)).astype(np.float32)
    valid = rng.random((B, L)) < 0.6
    if empty_row:
        valid[-1] = False
    pos = rng.integers(0, 100, B).astype(np.int32)
    return lat, kr, valid, pos


@pytest.mark.parametrize("q_lora,seed", [(True, 3), (False, 4), (True, 5)])
def test_attend_equals_reference(q_lora, seed):
    """``mla_attend``'s output and per-slot mass, random ``valid`` with an
    empty row."""
    rcfg, pcfg, rp, pp, xj, xt, _, _ = _setup(q_lora, 3, 1, seed)
    lat, kr, valid, pos = _decode_inputs(np.random.default_rng(seed), 3, 37,
                                         rcfg.kv_lora_rank,
                                         rcfg.qk_rope_head_dim)
    ro, rm = rmla.mla_attend(xj, rp, rcfg, jnp.asarray(lat), jnp.asarray(kr),
                             jnp.asarray(valid), jnp.asarray(pos))
    o, m = mla.mla_attend(xt, pp, pcfg, torch.from_numpy(lat),
                          torch.from_numpy(kr), torch.from_numpy(valid),
                          torch.from_numpy(pos))
    assert o.shape == (3, pcfg.d_model) and m.shape == (3, 37)
    _close(o, ro, "o")
    _close(m, rm, "mass")
    assert m.dtype == torch.float32


def test_absorbed_decode_equals_materialised_attention():
    """The reference's law: attending in latent space (q absorbed through
    ``w_kb``, ``o`` up-projected through ``w_vb``) equals materialising
    per-head K = [k_nope | k_rope], V from the same cache and attending
    the usual way."""
    _, pcfg, _, pp, _, xt, _, _ = _setup(True, 2, 1, seed=6)
    B, L = 2, 29
    lat, kr, valid, pos = _decode_inputs(np.random.default_rng(6), B, L,
                                         pcfg.kv_lora_rank,
                                         pcfg.qk_rope_head_dim,
                                         empty_row=False)
    lat, kr, valid, pos = map(torch.from_numpy, (lat, kr, valid, pos))
    out, mass = mla.mla_attend(xt, pp, pcfg, lat, kr, valid, pos)

    H = pcfg.n_heads
    dn, dr = pcfg.qk_nope_head_dim, pcfg.qk_rope_head_dim
    q_nope, q_rope = mla._queries(xt, pp, pcfg, pos[:, None])
    kvb = torch.einsum("bsr,rhk->bshk", lat, pp["w_kvb"])
    k = torch.cat([kvb[..., :dn], kr[:, :, None].expand(B, L, H, dr)], -1)
    v = kvb[..., dn:]
    q = torch.cat([q_nope, q_rope], -1)[:, 0]             # [B, H, D]
    s = torch.einsum("bhd,bshd->bhs", q, k) / math.sqrt(dn + dr)
    p = torch.softmax(torch.where(valid[:, None], s, -1e30), -1)
    o = torch.einsum("bhs,bshv->bhv", p, v)
    want = torch.einsum("bhv,hvd->bd", o, pp["wo"])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(mass.numpy(), p.mean(1).numpy(), atol=TOL,
                               rtol=0)
