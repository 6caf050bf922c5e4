"""Port parity: the plain versions of kernels B2 (flash attention) and B3
(flash decode with the per-slot mass) against the reference.

On CPU tensors ``repro_torch.kernels.flash_attention`` and
``decode_attention`` run their plain versions; they are held against the
reference's Pallas kernels under the interpreter (as
``tests/test_kernels.py`` runs them), its jnp oracles ``attention_dense``
and ``layers.decode_attention``, and ``chunked_attention``, the function
the reference's prefill runs.  Inputs come from seeded numpy; bf16 inputs
are rounded to bf16 once, the same way in both frameworks.

Tolerances, as ``tests/test_kernels.py`` states them: 2e-5 in f32 (the
two sides sum scores and products in different orders) and 3e-2 in bf16
(the output is rounded to bf16, whose step is 2^-8 relative).
"""
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from test_kernels import DECODE_CASES, FLASH_CASES  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_pallas)
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro_torch.kernels import decode_attention as pd  # noqa: E402
from repro_torch.kernels import flash_attention as pf  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(x, dtype):
    """One numpy array as (jnp, torch) arrays of ``dtype``, equal bits."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


def _close(got, want, dtype):
    tol = TOL[jnp.dtype(dtype).name]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _qkv(B, Sq, Sk, H, Hkv, D, Dv, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, Dv))]


# B, S, H, Hkv, D, Dv, window, softcap, dtype, bq, bk: test_kernels.py's
# cases plus prime lengths (the CUDA kernel takes any S; the Pallas kernel
# shrinks its blocks to divisors, down to the whole prime)
CASES = FLASH_CASES + [
    (1, 67, 4, 2, 32, 16, 20, 30.0, jnp.float32, 67, 67),
    (2, 53, 6, 3, 40, 24, None, 0.0, jnp.bfloat16, 53, 53),
]


@pytest.mark.parametrize("B,S,H,Hkv,D,Dv,win,cap,dtype,bq,bk", CASES)
def test_flash_attention_plain_matches_reference(B, S, H, Hkv, D, Dv, win,
                                                 cap, dtype, bq, bk):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, S, S, H, Hkv, D, Dv, dtype,
                                        seed=S + H)
    got = pf.flash_attention(qt, kt, vt, window=win, softcap=cap)
    assert got.dtype == qt.dtype and got.shape == (B, S, H, Dv)
    np.testing.assert_array_equal(
        _np(got), _np(pf.attention_dense(qt, kt, vt, window=win,
                                         softcap=cap)))
    kw = dict(window=win, softcap=cap)
    _close(got, rl.attention_dense(qj, kj, vj, **kw), dtype)
    _close(got, flash_attention_pallas(qj, kj, vj, block_q=bq, block_k=bk,
                                       interpret=True, **kw), dtype)
    _close(got, rl.chunked_attention(qj, kj, vj, chunk_q=bq, chunk_k=bk,
                                     **kw), dtype)


def test_flash_attention_non_causal_and_scale():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 24, 40, 4, 2, 16, 16,
                                        jnp.float32, seed=5)
    got = pf.flash_attention(qt, kt, vt, causal=False, scale=0.3)
    want = rl.attention_dense(qj, kj, vj, causal=False, scale=0.3)
    _close(got, want, jnp.float32)


def _decode_inputs(B, S, H, Hkv, D, Dv, p_valid, seed, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (_pair(rng.standard_normal(s).astype(np.float32), dtype)
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    valid = rng.random((B, S)) < p_valid
    return q, k, v, (jnp.asarray(valid), torch.from_numpy(valid))


# B, S, H, Hkv, D, Dv, softcap, block_s: test_kernels.py's cases plus a
# prime S
@pytest.mark.parametrize("B,S,H,Hkv,D,Dv,cap,bs",
                         DECODE_CASES + [(2, 61, 8, 4, 32, 32, 30.0, 61)])
def test_decode_attention_plain_matches_reference(B, S, H, Hkv, D, Dv, cap,
                                                  bs):
    (qj, qt), (kj, kt), (vj, vt), (mj, mt) = _decode_inputs(
        B, S, H, Hkv, D, Dv, 0.7, seed=S)
    mj, mt = mj.at[:, 0].set(True), mt.clone()
    mt[:, 0] = True
    o, mass = pd.decode_attention(qt, kt, vt, mt, softcap=cap)
    assert o.shape == (B, H, Dv) and mass.dtype == torch.float32
    po, pm = pd.decode_attention_plain(qt, kt, vt, mt, softcap=cap)
    np.testing.assert_array_equal(o.numpy(), po.numpy())
    np.testing.assert_array_equal(mass.numpy(), pm.numpy())
    for want_o, want_m in (
            rl.decode_attention(qj, kj, vj, mj, softcap=cap),
            decode_attention_pallas(qj, kj, vj, mj, softcap=cap, block_s=bs,
                                    interpret=True)):
        _close(o, want_o, jnp.float32)
        _close(mass, want_m, jnp.float32)


def test_decode_attention_bf16_matches_reference():
    (qj, qt), (kj, kt), (vj, vt), (mj, mt) = _decode_inputs(
        2, 130, 8, 2, 64, 64, 0.6, seed=11, dtype=jnp.bfloat16)
    o, mass = pd.decode_attention(qt, kt, vt, mt, softcap=50.0)
    want_o, want_m = rl.decode_attention(qj, kj, vj, mj, softcap=50.0)
    assert o.dtype == torch.bfloat16
    _close(o, want_o, jnp.bfloat16)
    _close(mass, want_m, jnp.float32)


def test_decode_attention_all_invalid_row_averages_uniformly():
    """A row with no valid slot: masked scores are -1e30, not -inf, so the
    softmax is uniform (no NaN), as in the reference."""
    (qj, qt), (kj, kt), (vj, vt), (mj, mt) = _decode_inputs(
        2, 48, 4, 2, 16, 16, 0.5, seed=3)
    mj, mt = mj.at[1].set(False), mt.clone()
    mt[1] = False
    o, mass = pd.decode_attention(qt, kt, vt, mt)
    want_o, want_m = rl.decode_attention(qj, kj, vj, mj)
    _close(o, want_o, jnp.float32)
    _close(mass, want_m, jnp.float32)
    np.testing.assert_allclose(mass[1].numpy(), 1.0 / 48, rtol=1e-6)
    assert torch.isfinite(o).all()


def test_decode_attention_mass_is_hit_signal():
    """Masked slots get zero mass; mass sums to ~1 over valid slots; the
    argmax agrees with the reference's."""
    B, S, H, Hkv, D = 2, 128, 4, 2, 32
    (qj, qt), (kj, kt), (vj, vt), _ = _decode_inputs(B, S, H, Hkv, D, D, 1.0,
                                                     seed=7)
    valid = np.zeros((B, S), bool)
    valid[:, :40] = True
    _, mass = pd.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    _, want = rl.decode_attention(qj, kj, vj, jnp.asarray(valid))
    m = mass.numpy()
    assert np.all(m[:, 40:] == 0.0)
    np.testing.assert_allclose(m.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(m.argmax(-1), np.asarray(want).argmax(-1))


@pytest.mark.parametrize("fn", ["flash", "decode"])
def test_wrappers_have_no_fallback_off_the_cpu(fn):
    """Off the CPU a wrapper launches its kernel or raises: on a device with
    no kernel it raises rather than run the plain version."""
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        if fn == "flash":
            pf.flash_attention(q, q, q)
        else:
            pd.decode_attention(q[:, 0], q, q,
                                torch.ones(1, 4, dtype=torch.bool,
                                           device="meta"))
