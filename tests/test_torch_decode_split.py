"""The split arithmetic of kernel B3 (flash decode with the per-slot mass),
rehearsed on the CPU.

The CUDA kernel (``src/repro_torch/kernels/csrc/decode_attention.cu``)
splits the slot axis into the chunks :func:`chunk_len` picks, deals each
chunk's tiles of 8 slots to four warps, each with its own online softmax,
and merges the warps and then the splits in a fixed order.  The kernel
runs only on the card; here a torch mirror of that arithmetic, as the
kernel's header documents it, is held against the port's plain version
and the reference's ``layers.decode_attention`` within the tolerances of
``tests/test_torch_attention.py`` (2e-5 in f32, 3e-2 for a bf16 output),
and the chunk rule is held to covering every slot once.
"""
import math

import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as rl  # noqa: E402
from repro_torch.kernels import decode_attention as pd  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
NEG = -1e30
WARPS = 4              # warps of a split block, as the kernel's header has it


def chunks(B, Hkv, S):
    """The split kernel's chunks of the slot axis at ``pd.chunk_len``'s
    length, ``[(start, stop), ...]`` in split order."""
    c = pd.chunk_len(B, Hkv, S)
    return [(lo, min(lo + c, S)) for lo in range(0, S, c)]


def split_mirror(q, k, v, valid, *, softcap=0.0, scale=None, chunk=None):
    """The split kernel and the combine in torch f32.  Per chunk of the slot
    axis (:func:`chunks`, or ``chunk`` slots): the warp tiles of
    ``pd.WARP_TILE`` slots to load (in a row with a valid slot those that
    hold one, the others' scores -1e30, their invalid slots read as zeros;
    in a row with none all of them), dealt in order to ``WARPS`` warps;
    per warp one online-softmax update a tile for every head; the warps'
    (m, l, acc) merged in warp order; then the splits folded in split order
    and the mass summed in head order."""
    B, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    spans = (chunks(B, Hkv, S) if chunk is None else
             [(lo, min(lo + chunk, S)) for lo in range(0, S, chunk)])
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, 2)        # [B, S, H, D]
    vf = v.float().repeat_interleave(g, 2)
    n = len(spans)
    pm = torch.full((B, H, n), NEG)
    pl = torch.zeros((B, H, n))
    pacc = torch.zeros((B, H, n, Dv))
    scores = torch.empty((B, H, S))
    for b in range(B):
        row_any = bool(valid[b].any())
        for i, (lo, hi) in enumerate(spans):
            tiles = []
            for t0 in range(lo, hi, pd.WARP_TILE):
                t1 = min(t0 + pd.WARP_TILE, hi)
                if row_any and not bool(valid[b, t0:t1].any()):
                    scores[b, :, t0:t1] = NEG
                else:
                    tiles.append((t0, t1))
            warps = []
            for w in range(WARPS):
                m, l = torch.full((H,), NEG), torch.zeros(H)
                acc = torch.zeros((H, Dv))
                for t0, t1 in tiles[w::WARPS]:
                    ok = valid[b, t0:t1]
                    fetch = ok if row_any else torch.ones_like(ok)
                    kt = torch.where(fetch[:, None, None], kf[b, t0:t1], 0.0)
                    vt = torch.where(fetch[:, None, None], vf[b, t0:t1], 0.0)
                    x = torch.einsum("hd,shd->hs", qf[b], kt)
                    if softcap:
                        x = torch.tanh(x / softcap) * softcap
                    x = torch.where(ok[None], x, NEG)
                    scores[b, :, t0:t1] = x
                    m_new = torch.maximum(m, x.max(-1).values)
                    a = torch.exp(m - m_new)
                    p = torch.exp(x - m_new[:, None])
                    l = l * a + p.sum(-1)
                    acc = acc * a[:, None] + torch.einsum("hs,shd->hd", p, vt)
                    m = m_new
                warps.append((m, l, acc))
            m = torch.stack([wm for wm, _, _ in warps]).max(0).values
            l, acc = torch.zeros(H), torch.zeros((H, Dv))
            for wm, wl, wacc in warps:
                wgt = torch.exp(wm - m)
                l = l + wgt * wl
                acc = acc + wgt[:, None] * wacc
            pm[b, :, i], pl[b, :, i], pacc[b, :, i] = m, l, acc
    m = pm.max(-1).values
    l, o = torch.zeros((B, H)), torch.zeros((B, H, Dv))
    for i in range(n):
        w = torch.exp(pm[..., i] - m)
        l = l + w * pl[..., i]
        o = o + w[..., None] * pacc[..., i, :]
    l = l.clamp_min(1e-30)
    mass = torch.zeros((B, S))
    for h in range(H):
        mass = mass + torch.exp(scores[:, h] - m[:, h, None]) / l[:, h, None]
    return (o / l[..., None]).to(q.dtype), mass / H


def _pair(x, dtype):
    """One numpy array as (jnp, torch) arrays of ``dtype``, equal bits."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name))
    return j, t


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


# name: B, S, H, Hkv, D, Dv, softcap, valid pattern, dtype
MIRROR_CASES = {
    "short-prefix": (2, 300, 8, 4, 32, 32, 0.0, "short", jnp.float32),
    "empty-row": (2, 100, 4, 2, 16, 16, 0.0, "sparse+empty", jnp.float32),
    "g6": (2, 200, 12, 2, 32, 32, 0.0, "sparse", jnp.float32),
    "g8": (2, 200, 16, 2, 32, 32, 0.0, "sparse", jnp.float32),
    "g12": (1, 130, 24, 2, 16, 16, 0.0, "sparse", jnp.float32),
    "d64-dv32": (2, 150, 8, 2, 64, 32, 0.0, "sparse", jnp.float32),
    "softcap": (2, 160, 8, 4, 32, 32, 30.0, "sparse", jnp.float32),
    "s1": (3, 1, 4, 2, 16, 16, 0.0, "s1", jnp.float32),
    "bf16": (2, 130, 8, 2, 64, 64, 50.0, "sparse+empty", jnp.bfloat16),
}


def _valid(pattern, B, S, rng):
    if pattern == "short":                 # slots <= pos, pos = 5 + 7b
        return np.arange(S)[None] <= 5 + 7 * np.arange(B)[:, None]
    if pattern == "s1":                    # the one slot valid, then not
        return np.array([[True], [False], [True]])[:B]
    valid = rng.random((B, S)) < 0.7
    if pattern.endswith("+empty"):
        valid[-1] = False
    return valid


@pytest.mark.parametrize("chunk", [None, 96, 1024])
@pytest.mark.parametrize("case", sorted(MIRROR_CASES))
def test_split_mirror_matches_plain_and_reference(case, chunk):
    B, S, H, Hkv, D, Dv, cap, pattern, dtype = MIRROR_CASES[case]
    rng = np.random.default_rng(S + H)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    valid = _valid(pattern, B, S, rng)
    vt_ok = torch.from_numpy(valid)
    o, mass = split_mirror(qt, kt, vt, vt_ok, softcap=cap, chunk=chunk)
    assert o.dtype == qt.dtype and o.shape == (B, H, Dv)
    assert mass.shape == (B, S) and torch.isfinite(o.float()).all()
    tol = TOL[jnp.dtype(dtype).name]
    po, pm = pd.decode_attention_plain(qt, kt, vt, vt_ok, softcap=cap)
    ro, rm = rl.decode_attention(qj, kj, vj, jnp.asarray(valid), softcap=cap)
    for want_o, want_m in ((po, pm), (ro, rm)):
        np.testing.assert_allclose(_np(o), _np(want_o), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(mass), _np(want_m), rtol=TOL["float32"],
                                   atol=TOL["float32"])
    any_valid = valid.any(-1)
    # an invalid slot beside a valid one: p = 0 exactly
    assert np.all(mass.numpy()[any_valid][~valid[any_valid]] == 0.0)
    # a row with no valid slot averages uniformly
    np.testing.assert_allclose(mass.numpy()[~any_valid], 1.0 / S, rtol=1e-6)


@pytest.mark.parametrize("B,Hkv,S", [
    (8, 32, 2112), (8, 32, 512), (1, 16, 8192), (4, 8, 1024), (8, 24, 512),
    (8, 32, 17), (3, 2, 1), (1, 1, 31), (1, 1, 32), (1, 1, 33),
    (1, 1, 100_000), (64, 32, 4096), (2, 4, 300), (1, 8, 1021)])
def test_chunks_cover_every_slot_once(B, Hkv, S):
    c = pd.chunk_len(B, Hkv, S)
    assert c % pd.WARP_TILE == 0 and 0 < c <= 1024
    spans = chunks(B, Hkv, S)
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in spans])
    np.testing.assert_array_equal(covered, np.arange(S))
    assert all(hi - lo == c for lo, hi in spans[:-1])
    assert spans[-1][1] - spans[-1][0] == S - (len(spans) - 1) * c
    if S <= c:
        assert spans == [(0, S)]
    # CHUNK, halved while the call would have fewer than MIN_BLOCKS blocks,
    # and no longer than S rounded up to WARP_TILE
    s_up = -(-S // pd.WARP_TILE) * pd.WARP_TILE
    assert c <= min(pd.CHUNK, s_up)

    def blocks(n):
        return B * Hkv * -(-S // n)
    if c < min(pd.CHUNK, s_up):       # shortened: twice as long is too few
        assert blocks(2 * c) < pd.MIN_BLOCKS
    if pd.MIN_CHUNK < c < s_up:       # and no shorter than it had to be
        assert blocks(c) >= pd.MIN_BLOCKS


@pytest.mark.parametrize("B,Hkv,S,chunk", [
    (8, 32, 2112, 256), (8, 32, 512, 256), (1, 16, 8192, 256),
    (8, 24, 512, 256), (4, 8, 1024, 64), (1, 8, 4096, 64)])
def test_chunk_rule_at_the_timed_cases(B, Hkv, S, chunk):
    """The chunk the rule picks at ``decode_sweep.py``'s cases: 256 slots
    where they give 384 blocks or more, shorter where 256 gives 128."""
    assert pd.chunk_len(B, Hkv, S) == chunk
