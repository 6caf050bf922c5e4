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
and the chunk rule is held to covering every slot once.  The partial
kernel over one block of a slot table (the slots ``[s0, s0 + Sb)`` of a
rank of a slot-split cache, with the whole rows' ``valid``) has its own
mirror: the splits of :func:`pd.partial_split` (one cluster), pieces,
16-slot tiles dealt to four warps, the scale applied to the f32 product,
in bf16 P entering P V as bf16 hi + lo, the warps merged in warp order
and the splits folded in split order; it is held against
``decode_attention_partial_plain`` within 2e-5 (the bound the card's
check holds the kernel to), P rounded to bf16 alone is shown to exceed
that, and the blocks' partials merged against the whole table's plain B3.
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
    pm, pl, pacc, scores = split_parts(q, k, v, valid, softcap=softcap,
                                       scale=scale, chunk=chunk)
    B, H, S = scores.shape
    Dv = v.shape[-1]
    m = pm.max(-1).values
    l, o = torch.zeros((B, H)), torch.zeros((B, H, Dv))
    for i in range(pm.shape[-1]):
        w = torch.exp(pm[..., i] - m)
        l = l + w * pl[..., i]
        o = o + w[..., None] * pacc[..., i, :]
    l = l.clamp_min(1e-30)
    mass = torch.zeros((B, S))
    for h in range(H):
        mass = mass + torch.exp(scores[:, h] - m[:, h, None]) / l[:, h, None]
    return (o / l[..., None]).to(q.dtype), mass / H


PART_TILE, PIECE = 16, 1024    # the partial kernel's tiles and pieces


def p_times_v(p, v, hi_lo):
    """P V as the partial's bodies form it: the tensor-core body's P as
    bf16 hi + lo (two products, each summed in f32), the CUDA-core body's
    f32 P (``hi_lo`` None); ``hi_lo`` False: P rounded to bf16 alone."""
    if hi_lo is None:
        return p @ v
    hi = p.bfloat16().float()
    if not hi_lo:
        return hi @ v
    return hi @ v + (p - hi).bfloat16().float() @ v


def block_mirror(q, k_blk, v_blk, valid, s0, *, softcap=0.0, split=None,
                 piece=PIECE, hi_lo=True):
    """The partial kernel over one block (``decode_attention_partial``):
    slots ``[s0, s0 + Sb)`` of rows whose whole ``valid`` it reads, in
    ``split`` (default ``pd.partial_split``'s) chunks of pieces of
    ``piece`` slots; per piece the 16-slot tiles that hold a slot to fetch
    (the others' scores -1e30) dealt in order to ``WARPS`` warps, each with
    one online-softmax update a tile (scale times the f32 product), P V by
    :func:`p_times_v` (bf16 rows of multiples of 16: the tensor-core body,
    ``hi_lo``; else f32 P); the warps merged in warp order, the splits
    folded in split order, ``l`` not clamped."""
    B, H, D = q.shape
    Sb, Hkv, Dv = k_blk.shape[1], k_blk.shape[2], v_blk.shape[-1]
    g, scale = H // Hkv, 1.0 / math.sqrt(D)
    tensor = q.dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0
    hi_lo = hi_lo if tensor else None
    n, chunk = split or pd.partial_split(B, Hkv, Sb)
    row_anys, ok_blk = valid.any(-1), valid[:, s0:s0 + Sb]
    qf = q.float().reshape(B, Hkv, g, D)
    kf, vf = k_blk.float(), v_blk.float()
    part = torch.zeros((B, H, Dv + 2))
    scores = torch.empty((B, H, Sb))
    for b, hk in np.ndindex(B, Hkv):
        heads = slice(hk * g, (hk + 1) * g)
        splits = []
        for lo in range(0, n * chunk, chunk):
            warps = [(torch.full((g,), NEG), torch.zeros(g),
                      torch.zeros((g, Dv))) for _ in range(WARPS)]
            for p0 in range(lo, min(lo + chunk, Sb), piece):
                p1 = min(p0 + piece, lo + chunk, Sb)
                tiles = []
                for t0 in range(p0, p1, PART_TILE):
                    t1 = min(t0 + PART_TILE, p1)
                    if row_anys[b] and not bool(ok_blk[b, t0:t1].any()):
                        scores[b, heads, t0:t1] = NEG
                    else:
                        tiles.append((t0, t1))
                for i, (t0, t1) in enumerate(tiles):
                    m, l, acc = warps[i % WARPS]
                    ok = ok_blk[b, t0:t1]
                    fetch = ok if row_anys[b] else torch.ones_like(ok)
                    kt = torch.where(fetch[:, None], kf[b, t0:t1, hk], 0.0)
                    vt = torch.where(fetch[:, None], vf[b, t0:t1, hk], 0.0)
                    x = (qf[b, hk] @ kt.T) * scale
                    if softcap:
                        x = torch.tanh(x / softcap) * softcap
                    x = torch.where(ok[None], x, NEG)
                    scores[b, heads, t0:t1] = x
                    m_new = torch.maximum(m, x.max(-1).values)
                    a = torch.exp(m - m_new)
                    p = torch.exp(x - m_new[:, None])
                    warps[i % WARPS] = (m_new, l * a + p.sum(-1),
                                        acc * a[:, None] + p_times_v(
                                            p, vt, hi_lo))
            splits.append(fold(warps))
        m, l, acc = fold(splits)
        part[b, heads] = torch.cat([acc, m[:, None], l[:, None]], dim=-1)
    return part, scores


def fold(partials):
    """``[(m, l, acc), ...]`` folded in order into one ``(m, l, acc)``,
    ``l`` not clamped."""
    m = torch.stack([pm for pm, _, _ in partials]).max(0).values
    l, acc = torch.zeros_like(m), torch.zeros_like(partials[0][2])
    for pm, pl, pacc in partials:
        w = torch.exp(pm - m)
        l = l + w * pl
        acc = acc + w[:, None] * pacc
    return m, l, acc


def split_parts(q, k, v, valid, *, softcap=0.0, scale=None, chunk=None):
    """The split kernel's splits of k, v: each split's ``(m, l, acc)`` and
    the raw scores."""
    B, H, D = q.shape
    S, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    row_anys = valid.any(-1)
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
        row_any = bool(row_anys[b])
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
    return pm, pl, pacc, scores


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


# name: B, S, H, Hkv, D, Dv, softcap, valid pattern, blocks, dtype, split
# (None: pd.partial_split's), piece
BLOCK_CASES = {
    "empty-row": (2, 128, 4, 2, 16, 16, 0.0, "sparse+empty", 4, torch.float32,
                  None, PIECE),
    "empty-blocks": (2, 256, 8, 2, 32, 32, 0.0, "window", 4, torch.float32,
                     None, PIECE),
    "softcap": (2, 160, 8, 4, 32, 32, 30.0, "sparse", 2, torch.float32, None,
                PIECE),
    "short-prefix": (3, 256, 8, 2, 16, 8, 0.0, "short", 4, torch.float32,
                     None, PIECE),
    # bf16 on the tensor-core body: g = 8, a cluster of 4 splits in pieces
    # of 32 slots; g = 1 (musicgen's) with a softcap; an empty row
    "bf16-g8-pieces": (2, 512, 16, 2, 32, 32, 0.0, "sparse", 2,
                       torch.bfloat16, (4, 64), 32),
    "bf16-g1-softcap": (2, 256, 4, 4, 16, 32, 30.0, "sparse+empty", 2,
                        torch.bfloat16, None, PIECE),
    "bf16-window": (2, 512, 8, 2, 16, 16, 0.0, "window", 4, torch.bfloat16,
                    (2, 64), PIECE),
    # bf16 rows that are not multiples of 16 elements: the CUDA-core body
    "bf16-d24": (2, 128, 6, 3, 24, 8, 0.0, "sparse", 2, torch.bfloat16,
                 None, PIECE),
}


def block_inputs(case):
    """The case's q, k, v (``dtype``) and whole rows' ``valid``."""
    B, S, H, Hkv, D, Dv, cap, pattern, n, dtype = BLOCK_CASES[case][:10]
    rng = np.random.default_rng(S + H + n)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(dtype)
               for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, Dv)))
    if pattern == "window":        # slots (pos - 40, pos], pos = 200 - 30b
        pos = 200 - 30 * np.arange(B)[:, None]
        ar = np.arange(S)[None]
        valid = (ar <= pos) & (ar > pos - 40)
    else:
        valid = _valid(pattern, B, S, rng)
    return q, k, v, torch.from_numpy(valid)


def part_err(got, want):
    """Largest difference of two partials ``[B, H, Dv + 2]`` in the terms
    the card's check uses (``chip_smoke.part_err``): the block's output
    ``acc / l``, ``m``, and ``l`` relative to max(l, 1)."""
    Dv = got.shape[-1] - 2
    lg, lw = got[..., Dv + 1], want[..., Dv + 1]
    return max(
        (got[..., :Dv] / lg.clamp(min=1e-30)[..., None]
         - want[..., :Dv] / lw.clamp(min=1e-30)[..., None]).abs().max(),
        (got[..., Dv] - want[..., Dv]).abs().max(),
        ((lg - lw) / lw.clamp(min=1.0)).abs().max()).item()


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_mirror_matches_plain_partial_and_merge(case):
    """The partial kernel over each rank's block of a slot table, with the
    whole rows' ``valid`` (a row with no valid slot anywhere, blocks with
    none in rows that have some, a window, a softcap; bf16 with P as hi +
    lo): each block's partial equals ``decode_attention_partial_plain``'s
    within 2e-5 (its raw scores too), a block without a valid slot in a
    row with some gives ``m = -1e30``, ``l = 0``, ``acc = 0``, and the
    blocks merged in block order give the whole table's plain B3."""
    B, S, H, Hkv, D, Dv, cap, _, n, _, split, piece = BLOCK_CASES[case]
    q, k, v, valid = block_inputs(case)
    Sb = S // n
    parts, scores = [], []
    for r in range(n):
        blk = slice(r * Sb, (r + 1) * Sb)
        got = block_mirror(q, k[:, blk], v[:, blk], valid, r * Sb,
                           softcap=cap, split=split, piece=piece)
        want = pd.decode_attention_partial_plain(
            q, k[:, blk], v[:, blk], valid, r * Sb, softcap=cap)
        assert part_err(got[0], want[0]) <= 2e-5
        np.testing.assert_allclose(got[1].numpy(), want[1].numpy(),
                                   rtol=2e-5, atol=2e-5)
        if q.dtype == torch.float32:
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                       rtol=2e-5, atol=2e-5)
        empty = ~valid[:, blk].any(-1) & valid.any(-1)
        for w in (got[0], want[0]):
            assert (w[empty][..., Dv] == NEG).all()
            assert (w[empty][..., Dv + 1] == 0).all()
            assert (w[empty][..., :Dv] == 0).all()
        parts.append(want[0])
        scores.append(want[1])
    parts = torch.stack(parts)
    o, _ = pd.decode_attention_merge_plain(parts)
    mass = torch.cat([pd.decode_attention_merge_plain(
        parts, parts[..., Dv:], sc)[1] for sc in scores], dim=-1)
    po, pm = pd.decode_attention_plain(q.float(), k.float(), v.float(),
                                       valid, softcap=cap)
    np.testing.assert_allclose(o.numpy(), po.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mass.numpy(), pm.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_bf16_p_alone_fails_the_partial_check():
    """P rounded to bf16 alone before P V (one product, not hi + lo) errs
    by more than the 2e-5 the partial is held to, where hi + lo does not:
    the check can tell the two apart."""
    q, k, v, valid = block_inputs("bf16-g8-pieces")
    want = pd.decode_attention_partial_plain(q, k[:, :256], v[:, :256],
                                             valid, 0)[0]
    kw = dict(split=(4, 64), piece=32)
    assert part_err(block_mirror(q, k[:, :256], v[:, :256], valid, 0,
                                 **kw)[0], want) <= 2e-5
    assert part_err(block_mirror(q, k[:, :256], v[:, :256], valid, 0,
                                 hi_lo=False, **kw)[0], want) > 2e-5


@pytest.mark.parametrize("B,Hkv,Sb", [
    (8, 8, 2048), (4, 8, 1024), (8, 24, 256), (8, 8, 9), (8, 8, 5),
    (1, 8, 2048), (8, 8, 131_072),
    (1, 1, 130), (1, 1, 65), (2, 4, 100_000), (1, 8, 16384), (3, 2, 1),
    (64, 8, 4096), (1, 1, 8192), (2, 2, 300), (16, 8, 64)])
def test_partial_split_covers_every_slot_once(B, Hkv, Sb):
    """``pd.partial_split``: n chunks of a multiple of ``PART_TILE`` slots,
    at most ``MAX_CLUSTER``, the fewest that cover the block, each (the
    last one shorter) taken in pieces of at most 1,024 slots; n doubled
    while the chunk is longer than ``PART_MIN_CHUNK`` and twice the blocks
    stay within ``PART_BLOCKS``, and no further."""
    n, c = pd.partial_split(B, Hkv, Sb)
    assert 1 <= n <= pd.MAX_CLUSTER and c % pd.PART_TILE == 0 and c > 0
    spans = [(lo, min(lo + c, Sb)) for lo in range(0, n * c, c)]
    assert all(lo < hi for lo, hi in spans)
    pieces = [(p, min(p + PIECE, hi)) for lo, hi in spans
              for p in range(lo, hi, PIECE)]
    covered = np.concatenate([np.arange(lo, hi) for lo, hi in pieces])
    np.testing.assert_array_equal(covered, np.arange(Sb))
    assert all(hi - lo <= PIECE for lo, hi in pieces)

    def chunk(k):
        return -(-(-(-Sb // k)) // pd.PART_TILE) * pd.PART_TILE
    k = 1 << (n - 1).bit_length()      # the doubled count, n before the cut
    assert chunk(k) == c
    for j in range(k.bit_length() - 1):   # each doubling the rule made
        assert chunk(1 << j) > pd.PART_MIN_CHUNK
        assert B * Hkv * (2 << j) <= pd.PART_BLOCKS
    assert k == pd.MAX_CLUSTER or c <= pd.PART_MIN_CHUNK \
        or B * Hkv * 2 * k > pd.PART_BLOCKS
