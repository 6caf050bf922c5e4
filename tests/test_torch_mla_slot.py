"""MLA's absorbed decode over a latent cache split by slots (the
reference's ``P(b, tp_if(L), None)`` placement of ``latent``/``krope``):
each rank's :func:`repro_torch.models.mla.absorbed_partial` over its
block for every head, the heads padded to a multiple of the ranks and
dealt as the exchange deals them, merged in rank order by
``decode_attention_merge_plain``.

Over N in {1, 2, 4, 16} blocks of a slot table at the smoke config's
widths (r 32, dr 8), in f32: ``o_lat`` within ``TOL`` of
``mla.absorbed_attention``'s over the whole table, the mass (each
block's, from every head's ``(m, l)`` over the blocks) within ``TOL`` of
the row's largest mass.  Cases: rows with no valid slot in some blocks,
a row with none at all, and 6 heads padded to a multiple of N.  A mass
from a merge that reads each head's ``(m, l)`` from its neighbour, and a
uniform mass over the valid slots, must fail the mass check.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import SMOKE_ARCHS
from repro_torch.kernels import decode_attention as da
from repro_torch.models import mla

TOL = 1e-6
CFG = SMOKE_ARCHS["deepseek-v2-236b"]
# name: B, S, H, valid pattern
CASES = {
    "empty-blocks": (3, 256, CFG.n_heads, "blocks"),
    "empty-row": (3, 256, CFG.n_heads, "row"),
    "padded-heads": (2, 128, 6, "sparse"),
}


def _valid(pattern, B, S, rng):
    """valid ``[B, S]``: ``blocks`` one slot in the first row, a band of 40
    in the second (most blocks of both empty), the others 70% at random;
    ``row`` the first row with no valid slot, the others 70%; ``sparse``
    70% at random."""
    valid = rng.random((B, S)) < 0.7
    if pattern == "blocks":
        valid[0] = False
        valid[0, S // 3] = True
        valid[1] = False
        valid[1, S // 2:S // 2 + 40] = True
    elif pattern == "row":
        valid[0] = False
    return torch.from_numpy(valid)


def _inputs(case, n):
    B, S, H, pattern = CASES[case]
    r, dr = CFG.kv_lora_rank, CFG.qk_rope_head_dim
    rng = np.random.default_rng(S + H + n)
    q_lat, q_rope, latent, krope = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((B, H, r), (B, H, dr), (B, S, r), (B, S, dr)))
    scale = 1.0 / math.sqrt(CFG.qk_nope_head_dim + dr)
    return q_lat, q_rope, latent, krope, _valid(pattern, B, S, rng), scale


def _slot_law(q_lat, q_rope, latent, krope, valid, scale, n, ml_of=None):
    """The law over ``n`` blocks: (``o_lat`` ``[B, H, r]``, mass ``[B, S]``).
    ``ml_of`` replaces every head's ``(m, l)`` before the mass (a plant)."""
    S, H = latent.shape[1], q_lat.shape[1]
    Sb = S // n
    parts, scores = zip(*(mla.absorbed_partial(
        q_lat, q_rope, latent[:, r * Sb:(r + 1) * Sb],
        krope[:, r * Sb:(r + 1) * Sb], valid, r * Sb, scale)
        for r in range(n)))
    padded = torch.stack([da.pad_heads(p, n) for p in parts])
    assert padded.shape[2] % n == 0 and padded.shape[2] - H < n
    ml = torch.stack(parts)[..., -2:]
    if ml_of is not None:
        ml = ml_of(ml)
    hn = padded.shape[2] // n
    outs, mass = [], []
    for r in range(n):
        o, m = da.decode_attention_merge_plain(
            padded[:, :, r * hn:(r + 1) * hn], ml, scores[r])
        outs.append(o)
        mass.append(m)
    o = torch.cat(outs, dim=1)
    # the padded heads' outputs are 0
    assert (o[:, H:] == 0).all()
    return o[:, :H], torch.cat(mass, dim=-1)


def _want(q_lat, q_rope, latent, krope, valid, scale):
    pr, o_lat = mla.absorbed_attention(q_lat[:, None], q_rope[:, None],
                                       latent, krope, valid, scale)
    return o_lat, pr.mean(dim=1)


def _mass_rel(got, want):
    """Largest difference of two masses over the row's largest wanted."""
    scale = want.double().amax(-1, keepdim=True)
    return ((got.double() - want.double()).abs() / scale).max().item()


def _check_mass(got, want):
    assert got.shape == want.shape and torch.isfinite(got).all()
    d = _mass_rel(got, want)
    assert d <= TOL, f"mass off by {d} of its row's largest > {TOL}"


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_absorbed_partial_and_merge_equal_absorbed_attention(case, n):
    """``n`` blocks' partials merged in block order give the whole table's
    absorbed attention: ``o_lat`` within ``TOL``, the mass within ``TOL``
    of each row's largest; a row without a valid slot weighs all its
    slots alike on both sides."""
    args = _inputs(case, n)
    o, mass = _slot_law(*args, n)
    want_o, want_m = _want(*args)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), rtol=TOL,
                               atol=TOL)
    _check_mass(mass, want_m)
    valid = args[4]
    if case == "empty-row":
        np.testing.assert_allclose(mass[0].numpy(),
                                   np.full(valid.shape[1], 1 / valid.shape[1],
                                           np.float32), rtol=TOL)
    if case == "empty-blocks" and n > 1:
        # blocks with no valid slot in a row that has some keep l = 0
        Sb = valid.shape[1] // n
        blk = valid[:, :n * Sb].reshape(valid.shape[0], n, Sb).any(-1)
        assert (~blk[:2]).any()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("plant", ["neighbour-ml", "uniform"])
def test_planted_wrong_mass_is_refused(plant, n):
    """The mass check refuses a merge that reads each head's ``(m, l)``
    from the next head, and a mass uniform over the valid slots."""
    args = _inputs("empty-blocks", n)
    _, want_m = _want(*args)
    if plant == "neighbour-ml":
        _, mass = _slot_law(*args, n, ml_of=lambda ml: ml.roll(-1, dims=2))
    else:
        valid = args[4]
        fetched = torch.where(valid.any(-1, keepdim=True), valid, True)
        mass = fetched / fetched.sum(-1, keepdim=True).float()
    assert _mass_rel(mass, want_m) > 100 * TOL
    with pytest.raises(AssertionError, match="mass off by"):
        _check_mass(mass, want_m)
