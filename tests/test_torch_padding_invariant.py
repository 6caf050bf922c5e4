"""The padding invariant that kernel B1's bounded find relies on.

``csrc/policy_step.cu`` stops the find of any key other than ``EMPTY`` at
the live width: ``n`` for Climb and AdaptiveClimb, ``k`` for DAC.  That
gives the plain version's answer only if every rank at or past the live
width is ``EMPTY`` after every step (the reference states the invariant at
``src/repro/core/policy.py:19-25``).  These tests replay the six dataset
families step by step through the plain version (``replay_plain`` with
``observe=True``, one request per call) for all four plans and check the
row after every step against the scalars the step observed.  DAC runs at
``K = 64`` so that its active size grows and shrinks within the trace; the
budgeted plan carries a cap of ``1.5 K`` that truncates a doubling.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import make_policy
from repro_torch.core.policy import EMPTY
from repro_torch.data import traces as pt
from repro_torch.kernels.policy_step import replay_plain

T, SEEDS, K = 2000, (0, 1), 64
CAP = K + K // 2
# the scalar that holds each plan's live width
LIVE = {"climb": 0, "ac": 1, "dac": 2, "dac_budgeted": 2}
# how DAC's k moves on these traces within T steps at K = 64
GROWS = {"alibaba", "tencent", "metacdn", "metakv", "wiki"}
SHRINKS = {"twitter"}


def replay_steps(plan, family):
    """Rows ``[T, B, W]`` and scalars ``[T, B, n]`` after every step."""
    pol = make_policy("dac" if plan.startswith("dac") else plan)
    st = pol.init(K, lanes=len(SEEDS), device="cpu")
    names = pol.SCALARS
    budgeted = plan == "dac_budgeted"
    if budgeted:
        st["cap"] = torch.full_like(st["k"], CAP)
        names = names + ("cap",)
    cache = st["cache"]
    sc = torch.stack([st[n] for n in names], -1)
    keys = torch.from_numpy(
        pt.family_batch(family, T, seeds=SEEDS).astype(np.int32))
    sizes = torch.ones_like(keys)
    costs = torch.ones(keys.shape, dtype=torch.float32)
    law = pol.plan(budgeted=True) if budgeted else pol.plan()
    rows, scalars = [], []
    for s in range(T):
        out = replay_plain(cache, sc, keys[:, s:s + 1], sizes[:, s:s + 1],
                           costs[:, s:s + 1], law, collect_info=False,
                           observe=True)
        assert torch.equal(out.obs[:, 0], out.scalars)
        cache, sc = out.cache, out.obs[:, 0]
        rows.append(cache)
        scalars.append(sc)
    return torch.stack(rows), torch.stack(scalars)


@pytest.mark.parametrize("family", pt.DATASET_FAMILIES)
@pytest.mark.parametrize("plan", sorted(LIVE))
def test_ranks_past_the_live_width_stay_empty(plan, family):
    rows, scalars = replay_steps(plan, family)
    live = scalars[..., LIVE[plan]]
    ranks = torch.arange(rows.shape[-1])
    past = ranks >= live[..., None]
    assert bool((rows[past] == EMPTY).all()), \
        f"{plan} {family}: a rank past the live width is not EMPTY"
    # the row is not trivially empty: the live ranks fill up
    assert bool((rows[~past] != EMPTY).any())
    if plan.startswith("dac"):
        k = live
        assert bool((k > K).any()) == (family in GROWS)
        assert bool((k < K).any()) == (family in SHRINKS)
        if plan == "dac_budgeted" and family in GROWS:
            # the cap truncates the first doubling and denies the next
            assert int(k.max()) == CAP
