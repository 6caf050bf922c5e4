"""Port parity at the smoke's real capacities.

The six dataset families, each at ``K = k_for(footprint, "L")`` (819, or
1638 for the scan families; DAC's ``growth=4`` makes its row 3,328 or
6,656 ranks wide) with the smoke's lognormal sizes and fetch costs, go
through ``repro.core.Engine`` and ``repro_torch.core.Engine`` for dac, ac,
climb and fifo.  The traces are shortened to ``T = 4000`` on two seeds.
With ``collect_info=False`` both sides sum the totals one request at a
time in float32, so every field is compared exactly, as is DAC's active
size ``k`` after every step.
"""
import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.bench.scenario import k_for as ref_k_for  # noqa: E402
from repro.core import Engine as RefEngine  # noqa: E402
from repro.data import traces as rt  # noqa: E402
from repro_torch.core import Engine  # noqa: E402
from repro_torch.data import traces as pt  # noqa: E402

T, SEEDS = 4000, (0, 1)
# how DAC's k moves on these seeds within T steps (None: it holds)
RESIZE = {"alibaba": "shrink", "tencent": "grow", "twitter": "shrink",
          "metacdn": None, "metakv": "shrink", "wiki": None}


@pytest.mark.parametrize("family", sorted(RESIZE))
def test_family_replay_matches_reference(family):
    footprint = pt.family_footprint(family)
    K = pt.k_for(footprint, "L")
    assert K == ref_k_for(footprint, "L")
    keys = pt.family_batch(family, T, seeds=SEEDS)
    np.testing.assert_array_equal(
        keys, np.stack([rt.make_trace(family).generate(T, s)
                        for s in SEEDS]))
    table = pt.object_sizes(footprint, seed=1)
    sizes, costs = table[keys], pt.fetch_costs(table)[keys]
    for spec in ("dac", "ac", "climb", "fifo"):
        observe = spec == "dac"
        ref = RefEngine().replay(spec, keys, K, sizes=sizes, costs=costs,
                                 observe=observe, collect_info=False)
        port = Engine(device="cpu").replay(spec, keys, K, sizes=sizes,
                                           costs=costs, observe=observe,
                                           collect_info=False)
        for f in ref.metrics._fields:
            np.testing.assert_array_equal(
                getattr(port.metrics, f).numpy(),
                np.asarray(getattr(ref.metrics, f)), err_msg=f"{spec} {f}")
        np.testing.assert_array_equal(port.miss_ratio, ref.miss_ratio)
        if observe:
            k = port.obs["k"].numpy()
            np.testing.assert_array_equal(k, np.asarray(ref.obs["k"]))
            moved = {"grow": k.max() > K, "shrink": k.min() < K}
            want = RESIZE[family]
            assert [d for d, m in moved.items() if m] == \
                ([want] if want else [])
