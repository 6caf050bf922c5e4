"""CPU rehearsal of the slot policies' CUDA-graph step loop
(``core/simulator.py::_replay_graphed``).

On the CPU there is no graph to capture, so the capture is replaced by a
function that runs its body at each replay: what stays is the loop's own
bookkeeping (the static request, state and total buffers, the copies in
and out of each chunk, the eager tail), which must give the plain loop's
result exactly.  On the card ``chip_smoke.py`` holds the captured graph
against the CPU and, over a prefix, the eager loop bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Request, make_policy, replay_lanes
from repro_torch.core import simulator as sim
from repro_torch.data.traces import churn_trace, object_sizes

SLOT = ("fifo", "lru", "blru", "lfu", "clock", "sieve", "twoq", "arc",
        "tinylfu", "hyperbolic", "lirs", "lhd")
B, T, K = 3, 150, 6


@pytest.fixture
def body_capture(monkeypatch):
    monkeypatch.setattr(sim, "_capture", lambda body: body)


def requests():
    keys = np.stack([churn_trace(N=40, T=T, alpha=1.0, mean_phase=50,
                                 drift=0.3, seed=s) for s in range(B)])
    sizes = object_sizes(40, seed=3)
    return Request.of(keys, sizes=sizes[keys], costs=sizes[keys] / 7.0,
                      device="cpu")


@pytest.mark.parametrize("collect_info", (True, False))
@pytest.mark.parametrize("chunk", (7, 64, 1000))
@pytest.mark.parametrize("spec", SLOT)
def test_graph_loop_equals_plain_loop(spec, chunk, collect_info,
                                      body_capture):
    pol, reqs = make_policy(spec), requests()
    state = pol.init(K, lanes=B, device="cpu")
    before = {k: v.clone() for k, v in state.items()}
    want, want_state = replay_lanes(pol, reqs, state,
                                    collect_info=collect_info)
    acc = None if collect_info else sim._zero_acc(B, "cpu")
    sinks = sim._sinks(pol, state, B, T, "cpu", collect_info, False)
    got_state, acc = sim._replay_graphed(sim._slot_body(pol), reqs,
                                         (state, acc), sinks, chunk)
    for k, v in before.items():        # the caller's state is not written
        assert torch.equal(state[k], v), k
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k
    if collect_info:
        for f, x in zip(want.info._fields, want.info):
            assert torch.equal(getattr(sinks[0], f), x), f
    else:
        for f, x in zip(want.metrics._fields, want.metrics):
            assert torch.equal(getattr(acc, f), x), f


def test_cpu_ignores_the_chunk():
    pol, reqs = make_policy("arc"), requests()
    a, _ = replay_lanes(pol, reqs, pol.init(K, B, "cpu"), chunk=0)
    b, _ = replay_lanes(pol, reqs, pol.init(K, B, "cpu"), chunk=16)
    for x, y in zip(a.info, b.info):
        assert torch.equal(x, y)
