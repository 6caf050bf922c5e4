"""Steps a CUDA graph for the slot policies' time loop on an NVIDIA card:
how many requests one graph of ``core/simulator.py``'s graph loop should
take (``simulator.GRAPH_CHUNK``).

For each of the twelve slot policies, on ``chip_smoke.py``'s first slot
group (the first 4,000 requests of the L-regime families of K = 819, 3
seeds each, lognormal sizes and fetch costs), the graph loop's us a step
(host clock, capture excluded) and its capture seconds at every size of
``CHUNKS``; each run's totals and final state equal those at
``GRAPH_CHUNK``.

    python3 graph_sweep.py     # one CUDA card; one JSON line a policy

Exits non-zero with no result where CUDA is not available.
"""
from __future__ import annotations

import json
import sys

import chip_smoke as cs

CHUNKS = (16, 32, 128, 512)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("graph_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.core import Request
    from repro_torch.core import simulator as sim

    dev = "cuda"
    print(cs.nvidia_smi_line(), flush=True)
    (regime, K), fams = next(iter(cs.slot_groups().items()))
    reqs = Request.of(*cs.slot_inputs(fams, cs.SLOT_T, cs.SLOT_SEEDS),
                      device=dev)
    for spec in cs.SLOT_POLICIES:
        want, _, _ = cs.slot_replay(spec, K, reqs, sim.GRAPH_CHUNK, dev)
        row = {"policy": spec, "regime": regime, "K": K,
               "lanes": reqs.key.shape[0], "T": cs.SLOT_T, "chunks": {}}
        for chunk in CHUNKS:
            got, s, cap = cs.slot_replay(spec, K, reqs, chunk, dev)
            cs.equal_runs(got, want, f"{spec}: {chunk} steps a graph vs "
                          f"{sim.GRAPH_CHUNK}")
            row["chunks"][chunk] = {
                "us_per_step": (s - cap) * 1e6 / cs.SLOT_T,
                "capture_s": cap, "s": s}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
