#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one JSON line each:

1. device and build: the card, its power limit, the kernels' build time;
2. kernel vs plain, bit for bit, on the card: ``policy_step_batched``
   against the plain step for the four plans (Climb, AdaptiveClimb, DAC,
   DAC with a cap) over K in {1, 7, 127, 128, 129, 1000, 419428} and empty,
   mid-fill and full rows; ``policy_replay`` against the plain step loop
   for climb, ac and dac with ``collect_info`` on and off and ``observe``
   on at B=8, T=4096; for each capacity group of the main path at its lane
   count and in its mode (dac at K=819 is the timed case); and for
   ``dac(growth=4)`` at the large state's width (row in device memory)
   with lanes that grow and shrink;
3. the main path: the six dataset families as ``[16, 200000]`` traces
   through ``Engine(device="cuda").replay`` for dac, ac, climb and fifo at
   ``K = k_for(footprint, "L")`` (families of one K share a call: 64
   lanes at K=819, 32 at K=1638); miss ratios, MRR against FIFO, Mreq/s,
   DAC's active size ``k``;
4. large state: zipf over 2^20 ids, K = 104857, ``dac(growth=4)`` on 128
   lanes for T = 100000 through ``Engine.replay_stream``.

Then the kernels line, the card's ``nvidia-smi`` name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero with no result line; so does a machine without CUDA, or a
directory without the port's sources next to this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_SMS = 132
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
# int32 ALU rate: 64 INT32 lanes per SM (Hopper architecture whitepaper)
# x 132 SMs x 1.98 GHz boost clock (H100 SXM data sheet)
H100_INT32_OPS_PER_S = 64 * H100_SMS * 1.98e9
BIG_K = 104857 * 4           # DAC kmax of the large-state phase


START = time.perf_counter()


def emit(obj):
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**obj, "at_s": round(time.perf_counter() - START, 3)}),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=3):
    """Mean milliseconds of ``fn()`` on the card, after one warm-up."""
    import torch
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_s(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class Mismatch(AssertionError):
    pass


def max_err(a, b, what):
    """Largest absolute difference of two tensors; raises unless they are
    equal bit for bit."""
    import torch
    if a is None and b is None:
        return 0.0
    if a.shape != b.shape or a.dtype != b.dtype:
        raise Mismatch(f"{what}: {a.dtype}{tuple(a.shape)} vs "
                       f"{b.dtype}{tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs().max().item()
    if not torch.equal(a, b):
        raise Mismatch(f"{what}: kernel and plain differ (max abs {d})")
    return d


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def step_cases(K, fill, pid, rng):
    """B=12 lanes of one (K, fill) case: row, keys and scalars, with lanes
    designed to grow and to shrink under the DAC plans."""
    import numpy as np
    from repro_torch.core.policy import (EMPTY, PLAN_ADAPTIVECLIMB,
                                         PLAN_CLIMB, PLAN_DAC_BUDGETED,
                                         lane_pad)
    # full rows are tight (width K): the wrapper pads them and slices back
    B = 12
    W = K if fill == "full" else lane_pad(K)
    rows = np.full((B, W), EMPTY, np.int32)
    keys = np.empty(B, np.int64)
    sc = []
    for b in range(B):
        if pid in (PLAN_CLIMB, PLAN_ADAPTIVECLIMB):
            k = K
        else:   # DAC: active size k <= kmax = K, ranks >= k EMPTY
            k = max(1, K >> int(rng.integers(0, 3)))
        n = {"empty": 0, "mid": k // 2, "full": k}[fill]
        rows[b, :n] = rng.permutation(10 * K + 10)[:n]
        kind = b % 4
        if kind == 0 or n == 0:
            keys[b] = 10 * K + 20 + b                 # miss
        elif kind == 1:
            keys[b] = rows[b, rng.integers(0, n)]     # hit
        elif kind == 2:
            keys[b] = rows[b, rng.integers(0, max(1, n // 4))]
        elif W % 128 == 0:
            keys[b] = EMPTY                           # hits the first EMPTY
        else:   # a tight row holds no EMPTY for the key to hit
            keys[b] = 10 * K + 40 + b
        half = k // 2
        if pid == PLAN_CLIMB:
            sc.append([k])
        elif pid == PLAN_ADAPTIVECLIMB:
            sc.append([int(rng.integers(1, k + 1)), k])
        else:
            if b % 3 == 0:                            # grows on a miss
                jump, jump2 = 2 * k - 1, 0
                keys[b] = 10 * K + 30 + b
            elif b % 3 == 1 and n > 0:                # shrinks on a top hit
                jump = -half + 1
                jump2 = -int(np.ceil(np.float32(0.5) * np.float32(half))) + 1
                keys[b] = rows[b, 0]
            else:
                jump = int(rng.integers(-half, 2 * k + 1))
                jump2 = int(rng.integers(-half, 1))
            cap = ([int(rng.integers(k, 2 * k + 2))]
                   if pid == PLAN_DAC_BUDGETED else [])
            sc.append([jump, jump2, k, K] + cap)
    return rows, keys.astype(np.int32), np.array(sc, np.int32)


def phase_step(dev):
    import numpy as np
    import torch
    from repro_torch.core import make_policy
    from repro_torch.kernels import policy_step as ps

    rng = np.random.default_rng(20251121)
    plans = {"climb": make_policy("climb").plan(),
             "ac": make_policy("ac").plan(),
             "dac": make_policy("dac").plan(),
             "dac_budgeted": make_policy("dac").plan(budgeted=True)}
    err, cases, grows, shrinks = 0.0, 0, 0, 0
    for pname, plan in plans.items():
        for K in (1, 7, 127, 128, 129, 1000, BIG_K):
            for fill in ("empty", "mid", "full"):
                rows, keys, sc = step_cases(K, fill, plan.pid, rng)
                cache = torch.from_numpy(rows).to(dev)
                key = torch.from_numpy(keys).to(dev)
                scal = tuple(torch.from_numpy(sc).to(dev).unbind(-1))
                # three consecutive steps, each held against the plain step
                for s in range(3):
                    got = ps.policy_step_batched(cache, key, scal, plan)
                    want = ps.step_plain(cache, key, scal, plan)
                    torch.cuda.synchronize()
                    what = f"step {pname} K={K} {fill} s={s}"
                    err = max(err, max_err(got[0], want[0], what + " row"))
                    for q, (g, w) in enumerate(zip(got[1], want[1])):
                        err = max(err, max_err(g, w, f"{what} scalar{q}"))
                    err = max(err, max_err(got[2], want[2], what + " hit"))
                    err = max(err, max_err(got[3], want[3], what + " evicted"))
                    if len(scal) >= 4:                # DAC: k is scalar 2
                        grows += int((got[1][2] > scal[2]).sum())
                        shrinks += int((got[1][2] < scal[2]).sum())
                    cache, scal = got[0], got[1]
                    key = cache[:, 0].clone() if s == 0 else key + 1
                    cases += 1
    if grows == 0 or shrinks == 0:
        raise Mismatch(f"DAC step cases did not grow and shrink "
                       f"(grows {grows}, shrinks {shrinks})")
    return {"phase": "kernel_vs_plain_step", "cases": cases,
            "dac_grows": grows, "dac_shrinks": shrinks,
            "max_abs_err": err, "launches": ps.STEP_LAUNCHES}


def replay_inputs(B, T, dev, family="alibaba"):
    import numpy as np
    import torch
    from repro_torch.data.traces import (family_batch, family_footprint,
                                         fetch_costs, object_sizes)
    keys = family_batch(family, T, seeds=range(B))
    sizes = object_sizes(family_footprint(family), seed=1)
    costs = fetch_costs(sizes)
    return (torch.from_numpy(keys).to(dev),
            torch.from_numpy(sizes[keys].astype(np.int32)).to(dev),
            torch.from_numpy(costs[keys]).to(dev))


def large_state_inputs(pol, K, B, T, dev, seed=7):
    """A state and requests at the large state's width (the row lives in
    device memory): rows full to ``k``; lanes that grow on their first
    request (``jump`` one below ``2k``, then a miss), lanes that shrink on
    it (at the halving threshold, then a hit at rank 0), and lanes at
    random ``jump``/``jump'``; after the first request, hits at any depth
    and fresh misses, half each."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    st = pol.init(K, lanes=B, device="cpu")
    rows = st["cache"].numpy().copy()
    sc = torch.stack([st[n] for n in pol.SCALARS], -1).numpy().copy()
    keys = np.empty((B, T), np.int64)
    half = K // 2
    for b in range(B):
        rows[b, :K] = rng.permutation(4 * K)[:K]
        fresh = 4 * K + b * T + np.arange(T)
        deep = rows[b, rng.integers(0, K, T)]
        keys[b] = np.where(rng.random(T) < 0.5, deep, fresh)
        if b % 4 == 0:                                # grows
            sc[b, :2] = (2 * K - 1, 0)
            keys[b, 0] = fresh[0]
        elif b % 4 == 1:                              # shrinks
            thresh = np.ceil(np.float32(pol.eps) * np.float32(half))
            sc[b, :2] = (-half + 1, -int(thresh) + 1)
            keys[b, 0] = rows[b, 0]
        else:
            sc[b, :2] = (rng.integers(-half, 2 * K + 1),
                         rng.integers(-half, 1))
    sizes = rng.integers(1, 1 << 20, (B, T))
    costs = rng.random((B, T), dtype=np.float32) * 10
    to = lambda x, dt: torch.from_numpy(x).to(dev, dt)  # noqa: E731
    return (to(rows, torch.int32), to(sc, torch.int32),
            (to(keys, torch.int32), to(sizes, torch.int32),
             to(costs, torch.float32)))


def bound(out, B, T, W, n_sc):
    """Least time (ms) on an H100 for a replay's work: the bytes it must
    move (requests read once, rows and scalars read and written once,
    totals written once) over the memory rate, against the rank compares,
    moves and wipes this run's data needed over the int32 ALU rate of the
    whole card.  Also the operations' time on the ``min(B, 132)`` SMs that
    one block per lane can occupy."""
    bytes_ = 12 * B * T + 8 * B * W + 8 * B * n_sc + B * (16 + 16 + 24)
    if out.hit is not None:
        bytes_ += 5 * B * T
    if out.obs is not None:
        bytes_ += 4 * B * T * n_sc
    ops = int(out.work.sum())
    t_bytes, t_ops = bytes_ / H100_BYTES_PER_S, ops / H100_INT32_OPS_PER_S
    sms = min(B, H100_SMS)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            {"sms": sms, "ops_on_used_sms_ms": t_ops * H100_SMS / sms * 1e3})


def main_mode(spec):
    """The main path's replay flags: totals only, and DAC's k."""
    return {"collect_info": False, "observe": spec == "dac"}


def phase_replay(dev):
    """``policy_replay`` against the plain loop on the same inputs, every
    output bit for bit: every policy and mode at B=8; each capacity group
    of the main path at its lane count and in its mode (dac at K=819 is
    the timed case of the kernels line); ``dac(growth=4)`` at the large
    state's width, where the row lives in device memory, with lanes that
    grow and shrink."""
    import torch
    from repro_torch.core import make_policy
    from repro_torch.data.traces import k_for
    from repro_torch.kernels import policy_step as ps

    T = 4096
    K0 = min(main_groups())
    modes = ((True, True), (False, True), (False, False))
    cases = [(8, K0, "alibaba", spec, {"collect_info": ci, "observe": ob})
             for spec in ("climb", "ac", "dac") for ci, ob in modes]
    for K, fams in main_groups().items():
        cases += [(16 * len(fams), K, fams[0], spec, main_mode(spec))
                  for spec in ("dac", "ac", "climb")]
    big = make_policy("dac(growth=4)")
    K_big, B_big, T_big = k_for(1 << 20, "L"), 16, 256
    big_state = large_state_inputs(big, K_big, B_big, T_big, dev)
    cases += [(B_big, K_big, None, "dac(growth=4)",
               {"collect_info": ci, "observe": True}) for ci in (True, False)]

    err, timing, inputs, rows, resizes = 0.0, None, {}, [], [0, 0]
    for B, K, fam, spec, kw in cases:
        pol = make_policy(spec)
        if fam is None:
            cache, sc, reqs = big_state
            T_case = T_big
        else:
            if (B, fam) not in inputs:
                inputs[B, fam] = replay_inputs(B, T, dev, fam)
            st = pol.init(K, lanes=B, device=dev)
            cache = st["cache"]
            sc = torch.stack([st[n] for n in pol.SCALARS], -1)
            reqs, T_case = inputs[B, fam], T
        args = (cache, sc, *reqs, pol.plan())
        got = ps.policy_replay(*args, **kw)
        want, plain_s = host_s(lambda: ps.replay_plain(*args, **kw))
        for f in got._fields:
            err = max(err, max_err(getattr(got, f), getattr(want, f),
                                   f"replay {spec} B={B} K={K} {kw} {f}"))
        W = cache.shape[1]
        if fam is None:
            k = got.obs[..., 2]
            resizes[0] += int((k > K).any(1).sum())
            resizes[1] += int((k < K).any(1).sum())
        if B == 8:
            continue
        b_ms, b_by, b_sms = bound(got, B, T_case, W, sc.shape[1])
        ms = cuda_ms(lambda: ps.policy_replay(*args, **kw))
        row = {"spec": spec, "shape": [B, T_case], "K": K, "W": W, **kw,
               "ms": ms, "us_per_step": ms * 1e3 / T_case,
               "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
               "bound_by": b_by, **b_sms,
               "work": got.work.sum(0).tolist()}
        rows.append(row)
        if K == K0 and spec == "dac":
            timing = row
    if resizes[0] == 0 or resizes[1] == 0:
        raise Mismatch(f"large-state replay lanes did not grow and shrink "
                       f"(lanes grown {resizes[0]}, shrunk {resizes[1]})")
    return ({"phase": "kernel_vs_plain_replay", "runs": len(cases),
             "max_abs_err": err, "large_state_lanes_grown": resizes[0],
             "large_state_lanes_shrunk": resizes[1], "timed": rows},
            err, timing)


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path
# ---------------------------------------------------------------------------

def main_groups():
    """The dataset families grouped by capacity: one engine call per
    (group, policy) replays all of a group's lanes together."""
    from repro_torch.data.traces import (DATASET_FAMILIES, family_footprint,
                                         k_for)
    groups = {}
    for fam in DATASET_FAMILIES:
        groups.setdefault(k_for(family_footprint(fam), "L"), []).append(fam)
    return groups


def phase_main(dev, seeds=16, T=200_000):
    import numpy as np
    import torch
    from repro_torch.core import Engine, Request, mrr
    from repro_torch.data.traces import (family_batch, family_footprint,
                                         fetch_costs, object_sizes)
    from repro_torch.kernels import policy_step as ps

    engine = Engine(device=dev)
    reqs, calls, rank_s = {}, 0, 0.0
    for K, fams in main_groups().items():
        keys, sizes, costs = [], [], []
        for fam in fams:
            k = family_batch(fam, T, seeds=range(seeds))
            table = object_sizes(family_footprint(fam), seed=1)
            keys.append(k)
            sizes.append(table[k])
            costs.append(fetch_costs(table)[k])
        reqs[K] = Request.of(np.concatenate(keys), np.concatenate(sizes),
                             np.concatenate(costs), device=dev)
    ps.LAUNCHES = 0
    for K, fams in main_groups().items():
        B = seeds * len(fams)
        rows = {fam: {"family": fam, "K": K, "lanes": seeds}
                for fam in fams}
        for spec in ("dac", "ac", "climb", "fifo"):
            res, s = host_s(lambda: engine.replay(spec, reqs[K], K,
                                                  **main_mode(spec)))
            m = res.metrics
            if not (torch.all(m.requests == T) and torch.all(m.hits <= T)
                    and np.isfinite(res.byte_miss_ratio).all()
                    and np.isfinite(res.penalty_ratio).all()):
                raise AssertionError(f"K={K} {spec}: bad metrics {m}")
            for j, fam in enumerate(fams):
                lanes = slice(j * seeds, (j + 1) * seeds)
                rows[fam][spec] = {
                    "miss_ratio": float(res.miss_ratio[lanes].mean()),
                    "byte_miss_ratio":
                        float(res.byte_miss_ratio[lanes].mean())}
                if res.obs is not None:               # DAC's active size
                    k = res.obs["k"][lanes].double()
                    rows[fam][spec].update(
                        mean_k=float(k.mean()), final_k=float(k[:, -1].mean()),
                        min_k=int(k.min()), max_k=int(k.max()))
            emit({"phase": "main_path_call", "K": K, "policy": spec,
                  "lanes": B, "T": T, "s": s, "Mreq_s": B * T / s / 1e6})
            if spec != "fifo":
                calls += 1
                rank_s += s
        for row in rows.values():
            for spec in ("dac", "ac"):
                row[f"mrr_{spec}"] = mrr(row[spec]["miss_ratio"],
                                         row["fifo"]["miss_ratio"])
            emit({"phase": "main_path", **row})
    launches = ps.LAUNCHES
    if launches != calls:
        raise AssertionError(
            f"policy_replay launched {launches} times on the main path; "
            f"expected one per rank-policy replay ({calls})")
    return launches, rank_s * 1e3 / launches


def phase_large(dev):
    import numpy as np
    from repro_torch.core import Engine, lane_pad
    from repro_torch.data.traces import k_for, zipf_trace
    from repro_torch.kernels import policy_step as ps

    N, B, T = 1 << 20, 128, 100_000
    K = k_for(N, "L")
    keys = np.stack([zipf_trace(N, T, 0.9, seed=s) for s in range(B)])
    ps.LAUNCHES = 0
    res, s = host_s(lambda: Engine(device=dev).replay_stream(
        "dac(growth=4)", keys, K, chunk=1 << 15, observe=True))
    launches = ps.LAUNCHES
    if launches != -(-T // (1 << 15)):
        raise AssertionError(f"large state: {launches} launches")
    if not (np.all(res.metrics.requests == T)
            and np.isfinite(res.obs["k"]).all()):
        raise AssertionError("large state: bad metrics")
    return {"phase": "large_state", "N": N, "K": K, "lanes": B, "T": T,
            "row_MB_per_lane": 4 * lane_pad(4 * K) / 1e6,
            "Mreq_s": B * T / s / 1e6, "s": s,
            "miss_ratio": float(np.mean(res.miss_ratio)),
            "mean_k": float(np.mean(res.obs["k"])), "launches": launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "next to this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    reports = _build.build(["policy_step"])
    emit({"phase": "device_build", "device": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in reports.items()}})

    res = phase_step(dev)
    err = res["max_abs_err"]
    emit(res)
    res, e, timing = phase_replay(dev)
    err = max(err, e)
    emit(res)
    launches, main_ms = phase_main(dev)
    emit({"phase": "main_path_launches", "policy_replay": launches,
          "ms_per_launch": main_ms})
    emit(phase_large(dev))

    print(json.dumps({"kernels": [{
        "name": "policy_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/policy_step.cu",
        "replaces": "src/repro/kernels/policy_step.py:247",
        "launches": launches, "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
