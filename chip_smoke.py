#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # all phases; needs one CUDA device

Phases, one JSON line each:

1. device and build: the card, its power limit, the kernels' build time;
2. kernel vs plain, bit for bit, on the card: ``policy_step_batched``
   against the plain step for the four plans (Climb, AdaptiveClimb, DAC,
   DAC with a cap) over K in {1, 7, 127, 128, 129, 1000, 419428} and empty,
   mid-fill and full rows, and at the widths on both sides of each of
   B1's size dispatches (one warp per lane, one block per lane with the
   row in shared memory, in device memory), which ``b1_edges`` reads from
   the kernel's own dispatch;
   ``policy_replay`` against the plain step loop for climb, ac and dac
   with ``collect_info`` on and off and ``observe`` on at B=8 (T=2048,
   ``REPLAY_CHECK_T``, as every untimed case; the timed T=4096); for
   each capacity group of the main path at its lane count and in its mode
   (dac at K=819 is the timed case); for ``dac(growth=4)`` at the large
   state's width (row in device memory) with lanes that grow and shrink;
   for ``dac(growth=4)`` and climb on both sides of each dispatch; and,
   untimed, for dac, ac and climb at Table III's S capacities (K = 8, 16)
   on its 3 lanes and for dac and ac at the corpus sweep's smallest K on 1
   lane, in ``run_sweep``'s modes;
3. the main path: the six dataset families as ``[16, 200000]`` traces
   through ``Engine(device="cuda").replay`` for dac, ac and climb at
   ``K = k_for(footprint, "L")`` (families of one K share a call: 64
   lanes at K=819, 32 at K=1638); miss ratios, Mreq/s, DAC's active size
   ``k``; MRR against FIFO over the first ``FIFO_T`` requests, which all
   four policies replay (FIFO only those: it is a host-bound Python loop);
   B1's mean ms per whole-trace launch beside the mean bound of those
   launches (each launch's ranks counted to the live width, from a rerun
   of its inputs with per-step outputs);
4. large state: zipf over 2^20 ids, K = 104857, ``dac(growth=4)`` on 128
   lanes for T = 100000 through ``Engine.replay_stream``;
5. attention kernels: B2 (``flash_attention``) and B3 (``decode_attention``)
   against their plain versions in f32 and bf16 at deepseek-7b's shapes
   (B2 ``[8, 2048, 32, 128]`` causal; B3 at S = 2112 and at S = 512 with a
   sparse ``valid``), gemma2-27b's (GQA 32/16, window 4096, softcap 50,
   S = 8192, B = 1) and prime lengths; B2 also at deepseek-v2-236b's MLA
   prefill (H = Hkv = 128, D 192 / Dv 128, B = 2; timed at B = 8 beside
   its bound and each SDPA backend that takes D != Dv); B3 also at
   mixtral-8x22b's and qwen1.5-110b's head groups (g = 6, 8),
   musicgen-medium's D = 64, a short prefix in a long buffer, S = 17,
   g = 12 with D 72 / Dv 40, D 34 / Dv 18 (rows copied element by
   element) and D = Dv = 256; B2 also at
   ``FLASH_EDGE_SHAPES`` (D = Dv = 256, D and Dv not multiples of 16, GQA
   8, S = 17, D != Dv, non-causal with Sq != Sk); in bf16 B2 and B3 also
   element by element on bf16's rounding scale (``BF16_C``,
   ``B3_BF16_C``) against the plain version in f32, which rejects the
   output of a kernel that skips 64 keys in B2's last rows
   (``dense_rows``) or one warp tile of B3's P.V (``b3_dropped_tile``);
   B3's mass bit for bit across two launches and its top slot against
   the plain one's; each kernel timed at the serve path's shapes beside
   its bound, its plain version and (B2) ``scaled_dot_product_attention``;
   B3 also at gemma2-27b's window, with the L2 cache cold, with its
   blocks per call, GB/s and share of its bound, beside what the cold
   timing reads for no work (``decode_sweep.py`` times B3's chunk
   lengths); B3's sharded law for a slot-split KV cache
   (``decode_attention_partial`` on each rank's block, ``_merge`` of the
   blocks' partials in rank order; ``SLOT_SHAPES``: qwen1.5-110b's
   ``decode_32k`` rank, 16 blocks of 2,048 slots, H 64 / Hkv 8, D 128;
   mixtral-8x22b's window over 16 blocks with an empty row; musicgen's 24
   heads padded to 32) with all blocks on this card, in f32 and bf16:
   each kernel against its plain version, the law against the unsharded
   B3 and the plain law (``ATTN_TOL``, the mass within ``MASS_REL`` of
   its row's scale, bf16 units), the same bits twice, and two planted
   masses that must fail that check (each head's mass normalised by the
   next head's ``(m, l)``; a uniform one); a block's partial and a rank's
   merge timed at each shape in bf16 with L2 cold beside their byte
   bounds, blocks and launches a call, and the time of an empty launch;
6. serve: deepseek-7b at full width and depth (30 layers, bf16, seeded
   random weights) through ``prefill`` + 64 greedy ``decode_step`` s on
   B = 8 prompts of 2048 tokens, unbounded and with the DAC-bounded pool
   (budget 512); B2 launches 30 times per prefill, B3 30 times per step;
   two more steps of each regime and the unbounded prefill run under
   ``torch.profiler`` (device-busy time, idle share, launches, top kernels);
7. serve vs plain: the same model at 2 layers in f32, prefill + 8
   teacher-forced steps with the kernels and with their plain versions, in
   both regimes (and 3 capped steps in the bounded one, below): logits
   within 1e-4 and DAC's control state equal;
8. slot policies: the twelve slot policies (FIFO, LRU, BLRU, LFU, Clock,
   Sieve, TwoQ, ARC, TinyLFU, Hyperbolic, LIRS, LHD) on the first 2,000
   requests of every dataset family, 3 seeds, lognormal sizes and fetch
   costs, at both ``k_for`` regimes (K = 819 / 1,638 for L, 8 / 16 for S;
   families of one K share a replay): the CUDA graph loop gives the same
   hits, byte and penalty totals and final state bit for bit as the plain
   loop on the CPU (worker processes), every group with lanes that must
   evict (checked), and, over the first ``SLOT_EAGER_T`` = 128 requests,
   as the eager loop on the card; us
   per step of the graph and the eager loop; device operations a step
   (``torch.profiler``) on the first group (``graph_sweep.py`` times other
   graph sizes);
9. Table III: ``benchmarks/mrr_table.py``'s grid (15 policies x 6
   families x {L, S} x 3 seeds, T = ``TABLE_T``) through the port's
   ``Sweep`` / ``run_sweep`` on the card, one B1 launch per rank-policy
   cell (36), each rank cell's record equal to that of ``run_sweep`` on
   the CPU (B1's plain version; worker processes); the payload validated
   and written to ``chiprun_out/mrr_table.json``; the MRR matrix against
   FIFO and the winners;
10. real traces: ``benchmarks/real_traces.py``'s grid (fifo, lru, arc, ac,
   dac over ``benchmarks/corpus``, K in {S, L}) through ``run_sweep``
   streamed and materialized: identical records, the rank cells' equal to
   the CPU's;
11. tier, fleet, admission: ``benchmarks/tenant_sweep.py``'s grid (7
   entries x flux / contended x 3 seeds, T cut to 10,000 from 60,000)
   through ``run_tier_sweep``, ``benchmarks/fleet_sweep.py``'s (6 entries x
   pool / churn x 3 seeds, T cut to 8,000 from 16,000) through ``run_fleet_sweep`` and,
   of ``benchmarks/robustness.py``'s grid (N = 4,096), lru, dac,
   admit(lru) and admit(dac) x 4 scenarios x {S, L} x 2 seeds (T cut to
   5,000 from 40,000) through ``run_sweep``, on the card: DAC's budgeted plan (and
   the rank bases under admission) as one B1 launch a step inside the CUDA
   graph loop, launches counted against their formula (a launch inside a
   graph counts once, at capture), every record equal to the same runner
   on the CPU (worker processes); the graph loop against the eager loop
   over 1,000 steps on one cell of each kind; ``admit(dac)`` stepped on
   the card leaving its input state unwritten and equal to the CPU step by
   step (the gate's revert); DAC's resize laws on ``observe=True``
   replays through B1; us a step and device operations a step;
12. campaign: a six-dataset corpus written at run time (one dataset per
   dataset family, two traces of 300,000 requests each, sizes under
   256 B; uncompressed oracleGeneral files and one gzipped CSV with
   costs) and one planted bad file, through ``repro_torch.campaign``:
   campaign A (fifo, lru, ac, dac x {S, L}, T cut to 5,000) inline on
   the card and on the CPU in worker processes, every record and the
   report equal; campaign B (climb, ac, dac x {S, L}, whole traces, one
   B1 launch a 2^18-request chunk) in two spawned workers on the card,
   which start with no B1 library built, and inline over two of the
   datasets (24 cells) with a crash after 9 cells and a resume, its
   ``cells/`` equal to the spawned run's files of the same cells byte for
   byte and no cell run twice; dac and ac at L on one trace a dataset equal
   to the Python oracle's reckoning; only the planted file quarantined;
   the report's winners and MRR against FIFO, seconds a cell by policy
   (ingest and characterisation, replay, store write) and B1's launches;
13. architectures: deepseek-v2-236b (MLA + MoE, 6 of 60 layers, B = 8,
   2,048-token prompts, 64 steps), mixtral-8x22b (windowed GQA + MoE, 4 of
   56 layers, B = 2, 4,608-token prompts past its 4,096 window, 32
   steps), jamba-1.5-large-398b (its first 5 of 72 layers: four Mamba, two
   of them MoE, and one attention layer; B = 2, 2,048, 32 steps) and
   xlstm-125m (all 12 layers; B = 8, 2,048, 64 steps) at full width in
   bf16, unbounded and with the DAC pool of 512 slots: B2 once a prefill
   per attention and MLA layer, B3 once a step per attention layer (MLA's
   absorbed decode is plain torch), finite logits, the capacity's drops,
   KV bytes, DAC's sizes, and two profiled decode steps with the device
   ms of the MoE, MLA and DAC control; then deepseek-v2-236b and mixtral
   at 2 layers in f32 with kernels against plain versions as phase 7
   does, MoE routing equal too unless a near-tie in the router's
   probabilities is reported;
14. training, through ``repro_torch.train`` with the plain attention (B2
   has no backward, as the reference's Pallas kernel has none): (a)
   deepseek-7b at full width in bf16, 4 of its 30 layers, B = 8 x 2,048
   tokens from the token pipeline, 6 steps through ``Trainer`` with f32
   moments and 6 with int8 ones (seconds a step past the first, tokens/s,
   peak device memory, the loss first to last; the loss finite and
   falling, int8's last loss within 0.15 of f32's); (b) kill and resume
   at full width, 2 layers, B = 2 x 512, 8 steps, a checkpoint every 4
   (int8 moments, async saves), the run killed inside step 6 and resumed
   from its step-4 checkpoint, its losses against the uninterrupted
   run's within ``RESUME_RTOL``; (c) deepseek-7b's and mixtral-8x22b's
   smoke configs in f32, 3 train steps on the card and on the CPU from
   one init and one batch stream, losses and parameters within
   ``TRAIN_VS_CPU_*``; (d) a grad-mode call of B2 raises, and B2's and
   B3's launch counts do not move across the phase;
15. multi-GPU, in worlds of spawned ranks (``launch.mesh.launch_world``)
   after the build: (a) one NCCL rank: ``Engine(mesh=)`` for dac, ac and
   climb on 16 seeds x T = 200,000 and fifo at ``SLOT_T``, and the
   reference test's sharded fleet at n = 1, each equal bit for bit to
   the unsharded run (at n = 1 every re-deal gives the one shard the
   whole budget back); the replays timed after one run of each side,
   unsharded then sharded; beside (a), (b)'s fleets in a 4-rank gloo
   world on the CPU (its own seconds reported); (b) ``MG_WORLD`` = 4
   gloo ranks sharing the card (started while (a) runs, measuring after
   (a) and the CPU world): the reference test's fleet and phase 11's
   "pool" at ``FLEET_T``, sharded over 4 shards, every rank's result
   equal bit for bit to the CPU world's, B1's launches
   against the graph loop's count with the re-deals cutting its chunks;
   ``Engine(mesh=)`` at 64 lanes and a ``run_sweep(mesh=)`` grid equal
   to the unsharded runs; deepseek-7b at full width on a (data 2, model
   2) mesh, 4 layers in bf16 (B = 8 x 512, 16 steps, both regimes, pool
   512; B2 and B3 on each rank's heads, counted), then 2 layers in f32
   with the kernels against the unsharded path and against the sharded
   plain versions (logits within 1e-4, DAC's control equal unless a
   near-tie is reported); µs a fleet step sharded and unsharded, ms a
   re-deal, prefill s and decode ms a step; (c) after (b), ``MG_SLOT_WORLD``
   = 16 gloo ranks sharing the card on a (data 1, model 16) mesh:
   qwen1.5-110b at full width, 1 of 80 layers, whose 8 KV heads do not
   split 16 ways, so that each rank holds a 16th of the cache's slots
   (checked: its KV bytes against the unsharded cache's) and B3 runs as a
   partial a rank and a merge (counted), bf16, B = 8 x 128, 2 steps,
   both regimes (prefill s, decode ms a step); then f32, 2 steps, logits
   within 1e-4 of the unsharded port on rank 0 and DAC's control equal
   unless a near-tie is reported;
16. analysis (``repro_torch.analysis``; it runs after phase 14, before 15):
   the contract pass over the 30 registry specs, the budgeted DAC and
   ``admit(dac)``, the tier and the fleet on the card, each step captured
   into a CUDA graph under ``set_sync_debug_mode("error")`` and its replay
   equal to the eager step bit for bit, and the float64-default-dtype
   sub-pass (64 captures in all); the retrace audit of dac (B1: 7
   launches, one library load) and lru (the graph loop: 7 captures) over
   the nine canonical calls at T = 67 and the six equivalent spellings;
   the linter over the checkout; no finding from any of them; then three
   toy steps as controls (a clean one; a host read, caught by the op
   record and by the capture; a host counter baked into the graph,
   caught by the replay); B1's launches in the phase counted (51);
17. the dry run (``repro_torch.launch.dryrun``; reported after 15; no
   step on the card): deepseek-7b's decode step at phase 6's shape
   traced on one rank and its ``decode_32k`` on the (16, 16) pod mesh in a
   fake world of 256 ranks, on fake CUDA tensors (the phase's seconds
   include torch's first use of them); the first one's argument bytes
   equal to what phase 6's allocator held for the parameters, a fresh
   state and the token (within the allocator's rounding of each storage
   to 512 bytes), its modelled
   roofline terms beside phase 6's measured ms a step and device-busy ms;
   the pod cell's bytes a rank and dominant term; phase 15's world (c):
   qwen1.5-110b's 1-layer rank on the (data 1, model 16) mesh in a fake
   world of 16, its argument bytes against what the rank's allocator
   held and its KV bytes equal.

Phase 7 also runs three bounded decode steps with ``kv_caps`` (one cap a
sequence: deny, partial, full) and holds ``kv_cache.resize(cap=)`` on the
card against the CPU and the caps' law.

Then the kernels line, the card's ``nvidia-smi`` name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero with no result line; so does a machine without CUDA, or a
directory without the port's sources next to this script.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the H100's rates and the kernels' bounds (bound, flash_bound,
# decode_bound) are repro_torch.launch.roofline's
SEED = 20251121
# kernel vs plain, as tests/test_kernels.py states them: in f32 the two sum
# in different orders (online softmax against a full one); in bf16 the
# output is rounded to bf16 (step 2^-8 relative).  B3's mass is f32 on both
# sides from the same inputs, so it is held at the f32 tolerance in both.
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
MASS_TOL = 2e-5
# B3's sharded law holds the mass relative to its scale: each element within
# MASS_REL of its row's largest wanted mass.  The mass is a mean over the
# heads of softmax weights, ~1 / the row's valid slots: ~3e-5 at qwen's
# decode_32k rank, where MASS_TOL would pass a merge that normalises a head
# by its neighbour's (m, l) (planted in ``b3_slot_cases``, which must fail)
MASS_REL = 1e-4
# B2 in bf16, element by element against the plain version in f32 from the
# same bf16 inputs, on the scale of bf16's rounding (2^-8 relative):
#   |got - want| <= BF16_C * (2^-8 * max(|want|, RMS of want's row) + BF16_FLOOR)
# Rounding the output to bf16 alone errs by up to 1 in these units, and
# rounding P to bf16 before P.V adds an error random in sign with a
# standard deviation near 0.3 units, so some 2 units at the largest of
# 10^7-10^8 elements.  On an H100 the kernel reads 2.1-2.9 at every case;
# a kernel that drops 64 keys of the last rows reads 240 or more, which
# the smoke shows for every case (PERF.md).
BF16_C = 4.0
BF16_FLOOR = 1e-6
# B3 in bf16, in the same units against the plain version in f32 from the
# same bf16 inputs: B3 sums in f32 on the CUDA cores and rounds only its
# output to bf16, which errs by at most 1 unit (half a bf16 step is at
# most 2^-8 |want|), so a sound kernel reads 1 or less; a kernel that
# leaves one warp tile's P.V out (8 slots of a batch row) reads more than
# 2, which the smoke shows at every ``DECODE_SHAPES`` row (PERF.md)
B3_BF16_C = 2.0
# serve vs plain, f32 logits: kernels and plain versions differ in
# attention's summation order only (~1e-6 relative); two layers and the
# 4096-wide head keep that near 1e-5 on logits of magnitude ~1-5
SERVE_LOGIT_TOL = 1e-4
BIG_K = 104857 * 4           # DAC kmax of the large-state phase


def b1_edges(ps, plan):
    """The widest row of B1's warp path and of its block path with the row
    in shared memory under ``plan``, read from the kernel's own size
    dispatch (``replay_path``) over the widths it takes (multiples of 128);
    past the second the row lives in device memory."""
    W, path, edges = 128, ps.replay_path(128, plan), []
    while path != ps.PATHS[-1]:
        nxt = ps.replay_path(W + 128, plan)
        if nxt != path:
            edges.append(W)
            path = nxt
        W += 128
    if len(edges) != 2 or ps.replay_path(128, plan) != ps.PATHS[0]:
        raise AssertionError(f"B1's dispatch for plan {plan.pid}: edges "
                             f"{edges}; expected warp, shared, device")
    return edges


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


def cold_ms(fn, flush, reps=10):
    """Median milliseconds of ``fn()`` on the card with the L2 cache cold:
    each launch follows ``flush()`` (a read of more bytes than L2 holds,
    long enough that the host has mostly queued ``fn`` before it ends), and
    a pair of events brackets ``fn`` alone.  The median, so that a launch
    the host was late to queue does not count.  After one warm-up."""
    import statistics

    import torch
    fn()
    pairs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(reps)]
    torch.cuda.synchronize()
    for start, stop in pairs:
        flush()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


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
        rows[b, :n] = rng.choice(10 * K + 10, n, replace=False)
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


def step_case_check(ps, pname, plan, K, fill, rng, dev):
    """Three consecutive ``policy_step_batched`` steps of one (K, fill)
    case, each held against the plain step.  Returns (max abs err, lanes
    grown, lanes shrunk)."""
    import torch
    rows, keys, sc = step_cases(K, fill, plan.pid, rng)
    cache = torch.from_numpy(rows).to(dev)
    key = torch.from_numpy(keys).to(dev)
    scal = tuple(torch.from_numpy(sc).to(dev).unbind(-1))
    err, grows, shrinks = 0.0, 0, 0
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
        if len(scal) >= 4:                            # DAC: k is scalar 2
            grows += int((got[1][2] > scal[2]).sum())
            shrinks += int((got[1][2] < scal[2]).sum())
        cache, scal = got[0], got[1]
        key = cache[:, 0].clone() if s == 0 else key + 1
    return err, grows, shrinks


def phase_step(dev):
    import numpy as np
    from repro_torch.core import lane_pad, make_policy
    from repro_torch.kernels import policy_step as ps

    ps.LAUNCHES = 0
    rng = np.random.default_rng(20251121)
    plans = {"climb": make_policy("climb").plan(),
             "ac": make_policy("ac").plan(),
             "dac": make_policy("dac").plan(),
             "dac_budgeted": make_policy("dac").plan(budgeted=True)}
    err, cases, grows, shrinks = 0.0, 0, 0, 0
    for pname, plan in plans.items():
        for K in (1, 7, 127, 128, 129, 1000, BIG_K):
            for fill in ("empty", "mid", "full"):
                e, g, sh = step_case_check(ps, pname, plan, K, fill, rng, dev)
                err, grows, shrinks = max(err, e), grows + g, shrinks + sh
                cases += 3
    if grows == 0 or shrinks == 0:
        raise Mismatch(f"DAC step cases did not grow and shrink "
                       f"(grows {grows}, shrinks {shrinks})")
    # both sides of each of the kernel's size dispatches, on an rng of their
    # own
    rng = np.random.default_rng(SEED + 1)
    edge_cases, edge_w = 0, set()
    for pname, plan in plans.items():
        warp_w, smem_w = b1_edges(ps, plan)
        for K in (warp_w, warp_w + 1, smem_w, smem_w + 1):
            edge_w.add(lane_pad(K))
            for fill in ("empty", "mid", "full"):
                e, _, _ = step_case_check(ps, pname, plan, K, fill, rng, dev)
                err = max(err, e)
                edge_cases += 3
    return {"phase": "kernel_vs_plain_step", "cases": cases,
            "dac_grows": grows, "dac_shrinks": shrinks,
            "dispatch_edge_cases": edge_cases,
            "dispatch_edge_W": sorted(edge_w),
            "max_abs_err": err, "launches": ps.LAUNCHES}


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
    """A state and requests for a wide row: rows full to ``k``; for DAC,
    lanes that grow on their first request (``jump`` one below ``2k``,
    then a miss), lanes that shrink on it (at the halving threshold, then a
    hit at rank 0), and lanes at random ``jump``/``jump'``; after the first
    request, hits at any depth and fresh misses, half each."""
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
        if "jump2" not in pol.SCALARS:
            continue
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


def live_ops(info, sc0, W, pid):
    """The rank operations a replay's data needs, the find counted to the
    live width: on a hit the ``m + 1`` ranks up to the key, on a miss the
    live width before the step (``n`` for Climb and AdaptiveClimb, DAC's
    ``k``), past which every rank is EMPTY; the ranks shifted; and the
    ranks a DAC shrink wipes (``k`` before less ``k`` after; every other
    wipe is of ranks that are EMPTY already).  The ``work`` counts keep
    ``W`` for a miss and those wipes.  ``info`` is a replay of the inputs
    with ``collect_info`` and ``observe``, ``sc0`` the scalars before it,
    ``W`` the kernel's row width."""
    import torch
    from repro_torch.core.policy import PLAN_ADAPTIVECLIMB, PLAN_CLIMB
    col = {PLAN_CLIMB: 0, PLAN_ADAPTIVECLIMB: 1}.get(pid, 2)
    live = torch.cat([sc0[:, None, col], info.obs[:, :-1, col]], 1)
    live = live.long().clamp(0, W)
    miss = ~info.hit
    scanned, moved, _ = info.work.sum(0).tolist()
    ops = scanned - W * int(miss.sum()) + int(live[miss].sum()) + moved
    if col == 2:
        ops += int((live - info.obs[..., 2].long()).clamp(min=0).sum())
    return ops


REPLAY_CHECK_T = 2048


def main_mode(spec):
    """The main path's replay flags: totals only, and DAC's k."""
    return {"collect_info": False, "observe": spec == "dac"}


def phase_replay(dev):
    """``policy_replay`` against the plain loop on the same inputs, every
    output bit for bit: every policy and mode at B=8; each capacity group
    of the main path at its lane count and in its mode (dac at K=819 is
    the timed case of the kernels line); ``dac(growth=4)`` at the large
    state's width, where the row lives in device memory, with lanes that
    grow and shrink; both sides of each size dispatch; Table III's and the
    corpus sweep's small capacities."""
    import torch
    from repro_torch.core import make_policy
    from repro_torch.data.traces import k_for
    from repro_torch.kernels import policy_step as ps
    from repro_torch.launch import roofline as R

    T = 4096
    K0 = min(main_groups())
    modes = ((True, True), (False, True), (False, False))
    # the cases that are not timed replay the first REPLAY_CHECK_T requests
    # (4,096 until phase 15 served on 16 ranks, PERF.md §4)
    T_check = REPLAY_CHECK_T
    cases = [(8, K0, "alibaba", spec, {"collect_info": ci, "observe": ob})
             for spec in ("climb", "ac", "dac") for ci, ob in modes]
    for K, fams in main_groups().items():
        cases += [(16 * len(fams), K, fams[0], spec, main_mode(spec))
                  for spec in ("dac", "ac", "climb")]
    big = make_policy("dac(growth=4)")
    K_big, B_big, T_big = k_for(1 << 20, "L"), 16, 256
    wide = {K_big: large_state_inputs(big, K_big, B_big, T_big, dev)}
    cases += [(B_big, K_big, None, "dac(growth=4)",
               {"collect_info": ci, "observe": True}) for ci in (True, False)]
    # both sides of each of the kernel's size dispatches: the widest rows of
    # the warp path and the narrowest of the block path, the widest held in
    # shared memory and the narrowest in device memory
    for spec, kmax_per_k in (("dac(growth=4)", 4), ("climb", 1)):
        for W_edge in b1_edges(ps, make_policy(spec).plan()):
            K_lo = W_edge // kmax_per_k
            for K in (K_lo, K_lo + 1):
                wide[spec, K] = large_state_inputs(make_policy(spec), K,
                                                   B_big, T_big, dev, seed=K)
                cases.append((B_big, K, (spec, K), spec,
                              {"collect_info": True, "observe": True}))

    # Table III's and the corpus sweep's small capacities (run_sweep's lane
    # counts and modes: a lane a seed, no per-step outputs, the corpus
    # sweep observes), checked and not timed
    untimed = len(cases)
    for (regime, K), fams in slot_groups().items():
        if regime == "S":
            cases += [(len(TABLE_SEEDS), K, fams[0], spec,
                       {"collect_info": False, "observe": False})
                      for spec in ("dac", "ac", "climb")]
    K_corpus = min(K for *_, K, _ in corpus_sweep().cells())
    cases += [(1, K_corpus, "alibaba", spec,
               {"collect_info": False, "observe": True})
              for spec in ("dac", "ac")]

    err, timing, inputs, rows, resizes = 0.0, None, {}, [], [0, 0]
    for i, (B, K, fam, spec, kw) in enumerate(cases):
        pol = make_policy(spec)
        if fam is None or isinstance(fam, tuple):
            cache, sc, reqs = wide[K if fam is None else fam]
            T_case = T_big
        else:
            T_case = T_check if B == 8 or i >= untimed else T
            if (B, fam, T_case) not in inputs:
                inputs[B, fam, T_case] = replay_inputs(B, T_case, dev, fam)
            st = pol.init(K, lanes=B, device=dev)
            cache = st["cache"]
            sc = torch.stack([st[n] for n in pol.SCALARS], -1)
            reqs = inputs[B, fam, T_case]
        args = (cache, sc, *reqs, pol.plan())
        got = ps.policy_replay(*args, **kw)
        want, plain_s = host_s(lambda: ps.replay_plain(*args, **kw))
        for f in got._fields:
            err = max(err, max_err(getattr(got, f), getattr(want, f),
                                   f"replay {spec} B={B} K={K} {kw} {f}"))
        W = cache.shape[1]
        if isinstance(fam, tuple) and spec.startswith("dac") and not (
                (got.obs[..., 2] > K).any() and (got.obs[..., 2] < K).any()):
            raise Mismatch(f"replay {spec} W={W}: lanes did not resize")
        if fam is None:
            k = got.obs[..., 2]
            resizes[0] += int((k > K).any(1).sum())
            resizes[1] += int((k < K).any(1).sum())
        if B == 8 or i >= untimed:
            continue
        info = got if kw["collect_info"] and kw["observe"] else \
            ps.policy_replay(*args, collect_info=True, observe=True)
        ops = live_ops(info, sc, W, pol.plan().pid)
        b_ms, b_by, b_sms = R.bound(got, B, T_case, W, sc.shape[1], ops)
        ms = cuda_ms(lambda: ps.policy_replay(*args, **kw))
        row = {"spec": spec, "shape": [B, T_case], "K": K, "W": W,
               "path": ps.replay_path(W, pol.plan()), **kw,
               "ms": ms, "us_per_step": ms * 1e3 / T_case,
               "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
               "bound_by": b_by, **b_sms, "ops": ops,
               "work": got.work.sum(0).tolist()}
        rows.append(row)
        if K == K0 and spec == "dac":
            timing = row
    if resizes[0] == 0 or resizes[1] == 0:
        raise Mismatch(f"large-state replay lanes did not grow and shrink "
                       f"(lanes grown {resizes[0]}, shrunk {resizes[1]})")
    return ({"phase": "kernel_vs_plain_replay", "runs": len(cases),
             "untimed": [{"lanes": B, "K": K, "spec": spec, **kw}
                         for B, K, _, spec, kw in cases[untimed:]],
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


# FIFO is plain torch, its time loop a CUDA graph of GRAPH_CHUNK steps
# (29-37 us a step on an H100, PERF.md §5; the eager loop took ~270 us):
# it replays the first FIFO_T requests of each trace, and MRR compares
# every policy over that same prefix; the rank policies also replay the
# whole trace, which is the main path's timed run
FIFO_T = 50_000


def phase_main(dev, seeds=16, T=200_000):
    """The main path; returns its B1 launches, their mean ms (whole-trace
    calls) and the mean bound of those launches."""
    import numpy as np
    import torch
    from repro_torch.core import Engine, Request, lane_pad
    from repro_torch.data.traces import (family_batch, family_footprint,
                                         fetch_costs, object_sizes)
    from repro_torch.kernels import policy_step as ps
    from repro_torch.launch import roofline as R

    engine = Engine(device=dev)
    reqs = {}
    for K, fams in main_groups().items():
        keys, sizes, costs = [], [], []
        for fam in fams:
            k = family_batch(fam, T, seeds=range(seeds))
            table = object_sizes(family_footprint(fam), seed=1)
            keys.append(k)
            sizes.append(table[k])
            costs.append(fetch_costs(table)[k])
        cols = [np.concatenate(x) for x in (keys, sizes, costs)]
        for T_w in (T, FIFO_T):
            reqs[K, T_w] = Request.of(*(np.ascontiguousarray(x[:, :T_w])
                                        for x in cols), device=dev)
    # record each launch's inputs and outputs (the engine keeps only the
    # metrics) for the bound of the main path's launches
    replay, works = ps.policy_replay, []

    def recording(cache, scalars, keys, *args, **kw):
        out = replay(cache, scalars, keys, *args, **kw)
        works.append((cache, scalars, keys, args, out))
        return out

    ps.policy_replay = recording
    ps.LAUNCHES = 0
    try:
        calls, rank_s = main_calls(engine, reqs, seeds, T)
    finally:
        ps.policy_replay = replay
    launches = ps.LAUNCHES
    if launches != calls or len(works) != calls:
        raise AssertionError(
            f"policy_replay launched {launches} times on the main path; "
            f"expected one per rank-policy replay ({calls})")
    # each whole-trace launch's bound, its live-width ranks from a rerun of
    # its inputs with per-step outputs (launched after the count was read)
    full = []
    for cache, scalars, keys, args, out in works:
        if keys.shape[1] != T:
            continue
        W = lane_pad(cache.shape[1])
        info = replay(cache, scalars, keys, *args, collect_info=True,
                      observe=True)
        if not torch.equal(info.work, out.work):
            raise AssertionError("main path: a rerun's work counts differ")
        ops = live_ops(info, scalars, W, args[-1].pid)
        full.append(R.bound(out, cache.shape[0], T, W, scalars.shape[1],
                          ops)[0])
        del info
    return launches, rank_s * 1e3 / len(full), sum(full) / len(full)


def main_calls(engine, reqs, seeds, T):
    """The main path's engine calls: every capacity group through dac, ac,
    climb (whole traces and the MRR prefix) and fifo (the prefix).
    Returns (rank-policy calls, seconds of the whole-trace ones)."""
    import numpy as np
    import torch
    from repro_torch.core import mrr
    calls, rank_s = 0, 0.0
    for K, fams in main_groups().items():
        B = seeds * len(fams)
        rows = {fam: {"family": fam, "K": K, "lanes": seeds}
                for fam in fams}
        for spec in ("dac", "ac", "climb", "fifo"):
            windows = ((FIFO_T,) if spec == "fifo" else (T, FIFO_T))
            for T_w in windows:
                res, s = host_s(lambda: engine.replay(spec, reqs[K, T_w], K,
                                                      **main_mode(spec)))
                m = res.metrics
                if not (torch.all(m.requests == T_w)
                        and torch.all(m.hits <= T_w)
                        and np.isfinite(res.byte_miss_ratio).all()
                        and np.isfinite(res.penalty_ratio).all()):
                    raise AssertionError(f"K={K} {spec}: bad metrics {m}")
                window = "full" if T_w == T else "prefix"
                for j, fam in enumerate(fams):
                    lanes = slice(j * seeds, (j + 1) * seeds)
                    row = {"miss_ratio": float(res.miss_ratio[lanes].mean()),
                           "byte_miss_ratio":
                               float(res.byte_miss_ratio[lanes].mean())}
                    if res.obs is not None:           # DAC's active size
                        k = res.obs["k"][lanes].double()
                        row.update(mean_k=float(k.mean()),
                                   final_k=float(k[:, -1].mean()),
                                   min_k=int(k.min()), max_k=int(k.max()))
                    rows[fam].setdefault(spec, {})[window] = row
                emit({"phase": "main_path_call", "K": K, "policy": spec,
                      "lanes": B, "T": T_w, "s": s,
                      "Mreq_s": B * T_w / s / 1e6})
                if spec != "fifo":
                    calls += 1
                    if T_w == T:
                        rank_s += s
        for row in rows.values():
            for spec in ("dac", "ac"):
                row[f"mrr_{spec}"] = mrr(row[spec]["prefix"]["miss_ratio"],
                                         row["fifo"]["prefix"]["miss_ratio"])
            emit({"phase": "main_path", "mrr_T": FIFO_T, **row})
    return calls, rank_s


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


# ---------------------------------------------------------------------------
# phase 5: attention kernels B2 and B3 against their plain versions
# ---------------------------------------------------------------------------

def close_err(got, want, tol, what):
    """Largest absolute difference; raises above ``tol``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise Mismatch(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                       f"{want.dtype}{tuple(want.shape)}")
    d = (got.double() - want.double()).abs().max().item()
    if not d <= tol:
        raise Mismatch(f"{what}: max abs err {d} > {tol}")
    return d


def dense_rows(q, k, v, rows, drop, *, causal=True, window=None,
               softcap=0.0):
    """Plain attention in f32 for the query rows ``rows`` with the keys
    ``drop`` hidden from them: the output a wrong kernel would give if it
    skipped those keys (with ``drop`` empty, ``attention_dense``'s rows)."""
    import math

    import torch
    B, Sq, H, D = q.shape
    Sk, g = k.shape[1], H // k.shape[2]
    qf = q[:, rows].float() / math.sqrt(D)
    kf, vf = (x.float().repeat_interleave(g, 2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos, kpos = rows[:, None], torch.arange(Sk, device=q.device)[None]
    keep = torch.ones((len(rows), Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    keep[:, drop] = False
    s = torch.where(keep, s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf)


def bf16_scale(want32):
    """The scale of bf16's rounding error at each element of an f32 output:
    max(|want|, RMS of want's row over its last axis)."""
    import torch
    return torch.maximum(want32.abs(),
                         want32.square().mean(-1, keepdim=True).sqrt())


def bf16_units(got, want32, scale):
    """Largest |got - want| in units of 2^-8 * scale (+ ``BF16_FLOOR``)."""
    return ((got.float() - want32).abs()
            / (2.0 ** -8 * scale + BF16_FLOOR)).max().item()


def b2_case(fa, q, k, v, kw, what):
    """B2 against its plain version on one case, within ``ATTN_TOL``; in
    bf16 also element by element within ``BF16_C`` against the plain
    version in f32, and the output of a kernel that skips 64 keys (the
    middle of the last row's visible keys) in the last 64 query rows must
    exceed that.  Returns the case's readings."""
    import torch
    got = fa.flash_attention(q, k, v, **kw)
    want32 = fa.attention_dense(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    tol = ATTN_TOL[str(q.dtype).removeprefix("torch.")]
    row = {"max_abs_err": close_err(got.float(), want32.to(q.dtype).float(),
                                    tol, what), "tol": tol}
    if q.dtype != torch.bfloat16:
        return row
    scale = bf16_scale(want32)
    row["scaled_err"] = bf16_units(got, want32, scale)
    if not row["scaled_err"] <= BF16_C:
        raise Mismatch(f"{what}: {row['scaled_err']} > {BF16_C} units of "
                       f"bf16 rounding")
    Sq, Sk = q.shape[1], k.shape[1]
    causal, window = kw.get("causal", True), kw.get("window")
    last = Sq - 1
    lo = max(0, last - window + 1) if window else 0
    hi = last + 1 if causal else Sk
    mid = (lo + hi) // 2
    rows = torch.arange(max(0, Sq - 64), Sq, device=q.device)
    drop = torch.arange(mid, min(mid + 64, hi), device=q.device)
    dkw = dict(causal=causal, window=window, softcap=kw.get("softcap", 0.0))
    close_err(dense_rows(q, k, v, rows, drop[:0], **dkw), want32[:, rows],
              ATTN_TOL["float32"], what + " dense_rows")
    bad = dense_rows(q, k, v, rows, drop, **dkw).to(q.dtype)
    row["dropped_keys_scaled_err"] = bf16_units(bad, want32[:, rows],
                                                scale[:, rows])
    if not row["dropped_keys_scaled_err"] > BF16_C:
        raise Mismatch(f"{what}: the bf16 check passes a kernel that drops "
                       f"{len(drop)} keys of the last rows")
    return row


def randn(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


# name, B, S, H, Hkv, D, Dv, window, softcap.  deepseek-v2-236b's MLA
# prefill (D = dn + dr = 192, Dv = 128, 128 heads without GQA) is checked
# at B = 2 (at the serve path's B = 8 the plain version's f32 scores alone
# would be 17 GB) and timed at B = 8 (``b2_mla_timing``)
FLASH_SHAPES = [
    ("deepseek-7b", 8, 2048, 32, 32, 128, 128, None, 0.0),
    ("gemma2-27b", 1, 8192, 32, 16, 128, 128, 4096, 50.0),
    ("prime", 2, 1021, 8, 2, 96, 64, 300, 30.0),
    ("deepseek-v2-236b mla", 2, 2048, 128, 128, 192, 128, None, 0.0),
]
B2_MLA_TIMED = (8, 2048, 128, 128, 192, 128)     # B, S, H, Hkv, D, Dv
# B2's edge cases, each in f32 and bf16 against the plain version (own
# generator): name, B, Sq, Sk, H, Hkv, D, Dv, window, softcap, causal.
# D = Dv = 256 (the 4-warp tensor-core tiles), D and Dv not multiples of 16
# (zero-padded in shared memory) nor of 8 (copied element by element),
# GQA with H/Hkv = 8, a 17-token sequence (one ragged tile), D != Dv across
# the tile classes, and non-causal attention with Sq != Sk
FLASH_EDGE_SHAPES = [
    ("d256", 2, 1000, 1000, 8, 4, 256, 256, None, 0.0, True),
    ("d72-dv40", 2, 777, 777, 8, 2, 72, 40, 200, 20.0, True),
    ("d36-dv20", 1, 300, 300, 4, 2, 36, 20, None, 0.0, True),
    ("gqa8", 2, 1024, 1024, 32, 4, 128, 128, None, 0.0, True),
    ("s17", 3, 17, 17, 4, 2, 128, 128, None, 0.0, True),
    ("d96-dv256", 1, 500, 500, 4, 4, 96, 256, 100, 0.0, True),
    ("non-causal", 2, 200, 333, 8, 4, 64, 64, None, 0.0, False),
]
# name, B, S, H, Hkv, D, Dv, softcap, valid pattern.  After the serve
# path's shapes and gemma2-27b's window: the query-head groups of
# mixtral-8x22b (48/8, g = 6) and qwen1.5-110b (64/8, g = 8),
# musicgen-medium's D = 64, a short prefix in a long buffer (as early in
# an unbounded decode: most of the slot axis holds no valid slot), a
# 17-slot table with an empty row, and three edges of the kernel: 12 query
# heads a kv head (two head groups) with D 72 / Dv 40 (K rows of 9 and
# 18 16-byte pieces in bf16 and f32, V rows of 5 and 10), D 34 / Dv 18
# (rows of 68 / 36 bytes in bf16, 136 / 72 in f32: no multiple of 16, so
# copied element by element, not by cp.async), and D = Dv = 256 (in f32
# the most shared memory a block takes)
DECODE_SHAPES = [
    ("deepseek-7b unbounded", 8, 2112, 32, 32, 128, 128, 0.0, "prefix"),
    ("deepseek-7b bounded", 8, 512, 32, 32, 128, 128, 0.0, "sparse"),
    ("gemma2-27b window", 1, 8192, 32, 16, 128, 128, 50.0, "window"),
    ("prime", 3, 1021, 8, 2, 96, 64, 30.0, "sparse+empty"),
    ("mixtral-8x22b heads", 4, 1024, 48, 8, 128, 128, 0.0, "sparse"),
    ("qwen1.5-110b heads", 4, 1024, 64, 8, 128, 128, 0.0, "prefix"),
    ("musicgen-medium d64", 8, 512, 24, 24, 64, 64, 0.0, "sparse"),
    ("short prefix", 8, 2112, 32, 32, 128, 128, 0.0, "short"),
    ("s17", 3, 17, 8, 2, 128, 128, 0.0, "sparse+empty"),
    ("g12 d72-dv40", 2, 300, 24, 2, 72, 40, 0.0, "sparse+empty"),
    ("d34-dv18", 2, 333, 6, 2, 34, 18, 20.0, "sparse+empty"),
    ("d256", 2, 600, 8, 2, 256, 256, 0.0, "prefix"),
]
# B3's timed cases (bf16): the serve path's two regimes and gemma2-27b's
# window, each with the L2 cache cold, as a decode step finds it (every
# layer reads its own cache)
DECODE_TIMED = ("deepseek-7b unbounded", "deepseek-7b bounded",
                "gemma2-27b window")
FLUSH_BYTES = 1 << 29        # 512 MB read between timed launches (L2: 50 MB)
# B3's sharded law on a slot-split cache (``decode_attention_partial`` over
# each of n ranks' blocks of the slots for every head, the partials dealt
# by heads and merged in rank order by ``decode_attention_merge``), all n
# blocks on this card, held against the unsharded B3 over the whole table:
# name, B, S, H, Hkv, D, Dv, softcap, valid pattern, n.  qwen1.5-110b's
# ``decode_32k`` rank (16 blocks of 2,048, the case in the kernels line);
# mixtral-8x22b's window over 16 blocks (most blocks without a valid slot
# in rows that have some) with an empty row; musicgen-medium's 24 heads
# (padded to 32 for the exchange by heads); a rank's block of 16,384 slots
# at D = Dv = 256 (chunks over 1,024 slots, taken in pieces); D 34 / Dv 18
# with a softcap (the partial's CUDA-core body in bf16 too, rows copied
# element by element)
SLOT_SHAPES = [
    ("qwen1.5-110b decode_32k rank", 8, 32768, 64, 8, 128, 128, 0.0,
     "prefix", 16),
    ("mixtral-8x22b window", 4, 16384, 48, 8, 128, 128, 0.0, "window+empty",
     16),
    ("musicgen-medium heads", 8, 4096, 24, 24, 64, 64, 0.0, "sparse+empty",
     16),
    ("long block d256", 1, 32768, 16, 8, 256, 256, 0.0, "sparse", 2),
    ("d34-dv18", 2, 4096, 12, 2, 34, 18, 20.0, "sparse+empty", 4),
]
SLOT_TIMED = "qwen1.5-110b decode_32k rank"


def decode_valid(pattern, B, S, gen, dev):
    """valid [B, S]: ``prefix`` as the unbounded serve step builds it
    (slots <= pos, pos = S - 64 + 8b); ``short`` the same with
    pos = 37 + 9b <= 100; ``sparse`` 70% at random; ``window`` slots
    > pos - 4096 at pos = S - 1; ``+empty`` clears the last row."""
    import torch
    ar = torch.arange(S, device=dev)[None]
    if pattern in ("prefix", "short"):
        first = S - 64 if pattern == "prefix" else 37
        step = 8 if pattern == "prefix" else 9
        pos = first + step * torch.arange(B, device=dev)[:, None]
        return ar <= pos
    if pattern.startswith("window"):
        valid = (ar > S - 1 - 4096).expand(B, S).contiguous()
    else:
        valid = torch.rand((B, S), generator=gen, device=dev) < 0.7
    if pattern.endswith("+empty"):
        valid[-1] = False
    return valid


def b3_timing(da, q, k, v, valid, cap, flush):
    """B3 at one timed case: the kernel's ms with L2 cold, its blocks per
    call (each of its two launches), the bytes its bound counts over the
    kernel's time, its share of the bound, and the plain version's ms."""
    from repro_torch.launch import roofline as R
    B, S = valid.shape
    H, Hkv, D, Dv = q.shape[1], k.shape[2], q.shape[2], v.shape[3]
    b_ms, b_by = R.decode_bound(q, k, v, valid)
    ms = cold_ms(lambda: da.decode_attention(q, k, v, valid, softcap=cap),
                 flush, reps=20)
    return {"shape": [B, S, H, Hkv, D, Dv], "dtype": "bfloat16",
            "valid_slots": int(valid.sum()), "chunk": da.chunk_len(B, Hkv, S),
            "blocks_per_call": da.blocks_per_call(B, S, H, Hkv, D, Dv),
            "ms": ms,
            "plain_ms": cuda_ms(lambda: da.decode_attention_plain(
                q, k, v, valid, softcap=cap), reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms,
            "gb_per_s": b_ms / ms * R.HBM_BW / 1e9}


def b3_dropped_tile(q, k, v, valid, cap):
    """B3's plain version in f32 with one warp tile's P.V left out of each
    batch row: the 8 slots (a tile of the kernel: chunks are multiples of
    8) around the row's middle fetched slot, whose weights stay in the
    softmax's sum, as a kernel that loses a tile of V would compute it."""
    import torch
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qf = (q.float() / D ** 0.5).reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k.float())
    if cap:
        s = torch.tanh(s / cap) * cap
    p = torch.softmax(torch.where(valid[:, None, None], s, -1e30), dim=-1)
    for b in range(B):
        fetched = valid[b] if bool(valid[b].any()) else torch.ones_like(
            valid[b])
        idx = fetched.nonzero()[:, 0]
        t0 = int(idx[len(idx) // 2]) // 8 * 8
        p[b, ..., t0:t0 + 8] = 0.0
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(B, H, v.shape[3])


def b3_sharded(da, q, k, v, valid, cap, n, plain=False):
    """B3's sharded law on this card: the partial over each of ``n`` equal
    blocks of the slots (every head, the whole rows' ``valid``), the heads
    padded to a multiple of ``n`` and dealt ``Hp / n`` to a rank as the
    exchange deals them, each rank's merge of its heads in block order with
    its block's mass; the kernels, or with ``plain`` their plain versions.
    Returns ``(o [B, H, Dv], mass [B, S], parts, scores, padded, ml)``."""
    import torch
    H, S = q.shape[1], k.shape[1]
    Sb = S // n
    partial = (da.decode_attention_partial_plain if plain
               else da.decode_attention_partial)
    merge = da.decode_attention_merge_plain if plain \
        else da.decode_attention_merge
    parts, scores = [], []
    for r in range(n):
        blk = slice(r * Sb, (r + 1) * Sb)
        p, sc = partial(q, k[:, blk], v[:, blk], valid, r * Sb, softcap=cap)
        parts.append(p)
        scores.append(sc)
    padded = torch.stack([da.pad_heads(p, n) for p in parts])
    ml = torch.stack(parts)[..., -2:].contiguous()
    hn = padded.shape[2] // n
    outs, mass = [], []
    for r in range(n):
        o, m = merge(padded[:, :, r * hn:(r + 1) * hn], ml, scores[r],
                     dtype=q.dtype)
        outs.append(o)
        mass.append(m)
    return (torch.cat(outs, dim=1)[:, :H], torch.cat(mass, dim=-1), parts,
            scores, padded, ml)


def part_err(got, want, what):
    """Largest difference of two partials ``[B, H, Dv + 2]`` (acc, m, l),
    in terms that do not grow with a block's slots: the block's output
    ``acc / l``, ``m``, and ``l`` relative to max(l, 1); raises above
    ``ATTN_TOL["float32"]`` (both are f32 sums of the same f32 products in
    other orders)."""
    import torch
    Dv = got.shape[-1] - 2
    l_g, l_w = got[..., Dv + 1], want[..., Dv + 1]
    errs = [
        close_err(got[..., :Dv] / l_g.clamp(min=1e-30)[..., None],
                  want[..., :Dv] / l_w.clamp(min=1e-30)[..., None],
                  ATTN_TOL["float32"], what + " acc / l"),
        close_err(got[..., Dv], want[..., Dv], ATTN_TOL["float32"],
                  what + " m"),
        close_err((l_g - l_w) / torch.clamp(l_w, min=1.0),
                  torch.zeros_like(l_w), ATTN_TOL["float32"], what + " l")]
    return max(errs)


def mass_err(got, want, scale, what):
    """Largest difference of two masses ``[B, S]`` over ``scale`` (``[B,
    1]``, the row's largest wanted mass); raises above ``MASS_REL``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise Mismatch(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                       f"{want.dtype}{tuple(want.shape)}")
    d = ((got.double() - want.double()).abs() / scale).max().item()
    if not d <= MASS_REL:
        raise Mismatch(f"{what}: max err {d} of the row's scale > {MASS_REL}")
    return d


def planted_mass(what, mass, want, scale):
    """A wrong mass that ``mass_err`` must refuse: its reading."""
    try:
        mass_err(mass, want, scale, what)
    except Mismatch:
        return ((mass.double() - want.double()).abs() / scale).max().item()
    raise Mismatch(f"{what}: the mass check passes a planted wrong mass")


def b3_slot_cases(da, dev, flush):
    """``SLOT_SHAPES`` in f32 and bf16: each block's partial kernel against
    its plain version (and its raw scores), each rank's merge kernel
    against its plain version on the same partials, the law with the
    kernels against the unsharded B3 and against the law with the plain
    versions (``o`` within ``ATTN_TOL``, the mass within ``MASS_REL`` of
    its row's scale, in bf16 ``o`` also within ``B3_BF16_C`` units of the
    plain version in f32), the same bits from two runs of the law; two
    planted masses that the mass check must refuse (the merge kernel with
    each head's ``(m, l)`` taken from the next head, and a uniform mass
    over the valid slots); every case in bf16 timed (``b3_slot_timing``),
    beside what an empty launch reads under the same cold timing.
    Returns (rows, errors, timed by case)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows, err, timed = [], {"partial": 0.0, "merge": 0.0}, {}
    floor_ms = cold_ms(lambda: da.noop_launch(dev), flush, reps=20)
    for name, B, S, H, Hkv, D, Dv, cap, pattern, n in SLOT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, D), dtype, dev)
            k = randn(gen, (B, S, Hkv, D), dtype, dev)
            v = randn(gen, (B, S, Hkv, Dv), dtype, dev)
            valid = decode_valid(pattern, B, S, gen, dev)
            what = f"B3 sharded {name} {dtype}"
            tol = ATTN_TOL[str(dtype).removeprefix("torch.")]
            o, mass, parts, scores, padded, ml = b3_sharded(
                da, q, k, v, valid, cap, n)
            o2, mass2 = b3_sharded(da, q, k, v, valid, cap, n)[:2]
            torch.cuda.synchronize()
            if not (torch.equal(o, o2) and torch.equal(mass, mass2)):
                raise Mismatch(f"{what}: two runs differ")
            del o2, mass2
            uo, um = da.decode_attention(q, k, v, valid, softcap=cap)
            scale = um.double().amax(-1, keepdim=True)
            Sb, hn = S // n, padded.shape[2] // n
            e_part = e_merge = e_merge_rel = 0.0
            # the merge with each head's (m, l) from the next head's
            rolled = ml.roll(-1, dims=2).contiguous()
            wrong = []
            for r in range(n):
                blk = slice(r * Sb, (r + 1) * Sb)
                pp, ps = da.decode_attention_partial_plain(
                    q, k[:, blk], v[:, blk], valid, r * Sb, softcap=cap)
                e_part = max(e_part, part_err(parts[r], pp,
                                              f"{what} partial {r}"),
                             close_err(scores[r], ps, ATTN_TOL["float32"],
                                       f"{what} scores {r}"))
                mine = padded[:, :, r * hn:(r + 1) * hn]
                po, pm = da.decode_attention_merge_plain(mine, ml, scores[r],
                                                         dtype=dtype)
                mo, mm = da.decode_attention_merge(mine, ml, scores[r],
                                                   dtype=dtype)
                e_merge = max(e_merge, close_err(mo.float(), po.float(), tol,
                                                 f"{what} merge {r} o"),
                              (mm.double() - pm.double()).abs().max().item())
                e_merge_rel = max(e_merge_rel, mass_err(
                    mm, pm, scale, f"{what} merge {r} mass"))
                wrong.append(da.decode_attention_merge(
                    mine, rolled, scores[r], dtype=dtype)[1])
            del pp, ps, po, pm, mo, mm
            lo, lm = b3_sharded(da, q, k, v, valid, cap, n, plain=True)[:2]
            fetched = torch.where(valid.any(-1, keepdim=True), valid, True)
            uniform = fetched / fetched.sum(-1, keepdim=True).float()
            row = {"kernel": "B3 sharded", "case": name, "dtype": str(dtype),
                   "shape": [B, S, H, Hkv, D, Dv], "blocks": n,
                   "softcap": cap, "valid": pattern,
                   "valid_slots": int(valid.sum()),
                   "empty_blocks": int((~valid.reshape(B, n, Sb).any(-1)
                                        & valid.any(-1)[:, None]).sum()),
                   "partial_max_err": e_part, "merge_max_abs_err": e_merge,
                   "merge_mass_rel": e_merge_rel,
                   "vs_unsharded_o": close_err(o.float(), uo.float(), tol,
                                               what + " vs unsharded o"),
                   "vs_unsharded_mass_rel": mass_err(
                       mass, um, scale, what + " vs unsharded mass"),
                   "vs_unsharded_mass_abs": (mass - um).abs().max().item(),
                   "mass_scale": [scale.min().item(), scale.max().item()],
                   "vs_plain_o": close_err(o.float(), lo.float(), tol,
                                           what + " vs plain o"),
                   "vs_plain_mass_rel": mass_err(mass, lm, scale,
                                                 what + " vs plain mass"),
                   "planted_neighbour_ml_rel": planted_mass(
                       what + " planted (m, l) of the next head",
                       torch.cat(wrong, dim=-1), um, scale),
                   "planted_uniform_rel": planted_mass(
                       what + " planted uniform mass", uniform, um, scale),
                   "tol": tol, "mass_rel": MASS_REL,
                   "bit_identical_run_to_run": True}
            del uo, um, lo, lm, wrong, uniform, rolled
            if dtype == torch.bfloat16:
                want32, _ = da.decode_attention_plain(
                    q.float(), k.float(), v.float(), valid, softcap=cap)
                row["scaled_err"] = bf16_units(o, want32, bf16_scale(want32))
                if not row["scaled_err"] <= B3_BF16_C:
                    raise Mismatch(f"{what}: o {row['scaled_err']} > "
                                   f"{B3_BF16_C} units of bf16 rounding")
                del want32
            err["partial"] = max(err["partial"], e_part)
            err["merge"] = max(err["merge"], e_merge)
            rows.append(row)
            if dtype == torch.bfloat16:
                timed[name] = b3_slot_timing(da, q, k, v, valid, cap, n,
                                             flush)
                timed[name]["merge"]["launch_floor_ms"] = floor_ms
            del q, k, v, o, mass, parts, scores, padded, ml
            torch.cuda.empty_cache()
    return rows, err, timed


def launches_per_call(fn):
    """Kernels the card ran for one call of ``fn`` (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def b3_slot_timing(da, q, k, v, valid, cap, n, flush):
    """The sharded law at one case, bf16, L2 cold (``cold_ms``): block 0's
    partial (a rank's kernel time a step) and rank 0's merge with its
    block's mass, each beside its byte bound, its plain version's ms, its
    blocks (and the partial's body and split) and the kernels one call
    runs; the unsharded B3 over the whole table beside them."""
    import torch
    from repro_torch.launch import roofline as R
    B, S, Hkv = q.shape[0], k.shape[1], k.shape[2]
    H, D, Dv = q.shape[1], q.shape[2], v.shape[3]
    Sb = S // n
    kb, vb = k[:, :Sb].contiguous(), v[:, :Sb].contiguous()
    part, sc = da.decode_attention_partial(q, kb, vb, valid, 0, softcap=cap)
    parts = torch.stack([da.pad_heads(part, n)] * n)
    ml = torch.stack([part[..., -2:]] * n).contiguous()
    mine = parts[:, :, :parts.shape[2] // n].contiguous()
    p_ms, p_by = R.partial_bound(q, kb, vb, valid, 0)
    m_ms, m_by = R.merge_bound(mine, ml, sc, q.dtype)

    def partial():
        return da.decode_attention_partial(q, kb, vb, valid, 0, softcap=cap)

    def merge():
        return da.decode_attention_merge(mine, ml, sc, dtype=q.dtype)
    out = {"shape": [B, S, H, Hkv, D, Dv], "blocks": n, "block_slots": Sb,
           "dtype": "bfloat16"}
    out["partial"] = {
        "ms": cold_ms(partial, flush, reps=20),
        "plain_ms": cuda_ms(lambda: da.decode_attention_partial_plain(
            q, kb, vb, valid, 0, softcap=cap), reps=5),
        "bound_ms": p_ms, "bound_by": p_by,
        **da.partial_plan(q.dtype, B, Sb, H, Hkv, D, Dv),
        "launches_per_call": launches_per_call(partial)}
    out["merge"] = {
        "ms": cold_ms(merge, flush, reps=20),
        "plain_ms": cuda_ms(lambda: da.decode_attention_merge_plain(
            mine, ml, sc, dtype=q.dtype), reps=5),
        "bound_ms": m_ms, "bound_by": m_by,
        **da.merge_plan(n, B, mine.shape[2], H, Sb, Dv),
        "launches_per_call": launches_per_call(merge)}
    for row in (out["partial"], out["merge"]):
        row["bound_share"] = row["bound_ms"] / row["ms"]
    u_ms, _ = R.decode_bound(q, k, v, valid)
    out["unsharded"] = {
        "ms": cold_ms(lambda: da.decode_attention(q, k, v, valid,
                                                  softcap=cap),
                      flush, reps=20), "bound_ms": u_ms}
    return out


def sdpa_backends(qt, kt, vt):
    """``scaled_dot_product_attention(is_causal=True)`` on these inputs:
    the ms of each fused backend that takes them (or why it refuses), and
    the default call's ms and the kernels it launched (which name the
    backend it chose).  The math backend is left out: at the MLA shape its
    scores alone would be 8.6 GB."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([be]):
                out[be.name] = cuda_ms(lambda: sdpa(qt, kt, vt,
                                                    is_causal=True))
        except RuntimeError as e:      # the backend does not take this shape
            out[be.name] = f"refused: {str(e).splitlines()[0][:120]}"
    out["default_ms"] = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa(qt, kt, vt, is_causal=True)
        torch.cuda.synchronize()
    out["default_kernels"] = sorted(
        {e.key[:80] for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA})
    return out


def b2_mla_timing(fa, gen, dev):
    """B2 at deepseek-v2-236b's MLA prefill shape (``B2_MLA_TIMED``, bf16,
    causal, the default scale 1/sqrt(192)): ms, bound, TFLOP/s, and SDPA's
    backends on the same inputs (timed only)."""
    import torch
    from repro_torch.launch import roofline as R
    B, S, H, Hkv, D, Dv = B2_MLA_TIMED
    dt = torch.bfloat16
    q = randn(gen, (B, S, H, D), dt, dev)
    k = randn(gen, (B, S, Hkv, D), dt, dev)
    v = randn(gen, (B, S, Hkv, Dv), dt, dev)
    b_ms, b_by, flops = R.flash_bound(B, S, H, Hkv, D, Dv, dt)
    row = {"shape": [B, S, H, Hkv, D, Dv], "dtype": "bfloat16",
           "ms": cuda_ms(lambda: fa.flash_attention(q, k, v)),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops}
    row["tflops"] = flops / row["ms"] / 1e9
    row["bound_share"] = b_ms / row["ms"]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    del q, k, v
    row["sdpa"] = sdpa_backends(qt, kt, vt)
    del qt, kt, vt
    torch.cuda.empty_cache()
    return row


def phase_attention(dev):
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import roofline as R

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, err = [], {"flash": 0.0, "decode": 0.0}
    timed = {}
    # the MLA shape draws from its own generator, so that the other cases'
    # inputs stay those of earlier runs
    gen_mla = torch.Generator(device=dev).manual_seed(SEED + 2)
    for name, B, S, H, Hkv, D, Dv, win, cap in FLASH_SHAPES:
        g = gen_mla if name.endswith(" mla") else gen
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(g, (B, S, H, D), dtype, dev)
            k = randn(g, (B, S, Hkv, D), dtype, dev)
            v = randn(g, (B, S, Hkv, Dv), dtype, dev)
            kw = dict(window=win, softcap=cap)
            case = b2_case(fa, q, k, v, kw, f"B2 {name} {dtype}")
            err["flash"] = max(err["flash"], case["max_abs_err"])
            rows.append({"kernel": "B2", "case": name, "dtype": str(dtype),
                         "shape": [B, S, H, Hkv, D, Dv], "window": win,
                         "softcap": cap, **case})
            if name == "deepseek-v2-236b mla" and dtype == torch.bfloat16:
                rows[-1]["plain_ms"] = cuda_ms(
                    lambda: fa.attention_dense(q, k, v, **kw), reps=1)
            if name == "deepseek-7b" and dtype == torch.bfloat16:
                # the serve path's shape: kernel, plain, SDPA (timed only)
                qt, kt, vt = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                b_ms, b_by, flops = R.flash_bound(B, S, H, Hkv, D, Dv, dtype)
                timed["flash"] = {
                    "shape": [B, S, H, D], "dtype": "bfloat16",
                    "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                    "plain_ms": cuda_ms(
                        lambda: fa.attention_dense(q, k, v, **kw), reps=1),
                    "library_ms": cuda_ms(
                        lambda: sdpa(qt, kt, vt, is_causal=True)),
                    "bound_ms": b_ms, "bound_by": b_by, "flops": flops}
                timed["flash"]["tflops"] = (
                    flops / timed["flash"]["ms"] / 1e9)
                del qt, kt, vt
            del q, k, v
    timed["flash_mla"] = b2_mla_timing(fa, gen_mla, dev)
    gen_edge = torch.Generator(device=dev).manual_seed(SEED + 1)
    for (name, B, Sq, Sk, H, Hkv, D, Dv, win, cap,
         causal) in FLASH_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen_edge, (B, Sq, H, D), dtype, dev)
            k = randn(gen_edge, (B, Sk, Hkv, D), dtype, dev)
            v = randn(gen_edge, (B, Sk, Hkv, Dv), dtype, dev)
            kw = dict(window=win, softcap=cap, causal=causal)
            case = b2_case(fa, q, k, v, kw, f"B2 {name} {dtype}")
            err["flash"] = max(err["flash"], case["max_abs_err"])
            rows.append({"kernel": "B2", "case": name, "dtype": str(dtype),
                         "shape": [B, Sq, Sk, H, Hkv, D, Dv], "window": win,
                         "softcap": cap, "causal": causal, **case})
    torch.cuda.empty_cache()

    near_ties = 0
    flush_buf = torch.ones(FLUSH_BYTES // 4, device=dev)

    def flush():
        flush_buf.sum()
    for name, B, S, H, Hkv, D, Dv, cap, pattern in DECODE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, H, D), dtype, dev)
            k = randn(gen, (B, S, Hkv, D), dtype, dev)
            v = randn(gen, (B, S, Hkv, Dv), dtype, dev)
            valid = decode_valid(pattern, B, S, gen, dev)
            o, mass = da.decode_attention(q, k, v, valid, softcap=cap)
            o2, mass2 = da.decode_attention(q, k, v, valid, softcap=cap)
            po, pm = da.decode_attention_plain(q, k, v, valid, softcap=cap)
            torch.cuda.synchronize()
            what = f"B3 {name} {dtype}"
            if not (torch.equal(mass, mass2) and torch.equal(o, o2)):
                raise Mismatch(f"{what}: two launches differ")
            tol = ATTN_TOL[str(dtype).removeprefix("torch.")]
            e_o = close_err(o.float(), po.float(), tol, what + " o")
            e_m = close_err(mass, pm, MASS_TOL, what + " mass")
            err["decode"] = max(err["decode"], e_o, e_m)
            bf16 = {}
            if dtype == torch.bfloat16:
                want32, _ = da.decode_attention_plain(
                    q.float(), k.float(), v.float(), valid, softcap=cap)
                scale = bf16_scale(want32)
                bf16["scaled_err"] = bf16_units(o, want32, scale)
                if not bf16["scaled_err"] <= B3_BF16_C:
                    raise Mismatch(f"{what}: o {bf16['scaled_err']} > "
                                   f"{B3_BF16_C} units of bf16 rounding")
                bad = b3_dropped_tile(q, k, v, valid, cap).to(dtype)
                bf16["dropped_tile_scaled_err"] = bf16_units(bad, want32,
                                                             scale)
                if not bf16["dropped_tile_scaled_err"] > B3_BF16_C:
                    raise Mismatch(f"{what}: the bf16 check passes a kernel "
                                   f"that drops one warp tile's P.V")
                del want32, scale, bad
            masked = pm.masked_fill(~valid, float("-inf"))
            top2 = masked.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1] > MASS_TOL) & valid.any(-1)
            got_top = mass.masked_fill(~valid, float("-inf")).argmax(-1)
            if not torch.equal(got_top[clear], masked.argmax(-1)[clear]):
                raise Mismatch(f"{what}: top slot differs from the plain "
                               f"one's where the margin exceeds {MASS_TOL}")
            ties = int((~clear & valid.any(-1)).sum())
            near_ties += ties
            rows.append({"kernel": "B3", "case": name, "dtype": str(dtype),
                         "shape": [B, S, H, Hkv, D, Dv], "softcap": cap,
                         "valid": pattern,
                         "valid_slots": int(valid.sum()),
                         "max_abs_err_o": e_o, "max_abs_err_mass": e_m,
                         "tol": tol, "mass_tol": MASS_TOL,
                         "mass_bit_identical_run_to_run": True,
                         "rows_top_slot_checked": int(clear.sum()),
                         "rows_within_margin": ties, **bf16})
            if name in DECODE_TIMED and dtype == torch.bfloat16:
                if pattern == "sparse":          # as after a bounded fill
                    valid = torch.ones_like(valid)
                timed[name] = b3_timing(da, q, k, v, valid, cap, flush)
            del q, k, v, o, o2, po
    slot_rows, slot_err, timed["slot"] = b3_slot_cases(da, dev, flush)
    rows += slot_rows
    err.update(slot_err)
    # what cold_ms reads for no work at all: the floor under B3's times
    event_pair_ms = cold_ms(lambda: None, flush, reps=20)
    del flush_buf
    torch.cuda.empty_cache()
    b2_bf16 = [r for r in rows if "scaled_err" in r and r["kernel"] == "B2"]
    b3_bf16 = [r for r in rows if "scaled_err" in r and r["kernel"] == "B3"]
    slot_bf16 = [r for r in slot_rows if "scaled_err" in r]
    return ({"phase": "attention_kernels", "cases": rows,
             "b2_bf16_scaled_err_max": max(r["scaled_err"] for r in b2_bf16),
             "b2_bf16_dropped_keys_scaled_err_min": min(
                 r["dropped_keys_scaled_err"] for r in b2_bf16),
             "b2_bf16_limit": BF16_C,
             "b3_bf16_scaled_err_max": max(r["scaled_err"] for r in b3_bf16),
             "b3_bf16_dropped_tile_scaled_err_min": min(
                 r["dropped_tile_scaled_err"] for r in b3_bf16),
             "b3_bf16_limit": B3_BF16_C,
             "b3_sharded_bf16_scaled_err_max": max(
                 r["scaled_err"] for r in slot_bf16),
             "b3_rows_within_margin": near_ties,
             "b3_event_pair_ms": event_pair_ms, "timed": timed},
            err, timed)


# ---------------------------------------------------------------------------
# phases 6 and 7: the serve path
# ---------------------------------------------------------------------------

SERVE_B, SERVE_S, SERVE_GEN, SERVE_BUDGET = 8, 2048, 64, 512
SERVE_MAX_LEN = SERVE_S + SERVE_GEN + 2   # two traced steps at the end


def prompt_tokens(cfg, B, S, dev, n=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + n)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)


def profile_ms(fn, n=1, ranges=()):
    """Run ``fn`` ``n`` times under ``torch.profiler``: host ms per call,
    device-busy ms per call (sum of kernel times; one stream, so kernels do
    not overlap), the idle share, B3's device ms per call (its kernels'
    names hold ``decode_attn``), kernel launches per call and the kernels
    that take most device time; with ``ranges`` (``record_function``
    labels), the device ms per call of the kernels launched inside each
    and the times each was entered over the ``n`` calls (a range nested in
    one of its own label counts once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    dev = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        # a range's own device event spans its kernels: not a kernel
        if (us > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and e.key not in ranges):
            dev[e.key] = (us / 1e3 / n, e.count / n)
    busy = sum(ms for ms, _ in dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:6]
    split = {}

    def kernels_us(e):
        """Device time of the kernels the ops under ``e`` launched (a
        range's own device event, its span, left out)."""
        own = 0 if e.name in ranges else sum(k.duration for k in e.kernels)
        return own + sum(kernels_us(c) for c in e.cpu_children)
    if ranges:
        split = {"range_device_ms": {label: 0.0 for label in ranges},
                 "range_entries": {label: 0 for label in ranges}}
        for e in prof.events():
            # a range also leaves a device event of its name: count its
            # host event only
            if (e.name not in ranges
                    or e.device_type != torch.autograd.DeviceType.CPU):
                continue
            up = e.cpu_parent
            while up is not None and up.name != e.name:
                up = up.cpu_parent
            if up is None:                      # outermost of its label
                split["range_device_ms"][e.name] += kernels_us(e) / 1e3 / n
                split["range_entries"][e.name] += 1
    return {**split, "host_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall if wall else None,
            "b3_device_ms": sum(ms for k, (ms, _) in dev.items()
                                if "decode_attn" in k),
            "kernel_launches": sum(c for _, c in dev.values()),
            "top_kernels_ms": {k[:60]: ms for k, (ms, _) in top}}


def phase_serve(dev):
    """deepseek-7b at full width and depth: prefill + greedy decode, once
    unbounded and once in the DAC-bounded pool."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, param_count
    from repro_torch.serving import decode_step, prefill
    from repro_torch.serving import serve_step as ss

    cfg = ARCHS["deepseek-7b"]
    L = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_len = SERVE_MAX_LEN
    # what a decode step's arguments hold on the card (phase 17 holds the
    # dry run's reckoning to it): the parameters, a fresh state (built here
    # only to weigh it; prefill builds its own) and a token a sequence
    mem0 = torch.cuda.memory_allocated()
    params, init_s = host_s(lambda: init_params(cfg, gen, device=dev))
    mem_params = torch.cuda.memory_allocated() - mem0
    state = ss.init_serve_state(cfg, SERVE_B, max_len, device=dev)
    token = torch.zeros(SERVE_B, dtype=torch.int64, device=dev)
    step_args = {"allocated_bytes": torch.cuda.memory_allocated() - mem0,
                 "params_bytes": mem_params, "max_len": max_len}
    del state, token
    tokens = prompt_tokens(cfg, SERVE_B, SERVE_S, dev)
    out, seqs = {}, {}
    for regime, budget in (("unbounded", 0), ("bounded", SERVE_BUDGET)):
        fa.LAUNCHES = da.LAUNCHES = 0
        (state, logits), pre_s = host_s(lambda: prefill(
            params, cfg, tokens=tokens, max_len=max_len, budget=budget))
        b2 = fa.LAUNCHES
        if b2 != L:
            raise AssertionError(f"{regime} prefill launched B2 {b2} times; "
                                 f"expected one per layer ({L})")
        toks = [logits.argmax(-1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_GEN):
            state, logits = decode_step(params, cfg, state, token=toks[-1],
                                        eps=0.5, k_min=16)
            toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        b3 = da.LAUNCHES
        if b3 != L * SERVE_GEN:
            raise AssertionError(f"{regime} decode launched B3 {b3} times; "
                                 f"expected {L} per step ({L * SERVE_GEN})")
        if not (logits.shape == (SERVE_B, cfg.vocab)
                and bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{regime}: bad logits {logits.shape}")
        seqs[regime] = torch.stack(toks, 1).cpu()
        row = {"prefill_s": pre_s, "decode_s": dec_s,
               "decode_tok_s": SERVE_B * SERVE_GEN / dec_s,
               "ms_per_step": dec_s * 1e3 / SERVE_GEN,
               "b2_launches": b2, "b3_launches": b3,
               "kv_bytes_allocated": ss.kv_bytes(state),
               "final_pos": int(state["pos"][0])}
        holder = {"state": state, "tok": toks[-1]}

        def one_step():
            holder["state"], lg = decode_step(params, cfg, holder["state"],
                                              token=holder["tok"], eps=0.5,
                                              k_min=16)
            holder["tok"] = lg.argmax(-1)
        # two more steps, traced (positions past the timed run's end stay
        # inside the unbounded buffers: max_len has room for them)
        row["decode_step_profile"] = profile_ms(one_step, n=2)
        state = holder["state"]
        if budget:
            ks = torch.stack([st["ctrl"]["k_active"]
                              for st in state["layers"]]).cpu().numpy()
            live = torch.stack([st["ctrl"]["length"]
                                for st in state["layers"]]).cpu().numpy()
            row.update(k_active_min=int(ks.min()),
                       k_active_median=float(np.median(ks)),
                       k_active_max=int(ks.max()),
                       live_slots_per_layer_seq=[int(live.min()),
                                                 int(live.max())])
            row["kv_bytes_live"] = int(
                live.sum() * 2 * cfg.n_kv_heads * cfg.head_dim * 2)
        else:
            row["kv_bytes_live"] = int(
                L * SERVE_B * row["final_pos"] * 2 * cfg.n_kv_heads
                * cfg.head_dim * 2)
        out[regime] = row
        del state, logits, holder
        torch.cuda.empty_cache()
        if not budget:   # the bounded fill's ~80k tiny launches trace slowly
            row["prefill_profile"] = profile_ms(lambda: prefill(
                params, cfg, tokens=tokens, max_len=max_len))
            torch.cuda.empty_cache()
    same = (seqs["bounded"] == seqs["unbounded"])
    first_diff = [int(np.argmin(r)) if not r.all() else None
                  for r in same.numpy()]
    del params
    torch.cuda.empty_cache()
    return {"phase": "serve", "arch": cfg.name, "layers": L,
            "d_model": cfg.d_model, "params": param_count(cfg),
            "dtype": cfg.param_dtype, "batch": SERVE_B,
            "prompt": SERVE_S, "gen": SERVE_GEN, "budget": SERVE_BUDGET,
            "init_s": init_s, "step_args": step_args, **out,
            "greedy_agreement": float(same.float().mean()),
            "first_disagreement_step": first_diff}


def moe_layers(cfg):
    return sum(bool(sp.moe and cfg.moe) for sp in cfg.layer_specs())


def serve_vs_plain(dev, cfg, B, S, steps, budget, cap_steps, n=1):
    """One regime of the serve path with the kernels against the same path
    with their plain versions (prefill + ``steps`` teacher-forced decode
    steps, then ``cap_steps`` with ``kv_caps`` when bounded): f32 logits
    within ``SERVE_LOGIT_TOL`` up to the first step where DAC's control or
    an MoE routing differs, which only a near-tie may explain (the plain
    run's top-2 mass margin, or the gap between the router's k-th and
    (k+1)-th probability, within ``MASS_TOL``).  Launches: B2 one a prefill
    per attention and MLA layer, B3 one a step per attention layer."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, moe
    from repro_torch.serving import decode_step, prefill
    from repro_torch.serving import serve_step as ss

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    kinds = [sp.kind for sp in cfg.layer_specs()]
    n_b2 = sum(k in ("attn", "mla") for k in kinds)
    n_b3 = kinds.count("attn")
    n_moe = moe_layers(cfg)
    toks = prompt_tokens(cfg, B, S + steps + cap_steps, dev, n=n)
    rec = {"plain": False, "margins": [], "routes": []}
    top_slot, route = ss._top_slot, moe.route

    def recording_top(mass, valid):
        if rec["plain"]:
            top2 = mass.masked_fill(~valid, float("-inf")).topk(2).values
            rec["margins"][-1].append(float((top2[:, 0] - top2[:, 1]).min()))
        return top_slot(mass, valid)

    def recording_route(x, w, c):
        idx, gates, probs = route(x, w, c)
        top = probs.topk(c.moe.top_k + 1, dim=-1).values
        gap = float((top[..., -2] - top[..., -1]).min())
        rec["routes"].append((idx.clone(), gap))
        return idx, gates, probs

    runs = {}
    ss._top_slot, moe.route = recording_top, recording_route
    try:
        for impl in ("kernel", "plain"):
            fa.LAUNCHES = da.LAUNCHES = 0
            rec.update(plain=impl == "plain", margins=[], routes=[])
            state, last = prefill(params, cfg, tokens=toks[:, :S],
                                  max_len=S + steps + cap_steps,
                                  budget=budget, impl=impl)
            logs, ctrls = [last], []
            n_steps = steps + (cap_steps if budget else 0)
            for t in range(S, S + n_steps):
                rec["margins"].append([])
                caps = None
                if t >= S + steps:
                    # one cap a sequence, as an arbiter would grant
                    caps = kv_caps_for(next(
                        st for st in state["layers"]
                        if "ctrl" in st)["ctrl"]["k_active"])
                state, lg = decode_step(params, cfg, state, token=toks[:, t],
                                        kv_caps=caps, impl=impl)
                logs.append(lg)
                if budget:
                    ctrls.append([{k: x.clone() for k, x in
                                   st["ctrl"].items()}
                                  for st in state["layers"] if "ctrl" in st])
            want = (n_b2, n_b3 * n_steps)
            got = (fa.LAUNCHES, da.LAUNCHES)
            if got != (want if impl == "kernel" else (0, 0)):
                raise AssertionError(f"{cfg.name} {budget} {impl}: launches "
                                     f"{got}, expected {want}")
            if len(rec["routes"]) != n_moe * (1 + n_steps):
                raise AssertionError(f"{cfg.name}: {len(rec['routes'])} "
                                     f"routings, expected {n_moe} a pass")
            runs[impl] = (logs, ctrls, [min(m, default=float("inf"))
                                        for m in rec["margins"]],
                          list(rec["routes"]))
            del state
    finally:
        ss._top_slot, moe.route = top_slot, route
    (klogs, kctrl, _, kroutes), (plogs, pctrl, pmarg, proutes) = (
        runs["kernel"], runs["plain"])
    errs = [(a - b).abs().max().item() for a, b in zip(klogs, plogs)]
    ctrl_diff = [t for t, (a, b) in enumerate(zip(kctrl, pctrl))
                 if any(not torch.equal(x[k], y[k])
                        for x, y in zip(a, b) for k in x)]
    near = [t for t in ctrl_diff if pmarg[t] <= MASS_TOL]
    # routing call c belongs to the logits at index c // n_moe (0: prefill)
    route_diff = [c for c, ((a, _), (b, _)) in enumerate(zip(kroutes,
                                                               proutes))
                  if not torch.equal(a, b)]
    route_near = [c for c in route_diff if proutes[c][1] <= MASS_TOL]
    row = {"logits_max_abs_err": max(errs), "per_step_err": errs,
           "tol": SERVE_LOGIT_TOL}
    if budget:
        row.update(ctrl_steps_differing=ctrl_diff, near_tie_steps=near,
                   min_top2_margin=float(np.min(pmarg)))
    if n_moe:
        row.update(routing_calls=len(proutes),
                   routing_calls_differing=route_diff,
                   routing_near_ties=route_near,
                   min_router_gap=min(g for _, g in proutes))
    if ctrl_diff and ctrl_diff[0] not in near:
        raise Mismatch(f"serve vs plain {cfg.name} {budget}: ctrl differs at "
                       f"step {ctrl_diff[0]} with a top-2 margin "
                       f"{pmarg[ctrl_diff[0]]} > {MASS_TOL}")
    if route_diff and route_diff[0] not in route_near:
        raise Mismatch(f"serve vs plain {cfg.name} {budget}: routing call "
                       f"{route_diff[0]} differs with a router gap "
                       f"{proutes[route_diff[0]][1]} > {MASS_TOL}")
    first = len(errs)
    if ctrl_diff:
        first = ctrl_diff[0] + 1
    if route_diff:
        first = min(first, route_diff[0] // n_moe)
    if max(errs[:first], default=0.0) > SERVE_LOGIT_TOL:
        raise Mismatch(f"serve vs plain {cfg.name} {budget}: logits differ "
                       f"by {max(errs[:first])} > {SERVE_LOGIT_TOL}")
    row["logits_compared"] = first
    del params
    torch.cuda.empty_cache()
    return row


def phase_serve_vs_plain(dev):
    """The serve path with the kernels against the same path with their
    plain versions, at full width and 2 layers in f32."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS["deepseek-7b"], n_layers=2,
                              param_dtype="float32")
    steps = 8
    out = {regime: serve_vs_plain(dev, cfg, SERVE_B, SERVE_S, steps, budget,
                                  CAP_STEPS)
           for regime, budget in (("unbounded", 0),
                                  ("bounded", SERVE_BUDGET))}
    return {"phase": "serve_vs_plain", "arch": cfg.name, "layers": 2,
            "dtype": "float32", "batch": SERVE_B, "prompt": SERVE_S,
            "steps": steps, "budget": SERVE_BUDGET,
            "capped_steps": CAP_STEPS, **out,
            "kv_caps_law": kv_caps_law(dev)}


# ---------------------------------------------------------------------------
# phase 13: the served architectures beyond dense attention
# ---------------------------------------------------------------------------

# name, layers kept of the config's, B, prompt, greedy steps; at full width,
# bf16, seeded random weights, unbounded and with the DAC pool of
# ARCH_BUDGET slots
ARCH_SERVE = (
    # MLA + MoE (160 experts, top 6, 2 shared); 6 of 60 layers: 49.8 GB of
    # weights, room left for the prefill's dispatch buffers
    ("deepseek-v2-236b", 6, 8, 2048, 64),
    # windowed GQA 48/8 + MoE (8 experts, top 2); 4 of 56 layers; the
    # prompt passes the 4,096 window, so it binds in B2 and B3
    ("mixtral-8x22b", 4, 2, 4608, 32),
    # the first 5 of 72 layers: four Mamba layers (two with MoE, 16
    # experts of width 24,576) and the attention layer at index 4
    ("jamba-1.5-large-398b", 5, 2, 2048, 32),
    # mLSTM + sLSTM, nothing cut
    ("xlstm-125m", 12, 8, 2048, 64),
)
ARCH_BUDGET = 512
# serve vs plain in f32 at 2 layers: name, B, prompt, teacher-forced steps
ARCH_VS_PLAIN = (("deepseek-v2-236b", 2, 1024, 8),
                 ("mixtral-8x22b", 1, 4608, 8))
# the device ranges a decode step's profile splits out
STEP_RANGES = {"moe": (("repro_torch.models.moe", "moe_apply"),),
               "mla": (("repro_torch.models.mla", "mla_latent"),
                       ("repro_torch.models.mla", "mla_attend")),
               "dac_control": (("repro_torch.serving.kv_cache", "insert"),
                               ("repro_torch.serving.kv_cache", "hit"),
                               ("repro_torch.serving.kv_cache", "resize"),
                               ("repro_torch.serving.serve_step",
                                "_top_slot"))}


def profile_split(fn, n=2):
    """``profile_ms`` of ``n`` calls of ``fn`` with the device ms split into
    the serve step's MoE FFNs, MLA attention (latent + absorbed attention)
    and DAC control (insert, hit, resize, top slot): each of those
    functions runs inside a ``record_function`` range while profiled."""
    import importlib

    import torch
    saved = []

    def ranged(orig, label):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return orig(*a, **kw)
        return wrapped
    try:
        for label, targets in STEP_RANGES.items():
            for mod_name, attr in targets:
                mod = importlib.import_module(mod_name)
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, ranged(getattr(mod, attr), label))
        return profile_ms(fn, n=n, ranges=tuple(STEP_RANGES))
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def serve_arch(dev, name, layers, B, S, gen):
    """One architecture at full width and ``layers`` deep: prefill + ``gen``
    greedy decode steps, unbounded and with the DAC pool."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, moe, param_count
    from repro_torch.serving import decode_step, prefill
    from repro_torch.serving import serve_step as ss

    t_arch = time.perf_counter()
    cfg = dataclasses.replace(ARCHS[name], n_layers=layers)
    specs = cfg.layer_specs()
    n_b2 = sum(sp.kind in ("attn", "mla") for sp in specs)
    n_b3 = sum(sp.kind == "attn" for sp in specs)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = host_s(lambda: init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev))
    res = {"arch": name, "layers": layers,
           "layers_of_config": ARCHS[name].n_layers,
           "kinds": [sp.kind + ("+moe" if sp.moe and cfg.moe else "")
                     for sp in specs],
           "params": param_count(cfg), "param_bytes": sum(
               x.numel() * x.element_size() for x in _leaves(params)),
           "batch": B, "prompt": S, "gen": gen, "budget": ARCH_BUDGET,
           "init_s": init_s,
           "init_peak_bytes": torch.cuda.max_memory_allocated()}
    tokens = prompt_tokens(cfg, B, S, dev)
    max_len = S + gen + 2                      # two profiled steps at the end
    dispatch, drops = moe.dispatch, []

    def counting(e_flat, E, C):
        slot, keep = dispatch(e_flat, E, C)
        drops.append((~keep).sum())
        return slot, keep
    seqs = {}
    for regime, budget in (("unbounded", 0), ("bounded", ARCH_BUDGET)):
        fa.LAUNCHES = da.LAUNCHES = 0
        drops.clear()
        moe.dispatch = counting
        try:
            (state, logits), pre_s = host_s(lambda: prefill(
                params, cfg, tokens=tokens, max_len=max_len, budget=budget))
        finally:
            moe.dispatch = dispatch
        if fa.LAUNCHES != n_b2:
            raise AssertionError(f"{name} {regime} prefill launched B2 "
                                 f"{fa.LAUNCHES} times; expected {n_b2}")
        toks = [logits.argmax(-1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gen):
            state, logits = decode_step(params, cfg, state, token=toks[-1],
                                        eps=0.5, k_min=16)
            toks.append(logits.argmax(-1))
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        if da.LAUNCHES != n_b3 * gen:
            raise AssertionError(f"{name} {regime} decode launched B3 "
                                 f"{da.LAUNCHES} times; expected "
                                 f"{n_b3 * gen}")
        if not (logits.shape == (B, cfg.vocab)
                and bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{name} {regime}: bad logits")
        seqs[regime] = torch.stack(toks, 1).cpu()
        row = {"prefill_s": pre_s, "decode_s": dec_s,
               "decode_tok_s": B * gen / dec_s,
               "ms_per_step": dec_s * 1e3 / gen,
               "b2_launches": fa.LAUNCHES, "b3_launches": da.LAUNCHES,
               "moe_choices_dropped_in_prefill": int(sum(
                   int(d) for d in drops)),
               "moe_choices_in_prefill": (B * S * cfg.moe.top_k
                                          * sum(bool(sp.moe)
                                                for sp in specs)
                                          if cfg.moe else 0),
               "kv_bytes_allocated": ss.kv_bytes(state)}
        holder = {"state": state, "tok": toks[-1]}

        def one_step():
            holder["state"], lg = decode_step(params, cfg, holder["state"],
                                              token=holder["tok"], eps=0.5,
                                              k_min=16)
            holder["tok"] = lg.argmax(-1)
        row["decode_step_profile"] = profile_split(one_step, n=2)
        state = holder["state"]
        pos = int(state["pos"][0])
        pooled = [(sp, st) for sp, st in zip(specs, state["layers"])
                  if sp.kind in ss.CACHE_KEYS]
        # a range whose patch missed its callee would read 0 ms: each one
        # the served layers run must have been entered
        entries = row["decode_step_profile"]["range_entries"]
        want = {"moe": bool(cfg.moe) and any(sp.moe for sp in specs),
                "mla": any(sp.kind == "mla" for sp in specs),
                "dac_control": bool(budget and pooled)}
        missed = [k for k, on in want.items() if on and not entries[k]]
        if missed:
            raise AssertionError(f"{name} {regime}: the profile's ranges "
                                 f"{missed} recorded no event")
        slot_bytes = [sum(st[k][0, 0].numel() * st[k].element_size()
                          for k in ss.CACHE_KEYS[sp.kind])
                      for sp, st in pooled]
        if budget and pooled:
            ks = torch.stack([st["ctrl"]["k_active"]
                              for _, st in pooled]).cpu().numpy()
            live = torch.stack([st["ctrl"]["length"]
                                for _, st in pooled]).cpu()
            row.update(k_active_min=int(ks.min()),
                       k_active_median=float(np.median(ks)),
                       k_active_max=int(ks.max()),
                       live_slots_per_layer_seq=[int(live.min()),
                                                 int(live.max())],
                       kv_bytes_live=int(sum(
                           int(n) * b for n, b in zip(live.sum(1),
                                                      slot_bytes))))
            win = [(sp.window, st) for sp, st in pooled if sp.window]
            if win:
                row["live_slots_outside_window"] = sum(int(
                    ((~st["ctrl"]["free"])
                     & (st["ctrl"]["slot_pos"] <= pos - w)).sum())
                    for w, st in win)
        else:
            row["kv_bytes_live"] = B * pos * sum(slot_bytes)
            win = [sp.window for sp, _ in pooled if sp.window]
            if win:
                row["cached_positions_outside_window"] = (
                    B * sum(max(0, pos - w + 1) for w in win))
        row["final_pos"] = pos
        res[regime] = row
        del state, logits, holder
        torch.cuda.empty_cache()
    same = seqs["bounded"] == seqs["unbounded"]
    res["greedy_agreement"] = float(same.float().mean())
    if not any(sp.kind in ss.CACHE_KEYS for sp in specs) and not bool(
            same.all()):
        raise AssertionError(f"{name}: no layer holds a KV pool, yet the "
                             f"bounded run's tokens differ")
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t_arch
    return res


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def phase_archs(dev):
    """Phase 13: deepseek-v2-236b, mixtral-8x22b, jamba-1.5-large-398b and
    xlstm-125m served at full width (``ARCH_SERVE``), then the serve path
    with kernels against plain versions in f32 at 2 layers for the MLA and
    the windowed model (``ARCH_VS_PLAIN``)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    t0 = time.perf_counter()
    served = [serve_arch(dev, *row) for row in ARCH_SERVE]
    vs_plain = []
    for name, B, S, steps in ARCH_VS_PLAIN:
        t1 = time.perf_counter()
        cfg = dataclasses.replace(ARCHS[name], n_layers=2,
                                  param_dtype="float32")
        vs_plain.append({"arch": name, "layers": 2, "dtype": "float32",
                         "batch": B, "prompt": S, "steps": steps,
                         "budget": ARCH_BUDGET, "capped_steps": CAP_STEPS,
                         **{regime: serve_vs_plain(dev, cfg, B, S, steps,
                                                   budget, CAP_STEPS, n=2)
                            for regime, budget in (
                                ("unbounded", 0),
                                ("bounded", ARCH_BUDGET))},
                         "s": time.perf_counter() - t1})
    launches = {"b2": sum(r[g]["b2_launches"] for r in served
                          for g in ("unbounded", "bounded")),
                "b3": sum(r[g]["b3_launches"] for r in served
                          for g in ("unbounded", "bounded"))}
    return ({"phase": "archs", "served": served, "serve_vs_plain": vs_plain,
             "s": time.perf_counter() - t0}, launches)


# bounded decode steps with one kv_caps entry a sequence, after phase 7's
# teacher-forced steps
CAP_STEPS = 3


def kv_caps_for(k):
    """Per-sequence caps that deny (``k``), partly grant (``k + k // 2``) or
    fully grant (``2k``) a doubling, in turn over the sequences."""
    import torch
    kinds = torch.arange(k.shape[0], device=k.device) % 3
    return torch.where(kinds == 0, k, torch.where(
        kinds == 1, k + k // 2, 2 * k)).to(torch.int32)


def kv_caps_law(dev, k0=64):
    """tests/test_fleet.py::test_kv_cache_resize_respects_caps at the serve
    shape on the card: pure misses through ``kv_cache.insert`` and
    ``resize(cap=)`` until every sequence's ``jump`` saturates; the capped
    sequence stays at ``k``, the partial grant lands on its cap, the full
    grant doubles; equal to the CPU bit for bit.  (In a decode step a cap
    never binds: the step's hit takes ``jump`` back below ``2k`` before
    the resize check.)"""
    import torch
    from repro_torch.serving import kv_cache as kvc
    out = {}
    for d in ("cpu", dev):
        ctrl = kvc.control_init(SERVE_B, SERVE_BUDGET, k0=k0, device=d)
        caps = kv_caps_for(ctrl["k_active"])
        for pos in range(2 * k0):
            ctrl, _ = kvc.insert(ctrl, torch.full((SERVE_B,), pos,
                                                  dtype=torch.int32,
                                                  device=d))
            ctrl = kvc.resize(ctrl, k_min=16, cap=caps)
        out[d] = ctrl
    tensors_equal(out[dev], out["cpu"], "kv_caps law: card vs CPU")
    k = out["cpu"]["k_active"].tolist()
    want = [(k0, k0 + k0 // 2, 2 * k0)[b % 3] for b in range(SERVE_B)]
    if k != want:
        raise AssertionError(f"kv_caps law: k_active {k}, expected {want}")
    return {"k0": k0, "k_active": k}


# ---------------------------------------------------------------------------
# phases 8-10: the slot policies' graph loop, Table III, the real traces
# ---------------------------------------------------------------------------

SLOT_POLICIES = ("fifo", "lru", "blru", "lfu", "clock", "sieve", "twoq",
                 "arc", "tinylfu", "hyperbolic", "lirs", "lhd")
# the slot phase at 2,000 requests (4,000 until the smoke had to fit a
# slower host than the one it was measured on; PERF.md §4): the least at
# which every L group has lanes that must evict (phase_slot checks it;
# at 1,000 no lane of the L groups holds more distinct keys than its K)
SLOT_T = 2_000
# the eager loop replays the first SLOT_EAGER_T requests only (4 graph
# chunks): it is host bound (0.2-4.2 ms a step, PERF.md §5); the graph
# replays those too.  Within them only the S groups' lanes must evict, as
# at 500 and 250 before (the rows' eager_evicting_lanes)
SLOT_EAGER_T = 128
SLOT_SEEDS = 3
# Table III at T = 3,000, a cut from the reference's 60,000: at 20,000 the
# phase took 299 s of the smoke's 998 s, and a slower host ran the smoke
# past its 1,200; at 10,000 it took 156 s of a smoke of 841 s once phase
# 15 had its CPU world to itself; 5,000 until phase 15 trained too (PERF.md
# §4 records the choices and the measurements).  In the L regime every
# family but twitter has lanes that must evict from T = 3,000 on (not at
# 2,000); twitter's first do at ~8,000, so at 5,000 none did either
TABLE_T = 3_000
TABLE_SEEDS = (0, 1, 2)
# benchmarks/mrr_table.py's row order
TABLE_POLICIES = (
    "dynamicadaptiveclimb", "adaptiveclimb", "sieve", "arc", "tinylfu",
    "twoq", "lirs", "lhd", "lfu", "hyperbolic", "clock", "climb", "lru",
    "blru", "fifo")
RANK_POLICIES = ("dynamicadaptiveclimb", "adaptiveclimb", "climb")


def slot_groups():
    """(regime, K) -> the dataset families of that capacity: one replay
    per (group, policy) takes all their lanes."""
    from repro_torch.data.traces import (DATASET_FAMILIES, family_footprint,
                                         k_for)
    groups = {}
    for regime in ("L", "S"):
        for fam in DATASET_FAMILIES:
            K = k_for(family_footprint(fam), regime)
            groups.setdefault((regime, K), []).append(fam)
    return groups


def slot_inputs(fams, T, seeds):
    """Host ``[len(fams) * seeds, T]`` keys, lognormal sizes and fetch
    costs: the first ``T`` requests of each family's traces."""
    import numpy as np
    from repro_torch.data.traces import (family_batch, family_footprint,
                                         fetch_costs, object_sizes)
    cols = [[], [], []]
    for fam in fams:
        k = family_batch(fam, T, seeds=range(seeds))
        table = object_sizes(family_footprint(fam), seed=1)
        for col, x in zip(cols, (k, table[k], fetch_costs(table)[k])):
            col.append(x)
    return [np.concatenate(c) for c in cols]


def cpu_slot_replay(spec, K, cols):
    """The plain loop on the CPU (a worker process): metrics-only replay,
    returns (totals, final state) as numpy."""
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Request, make_policy, replay_lanes
    pol = make_policy(spec)
    reqs = Request.of(*cols, device="cpu")
    res, st = replay_lanes(pol, reqs, pol.init(K, reqs.key.shape[0], "cpu"),
                           collect_info=False)
    return ([x.numpy() for x in res.metrics],
            {k: v.numpy() for k, v in st.items()})


def equal_runs(a, b, what):
    """Totals and final state of two replays, bit for bit."""
    import numpy as np
    (ma, sa), (mb, sb) = a, b
    for f, x, y in zip(("requests", "hits", "bytes_total", "bytes_missed",
                        "cost_total", "penalty"), ma, mb):
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise Mismatch(f"{what}: {f} differs: {x} vs {y}")
    if set(sa) != set(sb):
        raise Mismatch(f"{what}: state keys {sorted(sa)} vs {sorted(sb)}")
    for k in sa:
        if sa[k].dtype != sb[k].dtype or not np.array_equal(sa[k], sb[k]):
            raise Mismatch(f"{what}: final state {k!r} differs")


def cpu_workers(n=None):
    """A pool of ``n`` spawned worker processes for the plain CPU runs,
    which go on while the card works; by default as many as leave two
    cores with the main process, at most six."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(
        n or max(1, min(6, (os.cpu_count() or 2) - 2)),
        mp_context=multiprocessing.get_context("spawn"))


def slot_replay(spec, K, reqs, chunk, dev):
    """A metrics-only replay of ``spec`` from its initial state at ``chunk``
    steps a CUDA graph (0: the eager loop).  Returns (totals and final
    state as numpy, host seconds, the seconds of graph capture in them)."""
    import torch
    from repro_torch.core import make_policy, replay_lanes
    from repro_torch.core import simulator as sim
    captures, capture = [], sim._capture

    def timed_capture(body):
        t0 = time.perf_counter()
        out = capture(body)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t0)
        return out

    pol = make_policy(spec)
    st = pol.init(K, lanes=reqs.key.shape[0], device=dev)
    sim._capture = timed_capture
    try:
        (res, st), s = host_s(lambda: replay_lanes(
            pol, reqs, st, collect_info=False, chunk=chunk))
    finally:
        sim._capture = capture
    return (([x.cpu().numpy() for x in res.metrics],
             {k: v.cpu().numpy() for k, v in st.items()}),
            s, sum(captures))


def kernels_a_step(pol, K, reqs, dev):
    """Device operations (kernels, copies, fills) a step of ``pol``'s
    eager loop, which the graph loop captures node for node: counted by
    ``torch.profiler`` over 16 and over 48 steps, the difference over 32
    (so the replay's fixed set-up drops out)."""
    from repro_torch.core import Request, replay_lanes
    n = {}
    for T in (16, 48):
        head = Request(*(x[:, :T].contiguous() for x in reqs))
        n[T] = profile_ms(lambda: replay_lanes(
            pol, head, pol.init(K, lanes=head.key.shape[0], device=dev),
            collect_info=False, chunk=0))["kernel_launches"]
    return (n[48] - n[16]) / 32


def evicting_lanes(keys, K):
    """Lanes of ``[lanes, T]`` keys with more distinct keys than ``K``:
    a policy that admits every miss must evict there."""
    import numpy as np
    return int(sum(len(np.unique(row)) > K for row in keys))


def phase_slot(dev):
    """The twelve slot policies on every dataset family (first SLOT_T
    requests, SLOT_SEEDS seeds, both regimes): the graph loop on the card
    gives the same totals and final state bit for bit as the plain loop on
    the CPU (in worker processes, meanwhile) and, over the first
    SLOT_EAGER_T requests, as the eager loop on the card.  Every group
    has lanes that must evict within SLOT_T requests, so the comparison
    covers eviction.  Times the graph and the eager loop and counts the
    device operations a step.  Returns a row per policy and group."""
    from repro_torch.core import Request, make_policy
    from repro_torch.core import simulator as sim

    groups = slot_groups()
    host = {g: slot_inputs(fams, SLOT_T, SLOT_SEEDS)
            for g, fams in groups.items()}
    evict = {g: (evicting_lanes(host[g][0], g[1]),
                 evicting_lanes(host[g][0][:, :SLOT_EAGER_T], g[1]))
             for g in groups}
    if not all(n for n, _ in evict.values()):
        raise AssertionError(f"slot phase: a group has no lane that must "
                             f"evict within {SLOT_T} requests: {evict}")
    jobs = sorted(((spec, g) for g in groups for spec in SLOT_POLICIES),
                  key=lambda j: SLOT_POLICIES.index(j[0]), reverse=True)
    rows = []
    with cpu_workers() as pool:
        cpu = {j: pool.submit(cpu_slot_replay, j[0], j[1][1], host[j[1]])
               for j in jobs}
        for g, fams in groups.items():
            regime, K = g
            reqs = Request.of(*host[g], device=dev)
            head = Request(*(x[:, :SLOT_EAGER_T].contiguous() for x in reqs))
            B = reqs.key.shape[0]
            for spec in SLOT_POLICIES:
                graph, g_s, cap_s = slot_replay(spec, K, reqs,
                                                sim.GRAPH_CHUNK, dev)
                graph_head, _, _ = slot_replay(spec, K, head,
                                               sim.GRAPH_CHUNK, dev)
                eager, e_s, _ = slot_replay(spec, K, head, 0, dev)
                equal_runs(graph_head, eager, f"{spec} {g}: graph vs eager")
                row = {"policy": spec, "regime": regime, "K": K,
                       "lanes": B, "T": SLOT_T, "eager_T": SLOT_EAGER_T,
                       "chunk": sim.GRAPH_CHUNK,
                       "evicting_lanes": evict[g][0],
                       "eager_evicting_lanes": evict[g][1],
                       "graph_us_per_step": (g_s - cap_s) * 1e6 / SLOT_T,
                       "graph_capture_s": cap_s, "graph_s": g_s,
                       "eager_us_per_step": e_s * 1e6 / SLOT_EAGER_T,
                       "miss_ratio": float(
                           1 - graph[0][1].sum() / graph[0][0].sum())}
                if g == next(iter(groups)):
                    row["device_ops_per_step"] = kernels_a_step(
                        make_policy(spec), K, reqs, dev)
                rows.append(row)
                equal_runs(graph, cpu[spec, g].result(),
                           f"{spec} {g}: graph vs cpu")
    return rows


def cpu_rank_records(sweep, scenario, T=None):
    """The rank-policy cells of one scenario of Table III (``sweep`` =
    "table", at ``T``) or of the corpus sweep ("corpus") through
    ``run_sweep`` on the CPU, where B1's wrapper runs its plain version (a
    worker process): the records without ``wall_s``."""
    import dataclasses

    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bench import run_sweep
    from repro_torch.core import Engine
    sw = table_sweep(T) if sweep == "table" else corpus_sweep()
    sw = dataclasses.replace(
        sw, policies=tuple(p for p in sw.policies if p in RANK_POLICIES),
        scenarios=tuple(sc for sc in sw.scenarios if sc.name == scenario))
    res = run_sweep(sw, engine=Engine(device="cpu"), stream=False)
    return [no_wall(r) for r in res.records]


def no_wall(rec):
    return {k: v for k, v in rec.items() if k != "wall_s"}


def rank_cells_vs_cpu(records, cpu, what):
    """Every rank-policy record of the card's sweep equals the plain
    version's record from the CPU (futures of ``cpu_rank_records``), bit
    for bit; returns how many were compared."""
    want = {(r["policy"], r["scenario"], r["K"]): r
            for f in cpu for r in f.result()}
    got = [no_wall(r) for r in records if r["policy"] in RANK_POLICIES]
    if len(got) != len(want):
        raise Mismatch(f"{what}: {len(got)} rank cells on the card, "
                       f"{len(want)} on the CPU")
    for r in got:
        w = want.get((r["policy"], r["scenario"], r["K"]))
        if r != w:
            raise Mismatch(f"{what} {r['scenario']} {r['policy']} "
                           f"K={r['K']}: card {r['metrics']} vs plain on "
                           f"the CPU {w and w['metrics']}")
    return len(got)


def table_sweep(T):
    from repro_torch.bench import Scenario, Sweep
    from repro_torch.data.traces import DATASET_FAMILIES
    return Sweep("mrr_table", policies=TABLE_POLICIES,
                 scenarios=tuple(Scenario(ds, trace=ds, T=T, K=("L", "S"))
                                 for ds in DATASET_FAMILIES),
                 seeds=TABLE_SEEDS)


def phase_table(dev, T=TABLE_T):
    """Table III through the port's normal entry points: the mrr_table
    grid (15 policies x 6 families x {L, S} x 3 seeds) through
    ``run_sweep`` on the card, one B1 launch per rank-policy cell, each
    rank cell's record equal to the plain version's on the CPU (worker
    processes, meanwhile); the payload validated and written to
    chiprun_out/; the MRR matrix and the winners.  Returns (summary, B1
    launches)."""
    import math

    import torch
    from repro_torch.bench import report, results, run_sweep
    from repro_torch.core import Engine
    from repro_torch.kernels import policy_step as ps

    sw = table_sweep(T)
    with cpu_workers() as pool:
        cpu = [pool.submit(cpu_rank_records, "table", sc.name, T)
               for sc in sw.scenarios]
        torch.cuda.synchronize()
        ps.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run_sweep(sw, engine=Engine(device=dev))
        seconds = time.perf_counter() - t0
        launches = ps.LAUNCHES
        vs_cpu = rank_cells_vs_cpu(res.records, cpu, "Table III")
    rank_cells = sum(1 for pol, *_ in sw.cells() if pol in RANK_POLICIES)
    if launches != rank_cells:
        raise AssertionError(
            f"Table III: policy_replay launched {launches} times; expected "
            f"one per rank-policy cell ({rank_cells})")
    if len(res.records) != len(list(sw.cells())):
        raise AssertionError("Table III: a cell has no record")
    for rec in res.records:
        for name, vals in rec["metrics"].items():
            if len(vals) != len(TABLE_SEEDS) or not all(
                    math.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
                raise AssertionError(f"Table III: {rec['policy']} "
                                     f"{rec['scenario']} {name}: {vals}")
    table = report.mrr_matrix(res.records, TABLE_POLICIES, baseline="fifo")
    wins = report.winners(res.records, TABLE_POLICIES)
    if any(col["fifo"] != 0.0 for col in table.values()):
        raise AssertionError("Table III: FIFO's MRR against itself is not 0")
    payload = res.payload(extras={"table": table, "winners": wins})
    results.validate(payload)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    results.save(payload, results_dir=str(ROOT / "chiprun_out"))
    cell_s = {}
    for rec in res.records:
        cell_s[rec["policy"]] = cell_s.get(rec["policy"], 0.0) + rec["wall_s"]
    return ({"phase": "table3", "T": T, "seeds": list(TABLE_SEEDS),
             "cells": len(res.records), "s": seconds,
             "policy_replay": launches, "rank_cells_equal_cpu": vs_cpu,
             "policy_s": cell_s,
             "mrr": table, "winners": wins}, launches)


def corpus_sweep():
    from repro_torch.bench import Scenario, Sweep
    from repro_torch.data.ingest import characterize, detect_format
    corpus = ROOT / "benchmarks" / "corpus"
    scenarios = []
    for path in sorted(corpus.iterdir()):
        try:
            detect_format(str(path))
        except ValueError:
            continue
        # the .bin/.bin.gz pair holds the same trace: keep the gzipped one
        if path.name.endswith(".oracleGeneral.bin") and \
                path.with_name(path.name + ".gz").exists():
            continue
        scenarios.append(Scenario(
            path.name.split(".")[0], trace=f"file(path={path})",
            T=characterize(str(path)).n_requests, K=("S", "L")))
    return Sweep("real_traces", policies=(
        "fifo", "lru", "arc", "adaptiveclimb", "dynamicadaptiveclimb"),
        scenarios=tuple(scenarios), seeds=(0,), observe=True)


def phase_corpus(dev):
    """benchmarks/real_traces.py's grid over the committed corpus through
    ``run_sweep`` streamed and materialized on the card: identical
    records, and each rank cell's equal to the plain version's on the CPU
    (worker processes).  Returns (summary, B1 launches)."""
    from repro_torch.bench import run_sweep
    from repro_torch.core import Engine
    from repro_torch.kernels import policy_step as ps

    sw = corpus_sweep()
    with cpu_workers() as pool:
        cpu = [pool.submit(cpu_rank_records, "corpus", sc.name)
               for sc in sw.scenarios]
        ps.LAUNCHES = 0
        streamed = run_sweep(sw, engine=Engine(device=dev), stream=True)
        launches = ps.LAUNCHES
        ps.LAUNCHES = 0
        whole = run_sweep(sw, engine=Engine(device=dev), stream=False)
        launches += ps.LAUNCHES
        vs_cpu = rank_cells_vs_cpu(whole.records, cpu, "corpus")
    rows = []
    for a, b in zip(streamed.records, whole.records):
        if no_wall(a) != no_wall(b):
            raise Mismatch(f"corpus {a['scenario']} {a['policy']} "
                           f"K={a['K']}: streamed {a['metrics']} vs "
                           f"materialized {b['metrics']}")
        rows.append({"scenario": a["scenario"], "policy": a["policy"],
                     "K": a["K"], **{k: v[0] for k, v in
                                     a["metrics"].items()}})
    return ({"phase": "real_traces", "cells": len(rows),
             "policy_replay": launches, "rank_cells_equal_cpu": vs_cpu,
             "rows": rows}, launches)


# ---------------------------------------------------------------------------
# phase 11: the tier, the fleet and admission (B1's budgeted plan and rank
# bases one request a launch, inside the CUDA graph loop)
# ---------------------------------------------------------------------------

# benchmarks/tenant_sweep.py's grid at T = 6,000 (its own T is 60,000: cut
# to keep the smoke inside its time, 10,000 until phase 15 trained too;
# PERF.md §4)
TIER_T = 6_000
# benchmarks/fleet_sweep.py's grid at a quarter of the reference's
# committed run (experiments/bench/BENCH_fleet.json, T = 16,000; 8,000 until
# phase 15 trained too)
FLEET_T = 4_000
# benchmarks/robustness.py's grid (N = 4,096) for the admission policies
# and their bases, at T = 5,000 (its own T is 40,000; 10,000 until phase
# 15 came, PERF.md §4)
ADMIT_T = 5_000
MULTI_SEEDS = (0, 1, 2)
ADMIT_SEEDS = (0, 1)
MULTI_EAGER_T = 1_000
TIER_DAC = "dac(k_min=16)"
TIER_ENTRIES = ((TIER_DAC, "greedy"), (TIER_DAC, "proportional"),
                (TIER_DAC, "static"), ("lru", "static"), ("climb", "static"),
                ("adaptiveclimb", "static"), ("fifo", "static"))
FLEET_ENTRIES = ((TIER_DAC, "auction"), (TIER_DAC, "greedy"),
                 (TIER_DAC, "proportional"), (TIER_DAC, "static"),
                 ("lru", "static"), ("fifo", "static"))
ADMIT_POLICIES = ("lru", "dac", "admit(lru)", "admit(dac)")


def tier_sweep(T=None):
    T = T or TIER_T
    from repro_torch.bench import TierScenario, TierSweep

    def trace(n, duty):
        return (f"tenants(N=256,n_tenants={n},alpha=0.5,period=6000,"
                f"duty={duty},lo=16,alpha_lo=1.6)")

    size = "lognormal(median_kb=16,sigma=1.5)"
    return TierSweep("tenant_sweep", entries=TIER_ENTRIES, scenarios=(
        TierScenario("flux", trace=trace(4, 0.25), T=T, budget=(320,),
                     size_model=size),
        TierScenario("contended", trace=trace(8, 0.5), T=T, budget=(512,),
                     size_model=size)), seeds=MULTI_SEEDS)


def fleet_sweep(T=None):
    T = T or FLEET_T
    from repro_torch.bench import FleetScenario, FleetSweep

    def trace(n, rate, session):
        return (f"fleet(N=256,n_lanes={n},rate={rate},mean_session="
                f"{session},alpha=0.5,period=6000,duty=0.25,lo=16,"
                "alpha_lo=1.6)")

    models = dict(size_model="lognormal(median_kb=16,sigma=1.5)",
                  cost_model="fetch(base_ms=2.0,per_mb_ms=8.0)")
    return FleetSweep("fleet_sweep", entries=FLEET_ENTRIES, scenarios=(
        FleetScenario("pool", trace=trace(12, 0.002, 3000), T=T,
                      budget=(384,), **models),
        FleetScenario("churn", trace=trace(8, 0.02, 300), T=T,
                      budget=(256,), **models)), seeds=MULTI_SEEDS)


def admit_sweep(T=None, N=4096):
    T = T or ADMIT_T
    from repro_torch.bench import Scenario, Sweep
    bimodal = f"bimodal(split={N},small_kb=4,large_kb=64)"
    lognormal = "lognormal(median_kb=16,sigma=1.5)"
    grid = (("flood", f"flood(N={N},alpha=0.9,flood_frac=0.35,burst_len=128,"
             "phases=4)", bimodal),
            ("scanstorm", f"scanstorm(N={N},alpha=0.9,mean_phase=2000,"
             "drift=0.1,storm_frac=0.25,scan_len=256)", bimodal),
            ("diurnal", f"diurnal(N={N},period={N},lo=64)", lognormal),
            ("thrash", f"thrash(N={N},loop={N // 4})", lognormal))
    return Sweep("robustness", policies=ADMIT_POLICIES, scenarios=tuple(
        Scenario(name, trace=tr, T=T, K=("S", "L"), size_model=size,
                 cost_model="fetch") for name, tr, size in grid),
        seeds=ADMIT_SEEDS)


def multi_sweeps():
    return {"tier": tier_sweep(), "fleet": fleet_sweep(),
            "admission": admit_sweep()}


def multi_jobs(kind, sw):
    """The (scenario, entry) pieces one CPU worker runs for a sweep."""
    if kind == "admission":
        return [(sc.name, pol) for sc in sw.scenarios for pol in sw.policies]
    return [(sc.name, e) for sc in sw.scenarios for e in sw.entries]


def cpu_multi_records(kind, scenario, entry):
    """One scenario x entry of phase 11's sweeps through the port's runner
    on the CPU (a worker process): the records without ``wall_s``."""
    import dataclasses

    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bench import run_fleet_sweep, run_sweep, run_tier_sweep
    from repro_torch.core import Engine
    sw = multi_sweeps()[kind]
    scs = tuple(sc for sc in sw.scenarios if sc.name == scenario)
    eng = Engine(device="cpu")
    if kind == "admission":
        res = run_sweep(dataclasses.replace(sw, policies=(entry,),
                                            scenarios=scs),
                        engine=eng, stream=False)
    else:
        run = run_tier_sweep if kind == "tier" else run_fleet_sweep
        res = run(dataclasses.replace(sw, entries=(entry,), scenarios=scs),
                  engine=eng)
    return [no_wall(r) for r in res.records]


def record_key(kind, rec):
    if kind == "admission":
        return (rec["scenario"], rec["policy"], rec["K"])
    return (rec["scenario"], rec["policy"], rec["arbiter"], rec["budget"])


def graph_launches(T, chunk):
    """B1 launches the CUDA graph loop counts for a replay of T steps that
    launches B1 once a step: LAUNCHES counts a captured launch once, at
    capture.  One warm-up step before the capture, ``chunk`` steps
    captured, the ``T % chunk`` eager tail; under ``chunk`` steps the
    whole replay is eager."""
    return T if T < chunk else 1 + chunk + T % chunk


def expected_launches(kind, sw, chunk):
    """B1 launches a sweep of phase 11 should count, cell by cell: a rank
    policy (or a tier or fleet of one) steps B1 once a step in the graph
    loop; a bare rank policy's ``run_sweep`` cell is one whole-trace
    launch; slot policies and admission over one launch nothing."""
    from repro_torch.core import RankPolicy, make_policy
    from repro_torch.core.admission import AdmissionPolicy
    n = 0
    for cell in sw.cells():
        pol = make_policy(cell[0])
        if kind == "admission":
            T = cell[1].T
            if isinstance(pol, RankPolicy):
                n += 1
            elif isinstance(pol, AdmissionPolicy) and \
                    isinstance(pol.base, RankPolicy):
                n += graph_launches(T, chunk)
        elif isinstance(pol, RankPolicy):
            n += graph_launches(cell[2].T, chunk)
    return n


def tensors_equal(a, b, what):
    """Two results or states (nested dicts and tuples of tensors) equal
    bit for bit."""
    import torch
    if isinstance(a, dict):
        if set(a) != set(b):
            raise Mismatch(f"{what}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            tensors_equal(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, tuple):
        fields = getattr(a, "_fields", range(len(a)))
        for f, x, y in zip(fields, a, b):
            tensors_equal(x, y, f"{what}.{f}")
    elif a is None or b is None:
        if a is not b:
            raise Mismatch(f"{what}: one side is None")
    elif a.dtype != b.dtype or a.shape != b.shape or \
            not torch.equal(a.cpu(), b.cpu()):
        raise Mismatch(f"{what}: differs")


def ops_a_step(make_run):
    """Device operations a step of an eager replay (``make_run(T)`` runs
    ``T`` steps with ``chunk=0``), which the graph loop captures node for
    node: ``torch.profiler`` over 16 and 48 steps, the difference over
    32."""
    n = {T: profile_ms(make_run(T))["kernel_launches"] for T in (16, 48)}
    return (n[48] - n[16]) / 32


def multi_graph_vs_eager(dev):
    """On one cell of each kind, the graph loop equals the eager loop on
    the card over MULTI_EAGER_T steps (results, obs and final state); and
    each kind's device operations a step."""
    import functools

    import torch
    from repro_torch.bench import materialize
    from repro_torch.core import Request, make_policy, replay_lanes
    from repro_torch.fleet import FleetTier, replay_fleet
    from repro_torch.tier import CacheTier, replay_tier
    out = {}
    sws = multi_sweeps()
    for kind, make in (("tier", lambda sc: CacheTier(
            TIER_DAC, n_tenants=sc.n_tenants, budget=sc.budgets()[0],
            arbiter="greedy")), ("fleet", lambda sc: FleetTier(
            TIER_DAC, n_lanes=sc.n_lanes, budget=sc.budgets()[0],
            arbiter="auction", util_decay=sc.util_decay))):
        sc = sws[kind].scenarios[-1]           # contended / churn
        reqs = materialize(sc, MULTI_SEEDS, dev)
        head = Request(*(x[:, :MULTI_EAGER_T].contiguous() for x in reqs))
        rep = functools.partial(
            replay_tier if kind == "tier" else replay_fleet, device=dev)
        tier = make(sc)
        graph = rep(tier, head, observe=True)
        eager = rep(tier, head, observe=True, chunk=0)
        tensors_equal(graph, eager, f"{kind} {sc.name}: graph vs eager")
        out[kind] = {"cell": f"{sc.name} {tier.policy.name}+"
                             f"{tier.arbiter.name}",
                     "device_ops_per_step": ops_a_step(
                         lambda T: lambda: rep(tier, Request(
                             *(x[:, :T].contiguous() for x in reqs)),
                             chunk=0))}
    sc = next(s for s in sws["admission"].scenarios if s.name == "flood")
    K = max(sc.capacities())
    reqs = materialize(sc, ADMIT_SEEDS, dev)
    head = Request(*(x[:, :MULTI_EAGER_T].contiguous() for x in reqs))
    pol = make_policy("admit(dac)")
    runs = [replay_lanes(pol, head, pol.init(K, len(ADMIT_SEEDS), dev),
                         collect_info=False, chunk=c)
            for c in (None, 0)]
    tensors_equal(runs[0], runs[1], "admission flood(L): graph vs eager")
    out["admission"] = {"cell": f"flood K={K} admit(dac)",
                        "device_ops_per_step": ops_a_step(
                            lambda T: lambda: replay_lanes(
                                pol, Request(*(x[:, :T].contiguous()
                                               for x in reqs)),
                                pol.init(K, len(ADMIT_SEEDS), dev),
                                collect_info=False, chunk=0))}
    torch.cuda.synchronize()
    return out


def admission_revert(dev, T=400):
    """``admit(dac)`` stepped eagerly on the card over the flood trace at
    the small capacity: every step leaves its input state unwritten (the
    gate keeps the old base state to revert to; B1's wrapper copies the
    row it is given) and equals the same step on the CPU, state and info;
    the gate rejects misses (so reverts run: counted on the CPU against
    the bare base's step)."""
    import torch
    from repro_torch.bench import materialize
    from repro_torch.core import Request, make_policy
    from repro_torch.core.simulator import _tree_map
    sc = next(s for s in admit_sweep().scenarios if s.name == "flood")
    K = min(sc.capacities())
    pol = make_policy("admit(dac)")
    reqs = materialize(sc, ADMIT_SEEDS, "cpu")
    st = {d: pol.init(K, len(ADMIT_SEEDS), d) for d in ("cpu", dev)}
    rejected = 0
    for t in range(T):
        step, prev = {}, {}
        req = Request(*(x[:, t] for x in reqs))
        for d in ("cpu", dev):
            prev[d] = _tree_map(torch.clone, st[d])
            new, info = pol.step(st[d], Request(*(x.to(d) for x in req)))
            tensors_equal(st[d], prev[d], f"revert step {t} on {d}: input")
            st[d], step[d] = new, info
        tensors_equal(st[dev], st["cpu"], f"revert step {t}: state")
        tensors_equal(step[dev], step["cpu"], f"revert step {t}: info")
        # a rejected miss: the base step evicted a key, the gate kept it
        _, base = pol.base.step(prev["cpu"]["base"], req)
        rejected += int((~base.hit & (base.evicted_key != -1)
                         & (step["cpu"].evicted_key == -1)).sum())
    if not rejected:
        raise AssertionError("admission: the gate rejected no miss")
    return {"steps": T, "K": K, "lanes": len(ADMIT_SEEDS),
            "misses_kept_out": rejected}


def dac_resize_on_card(dev):
    """tests/test_dac_resize.py's laws through B1 on the card: replays of
    alternating thrash / concentrate segments with ``observe=True`` (one
    launch each) keep ``k`` in [k_min, K * growth], move it by exact
    doubling or halving, keep ``jump`` in [-(k // 2), 2k] and ranks past
    ``k`` EMPTY, grow and shrink; a k_min floor holds; and every replay
    equals the CPU's (B1's plain version) bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import Request, make_policy, replay_lanes

    def mixed(seed, T):
        rng = np.random.default_rng(seed)
        segs = []
        while sum(len(s) for s in segs) < T:
            wide = rng.random() < 0.5
            segs.append(rng.integers(0, 400 if wide else 3, 150))
        return np.concatenate(segs)[:T].astype(np.int32)

    cases = [(8, 0.5, 4, 2), (16, 0.25, 2, 2), (16, 1.0, 8, 4),
             (32, 0.5, 1, 2), (16, 0.5, 4, 2)]
    rows = []
    for K, eps, growth, k_min in cases:
        spec = f"dac(eps={eps},growth={growth},k_min={k_min})"
        keys = np.stack([mixed(s, 6000) for s in (0, 1, 2)])
        pol = make_policy(spec)
        runs = {}
        for d in ("cpu", dev):
            res, st = replay_lanes(pol, Request.of(keys, device=d),
                                   pol.init(K, 3, d), observe=True,
                                   collect_info=False)
            runs[d] = (res, st)
        tensors_equal(runs[dev], runs["cpu"], f"dac resize {spec}")
        res, st = runs["cpu"]
        ks, jumps = res.obs["k"].numpy(), res.obs["jump"].numpy()
        ratio = ks[:, 1:] / ks[:, :-1]
        ok = (ks.min() >= k_min and ks.max() <= K * growth
              and set(np.unique(ratio)) <= {0.5, 1.0, 2.0}
              and (jumps <= 2 * ks).all() and (jumps >= -(ks // 2)).all()
              and (ratio < 1).any() and (growth == 1 or (ratio > 1).any()))
        r = torch.arange(st["cache"].shape[1])[None]
        if not ok or not (st["cache"][r >= st["k"][:, None]] == -1).all():
            raise AssertionError(f"dac resize {spec}: invariants broken")
        rows.append({"spec": spec, "K": K, "k_min_seen": int(ks.min()),
                     "k_max_seen": int(ks.max()),
                     "grows": int((ratio > 1).sum()),
                     "shrinks": int((ratio < 1).sum())})
    floor = make_policy("dac(eps=1.0,growth=2,k_min=8)")
    keys = np.tile(np.arange(2, dtype=np.int32), 500)[None]
    res, _ = replay_lanes(floor, Request.of(keys, device=dev),
                          floor.init(16, 1, dev), observe=True,
                          collect_info=False)
    ks = res.obs["k"].cpu().numpy()
    if ks.min() < 8 or ks[0, -1] != 8:
        raise AssertionError(f"dac k_min floor: k went to {ks.min()}")
    return rows


def phase_multi(dev):
    """The tier, the fleet and admission through the port's entry points on
    the card: tenant_sweep's grid through ``run_tier_sweep``, fleet_sweep's
    through ``run_fleet_sweep`` and the admission cells of robustness's
    through ``run_sweep``, B1's launches counted against their formula and
    each record equal to the same runner's on the CPU (worker processes,
    meanwhile); graph against eager on one cell of each kind, the
    admission gate's revert step by step, and DAC's resize laws through
    B1.  Returns (summary, B1 launches of the three sweeps)."""
    import torch
    from repro_torch.bench import results, run_fleet_sweep, run_sweep, \
        run_tier_sweep
    from repro_torch.core import Engine
    from repro_torch.core import simulator as sim
    from repro_torch.kernels import policy_step as ps

    t_phase = time.perf_counter()
    sws = multi_sweeps()
    runners = {"tier": run_tier_sweep, "fleet": run_fleet_sweep,
               "admission": lambda sw, engine: run_sweep(
                   sw, engine=engine, stream=False)}
    out, launches = {}, 0
    with cpu_workers() as pool:
        # the admission cells are the CPU's longest: queued first
        cpu = {(kind, sc, e): pool.submit(cpu_multi_records, kind, sc, e)
               for kind in ("admission", "fleet", "tier")
               for sc, e in multi_jobs(kind, sws[kind])}
        for kind, sw in sws.items():
            torch.cuda.synchronize()
            ps.LAUNCHES = 0
            t0 = time.perf_counter()
            res = runners[kind](sw, engine=Engine(device=dev))
            seconds = time.perf_counter() - t0
            n = ps.LAUNCHES
            want = expected_launches(kind, sw, sim.GRAPH_CHUNK)
            if n != want:
                raise AssertionError(f"{kind}: B1 launched {n} times, the "
                                     f"formula gives {want}")
            launches += n
            results.validate(res.payload())
            T = sw.scenarios[0].T
            steps = sum(r["wall_s"] for r in res.records)
            by_entry = {}
            for r in res.records:
                e = r["policy"] + (f"+{r['arbiter']}" if "arbiter" in r
                                   else "")
                by_entry.setdefault(e, []).append(r["wall_s"] * 1e6 / T)
            out[kind] = {"cells": len(res.records), "T": T, "s": seconds,
                         "policy_replay": n,
                         "policy_replay_per_graph_replay": graph_launches(
                             T, sim.GRAPH_CHUNK),
                         "us_per_step": steps * 1e6 / (len(res.records) * T),
                         "us_per_step_by_entry": {
                             e: sum(v) / len(v) for e, v in by_entry.items()},
                         "byte_miss": {
                             " ".join(str(x) for x in record_key(kind, r)):
                             r["metrics"]["byte_miss_ratio"]
                             for r in res.records}}
            out[kind]["_records"] = res.records
        # the checks run on the card while the workers finish
        t0 = time.perf_counter()
        ge = multi_graph_vs_eager(dev)
        for kind, row in ge.items():
            out[kind].update(graph_eager_cell=row["cell"],
                             graph_eager_T=MULTI_EAGER_T,
                             device_ops_per_step=row["device_ops_per_step"])
        revert = admission_revert(dev)
        resize = dac_resize_on_card(dev)
        checks_s = time.perf_counter() - t0
        for kind, sw in sws.items():
            want = {}
            for sc, e in multi_jobs(kind, sw):
                for r in cpu[kind, sc, e].result():
                    want[record_key(kind, r)] = r
            got = out[kind].pop("_records")
            if len(got) != len(want):
                raise Mismatch(f"{kind}: {len(got)} cells on the card, "
                               f"{len(want)} on the CPU")
            for r in got:
                w = want.get(record_key(kind, r))
                if no_wall(r) != w:
                    raise Mismatch(f"{kind} {record_key(kind, r)}: card "
                                   f"{r['metrics']} vs the CPU "
                                   f"{w and w['metrics']}")
            out[kind]["cells_equal_cpu"] = len(got)
    return ({"phase": "tier_fleet_admission",
             "cut": f"tier T {TIER_T} (tenant_sweep's 60,000); fleet T "
                    f"{FLEET_T} (BENCH_fleet's 16,000); admission "
                    f"T {ADMIT_T} (robustness's 40,000), its policies "
                    f"{list(ADMIT_POLICIES)} only",
             "chunk": sim.GRAPH_CHUNK,
             "launch_formula": "rank cell of run_sweep: 1; graph loop: "
                               "1 warm-up + chunk captured + T % chunk "
                               "eager tail",
             **out, "checks_s": checks_s,
             "admission_revert": revert, "dac_resize": resize,
             "s": time.perf_counter() - t_phase}, launches)


# ---------------------------------------------------------------------------
# phase 12: a six-dataset campaign through repro_torch.campaign
# ---------------------------------------------------------------------------

# the corpus: one dataset per DATASET_FAMILIES entry, a trace per seed, each
# CAMPAIGN_TRACE_T requests long (7.2 MB an oracleGeneral file; 1,000,000
# until the smoke had to fit a slower host, 500,000 until phase 15 served
# on 16 ranks, PERF.md §4), so that a whole-trace cell still streams
# through two of ingest's 2^18-request chunks
CAMPAIGN_TRACE_T = 300_000
CAMPAIGN_TRACE_SEEDS = (0, 1)
# the one trace written as a gzipped CSV with costs; the rest are
# uncompressed oracleGeneral files with sizes
CAMPAIGN_CSV = ("metakv", 0)
# the planted bad trace: 10 bytes, not a whole 24-byte oracleGeneral record
CAMPAIGN_PLANTED = "bad.oracleGeneral.bin"
# campaign A: all four policies at T = 5,000, a cut (FIFO and LRU step
# through the graph loop at 31-43 us a request, so a whole-trace slot cell
# would take some 35 s; at 40,000 the phase took 274 s, at 20,000 the
# smoke ended at 990 s of its 1,200, and at 10,000 a slow host ran the
# smoke to 953 s; PERF.md §4)
CAMPAIGN_A_POLICIES = ("fifo", "lru", "ac", "dac")
CAMPAIGN_A_T = 5_000
# campaign B: the rank policies on the whole trace, nothing cut
CAMPAIGN_B_POLICIES = ("climb", "ac", "dac")
# campaign B's inline crash and resume runs over two datasets' 24 cells,
# a cut: the spawned run already replays all 72, and the resume's law
# (each cell done once, the stores' files equal) does not depend on which
# cells (all 72 took 70.9 s; PERF.md §4)
CAMPAIGN_RESUME_DATASETS = ("alibaba", "wiki")
CAMPAIGN_CRASH_AFTER = 9
# campaign B's cells held against the Python oracle: dac and ac at L on
# the first trace of each dataset
CAMPAIGN_ORACLE = (("dac", "L"), ("ac", "L"))
# campaign B's spawned workers on the card
CAMPAIGN_POOL_WORKERS = 2


def write_campaign_trace(root, family, seed, T):
    """One corpus trace from the port's generator: ``family``'s keys for
    ``seed``, a size per object drawn in [1, 256) as
    ``tools/make_corpus.py`` draws them, and (for the CSV) costs from
    ``traces.fetch_costs``.  Returns the file's path."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import ingest, traces
    keys = traces.family_trace(family, T, seed=seed)
    fam = sorted(traces.DATASET_FAMILIES).index(family)
    table = np.random.default_rng(1000 * fam + seed).integers(
        1, 256, int(keys.max()) + 1)
    sizes = table[keys]
    d = Path(root) / family
    d.mkdir(exist_ok=True)
    if (family, seed) == CAMPAIGN_CSV:
        path = d / f"{family}-{seed}.csv.gz"
        ingest.write_csv(str(path), keys, sizes, traces.fetch_costs(sizes))
    else:
        path = d / f"{family}-{seed}.oracleGeneral.bin"
        ingest.write_oracle_general(str(path), keys, sizes)
    return str(path)


def oracle_cell(path, policy, regime):
    """The record of a whole-trace campaign cell reckoned without the
    port's replay: the Python oracle (the reference's, as the port copies
    it) steps through the trace as ingest reads it, and the totals are
    summed as ``Engine.replay_stream`` sums them (float32 in request order
    within each ``ingest.DEFAULT_CHUNK`` chunk, the chunks in float64).
    Returns ``(K, metrics)``."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.bench.scenario import k_for
    from repro_torch.core import ALIASES, oracle
    from repro_torch.data import ingest
    tr = ingest.load_trace(path)
    T = len(tr.keys)
    K = k_for(tr.n_objects, regime)
    orc = oracle.ORACLES[ALIASES.get(policy, policy)](K)
    hits = np.empty(T, dtype=bool)
    k_sum = 0
    track_k = hasattr(orc, "k")
    for t, key in enumerate(tr.keys.tolist()):
        hits[t] = orc.step(key)
        if track_k:
            k_sum += orc.k
    sizes = (np.ones(T) if tr.sizes is None else tr.sizes).astype(np.float32)
    costs = (np.ones(T) if tr.costs is None else tr.costs).astype(np.float32)
    totals = np.zeros(4, np.float64)
    for lo in range(0, T, ingest.DEFAULT_CHUNK):
        part = slice(lo, lo + ingest.DEFAULT_CHUNK)
        miss = ~hits[part]
        totals += [np.cumsum(x, dtype=np.float32)[-1] for x in (
            sizes[part], np.where(miss, sizes[part], np.float32(0)),
            costs[part], np.where(miss, costs[part], np.float32(0)))]
    n_hits = float(hits.sum())
    metrics = {"miss_ratio": [(T - n_hits) / T], "hit_ratio": [n_hits / T],
               "byte_miss_ratio": [float(totals[1] / totals[0])],
               "penalty_ratio": [float(totals[3] / totals[2])]}
    if track_k:
        metrics["avg_k"] = [float(k_sum) / T]
    return K, metrics


def campaign_corpus(root, pool):
    """Write the corpus (in ``pool``'s workers).  Returns the seconds it
    took."""
    from repro_torch.data.traces import DATASET_FAMILIES
    t0 = time.perf_counter()
    paths = [pool.submit(write_campaign_trace, root, fam, seed,
                         CAMPAIGN_TRACE_T)
             for fam in DATASET_FAMILIES for seed in CAMPAIGN_TRACE_SEEDS]
    for f in paths:
        f.result()
    return time.perf_counter() - t0


def campaign_manifests(root):
    """Campaign B (the six datasets, whole traces) from a scan of the
    corpus with frozen stats, and campaign A (T cut) over the same
    datasets and the planted bad file (10 bytes of oracleGeneral, not a
    whole 24-byte record, in a dataset of its own with no stats)."""
    import dataclasses

    from repro_torch.campaign import Dataset, Grid, scan_corpus
    b = scan_corpus(root, name="smoke-b", grid=Grid(
        policies=CAMPAIGN_B_POLICIES, K=("S", "L"), seeds=(0,)))
    (Path(root) / CAMPAIGN_PLANTED).write_bytes(b"\x00" * 10)
    a = dataclasses.replace(
        b, name="smoke-a",
        datasets=b.datasets + (Dataset(
            name="planted", traces=((CAMPAIGN_PLANTED, "auto"),)),),
        grid=Grid(policies=CAMPAIGN_A_POLICIES, K=("S", "L"), seeds=(0,),
                  T=CAMPAIGN_A_T))
    return a, b


class CellTimer:
    """Seconds of each inline cell's replay (``run_sweep``'s own record
    time: the stream off disk and the replay, ending after the device's
    results reach the host) and store write (``CampaignStore.put``), by
    key, from wrappers around the two in the main process."""

    def __init__(self):
        self.replay, self.write = {}, {}

    def __enter__(self):
        from repro_torch.campaign import executor, store
        self._saved = executor.run_sweep, store.CampaignStore.put
        run_sweep, put = self._saved

        def timed_sweep(sweep, **kw):
            res = run_sweep(sweep, **kw)
            self.replay[sweep.name.removeprefix("cell-")] = \
                res.records[0]["wall_s"]
            return res

        def timed_put(st, key, payload):
            t0 = time.perf_counter()
            out = put(st, key, payload)
            self.write[key] = time.perf_counter() - t0
            return out

        executor.run_sweep, store.CampaignStore.put = timed_sweep, timed_put
        return self

    def __exit__(self, *exc):
        from repro_torch.campaign import executor, store
        executor.run_sweep, store.CampaignStore.put = self._saved

    def split(self, store, manifest):
        """Mean seconds a cell by policy: ingest and characterise (the
        rest of the cell), replay, store write; cells that ran twice would
        be counted twice (none do, which the phase checks)."""
        from repro_torch.campaign import cell_key, plan_cells
        policy = {cell_key(c): c.policy for c in plan_cells(manifest)}
        rows = {}
        for ev in journal(store):
            if ev["event"] != "done":
                continue
            key = ev["key"]
            replay, write = self.replay[key], self.write[key]
            row = rows.setdefault(policy[key], [0, 0.0, 0.0, 0.0])
            row[0] += 1
            row[1] += ev["wall_s"] - replay - write
            row[2] += replay
            row[3] += write
        return {p: {"cells": n, "ingest_characterise_s": a / n,
                    "replay_s": r / n, "store_write_s": w / n}
                for p, (n, a, r, w) in sorted(rows.items())}


def journal(store):
    with open(Path(store.root) / store.JOURNAL) as f:
        return [json.loads(line) for line in f]


def cells_tree(store):
    """``{file name: bytes}`` of a store's ``cells/``."""
    d = Path(store.cells_dir)
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def executed_once(store, n):
    """The store's journal shows ``n`` cells done, none of them twice."""
    done = [ev["key"] for ev in journal(store) if ev["event"] == "done"]
    if len(done) != n or len(set(done)) != n:
        raise AssertionError(f"{store.root}: {len(done)} cells done, "
                             f"{len(set(done))} distinct; expected {n}")


def rank_launches(manifest, chunk):
    """B1 launches a campaign makes on the card: one a streamed chunk of
    every rank-policy cell (slot policies and quarantined cells none)."""
    import math

    from repro_torch.campaign import plan_cells
    from repro_torch.core import ALIASES
    from repro_torch.data import ingest
    n = 0
    for c in plan_cells(manifest):
        if ALIASES.get(c.policy, c.policy) not in RANK_POLICIES or \
                c.trace.endswith(CAMPAIGN_PLANTED):
            continue
        T = ingest.count_requests(c.trace)
        n += math.ceil((min(c.T, T) if c.T else T) / chunk)
    return n


def phase_campaign(dev, tmp):
    """A six-dataset campaign through ``repro_torch.campaign`` on the card,
    under ``tmp``: campaign A (four policies, T cut) inline on the card and
    on the CPU in worker processes meanwhile, every record and the report
    equal; campaign B (the rank policies, whole traces) in two spawned
    workers on the card, which start with no B1 library built and build
    it at once, into store 1, and inline over CAMPAIGN_RESUME_DATASETS
    with a crash after CAMPAIGN_CRASH_AFTER cells and a resume into store
    2, whose ``cells/`` equal store 1's files of the same cells byte for
    byte; campaign B's CAMPAIGN_ORACLE
    cells equal the Python oracle's reckoning.  Only the planted file is
    quarantined.  Returns (summary, B1 launches in this process, the
    report's text)."""
    import dataclasses
    import os
    import threading

    import torch
    from repro_torch.campaign import (CampaignStore, cell_key,
                                      format_report, plan_cells,
                                      render_report, run_campaign)
    from repro_torch.data import ingest
    from repro_torch.kernels import _build
    from repro_torch.kernels import policy_step as ps

    t_phase = time.perf_counter()
    tmp = Path(tmp)
    root = tmp / "corpus"
    root.mkdir()
    # the CPU's campaign A takes all but four cores: the main process, the
    # oracle's two workers and one more
    cpu_n = max(1, (os.cpu_count() or 2) - 4)
    with cpu_workers() as pool:
        corpus_s = campaign_corpus(str(root), pool)
    with cpu_workers(2) as pool:
        t0 = time.perf_counter()
        m_a, m_b = campaign_manifests(str(root))
        manifest_s = time.perf_counter() - t0
        m_r = dataclasses.replace(m_b, name="smoke-b-resume", datasets=tuple(
            d for d in m_b.datasets if d.name in CAMPAIGN_RESUME_DATASETS))
        if len(m_r.datasets) != len(CAMPAIGN_RESUME_DATASETS):
            raise AssertionError(f"datasets {[d.name for d in m_b.datasets]}"
                                 f" lack {CAMPAIGN_RESUME_DATASETS}")
        first = {d.name: os.path.join(m_b.root, d.traces[0][0])
                 for d in m_b.datasets}
        oracle = {(ds, pol, reg): pool.submit(oracle_cell, path, pol, reg)
                  for ds, path in first.items()
                  for pol, reg in CAMPAIGN_ORACLE}

        # campaign A on the CPU, in worker processes, while the card works
        stores = {name: CampaignStore(str(tmp / name)) for name in
                  ("a_card", "a_cpu", "b_pool", "b_resume")}
        cpu_out = {}

        def cpu_campaign():
            try:
                cpu_out["summary"] = run_campaign(
                    m_a, stores["a_cpu"], workers=cpu_n, device="cpu")
            except BaseException as exc:     # re-raised after the join
                cpu_out["error"] = exc

        cpu_thread = threading.Thread(target=cpu_campaign, daemon=True)
        cpu_thread.start()

        # B in spawned workers on the card, from no built B1 library
        lib = _build.library_path("policy_step")
        lib.unlink(missing_ok=True)
        lib.with_suffix(".log").unlink(missing_ok=True)
        t0 = time.perf_counter()
        b_pool = run_campaign(m_b, stores["b_pool"],
                              workers=CAMPAIGN_POOL_WORKERS, device=dev)
        b_pool_s = time.perf_counter() - t0
        if torch.device(dev).type == "cuda" and not lib.exists():
            raise AssertionError("the spawned workers left no B1 library")

        # A inline on the card
        timer_a = CellTimer()
        torch.cuda.synchronize()
        ps.LAUNCHES = 0
        t0 = time.perf_counter()
        with timer_a:
            a_card = run_campaign(m_a, stores["a_card"], device=dev)
        a_s = time.perf_counter() - t0
        a_launches = ps.LAUNCHES

        # B inline on the card: a crash after CAMPAIGN_CRASH_AFTER cells,
        # then a resume from a fresh handle on the same directory
        timer_b = CellTimer()
        ps.LAUNCHES = 0
        t0 = time.perf_counter()
        with timer_b:
            crashed = run_campaign(m_r, stores["b_resume"], device=dev,
                                   max_cells=CAMPAIGN_CRASH_AFTER)
            resumed = run_campaign(
                m_r, CampaignStore(stores["b_resume"].root), device=dev)
        b_resume_s = time.perf_counter() - t0
        b_launches = ps.LAUNCHES
        card_s = time.perf_counter() - t_phase

        t0 = time.perf_counter()
        cpu_thread.join()
        if "error" in cpu_out:
            raise cpu_out["error"]
        oracle = {k: f.result() for k, f in oracle.items()}
        cpu_wait_s = time.perf_counter() - t0

    # 1. quarantine: the planted file's cells, and nothing else
    bad = [c for c in plan_cells(m_a) if c.trace.endswith(CAMPAIGN_PLANTED)]
    for name, st in stores.items():
        want_q = sorted(cell_key(c) for c in bad) if name[0] == "a" else []
        if st.quarantined() != want_q:
            raise AssertionError(f"store {name} quarantined "
                                 f"{st.quarantined()}; expected {want_q}")
    n_a, n_b = len(plan_cells(m_a)) - len(bad), len(plan_cells(m_b))
    n_r = len(plan_cells(m_r))
    for summary, n in ((a_card, n_a), (cpu_out["summary"], n_a),
                       (b_pool, n_b)):
        if len(summary.executed) != n or summary.remaining:
            raise AssertionError(f"campaign: {summary.counts}, expected "
                                 f"{n} executed")
    if (len(crashed.executed), len(resumed.executed), resumed.skipped) != \
            (CAMPAIGN_CRASH_AFTER, n_r - CAMPAIGN_CRASH_AFTER,
             CAMPAIGN_CRASH_AFTER):
        raise AssertionError(f"crash and resume: {crashed.counts}, "
                             f"{resumed.counts}")

    # 2. campaign A: the card's records equal the CPU's, key for key
    card, cpu = stores["a_card"], stores["a_cpu"]
    if card.completed() != cpu.completed():
        raise Mismatch("campaign A: the card and the CPU completed "
                       "different cells")
    for key in card.completed():
        got, want = card.get(key), cpu.get(key)
        for part in ("records", "extras", "config"):
            if got[part] != want[part]:
                rec = got["extras"]["campaign"]["cell"]
                raise Mismatch(
                    f"campaign A {rec['trace']} {rec['policy']} "
                    f"K={rec['K']}: {part} on the card "
                    f"{got['records'][0]['metrics']} vs the CPU "
                    f"{want['records'][0]['metrics']}")
        if got["provenance"]["backend"] != torch.device(dev).type:
            raise AssertionError(f"campaign A {key}: provenance "
                                 f"{got['provenance']}")

    # 3. campaign B: CAMPAIGN_ORACLE cells equal the oracle's reckoning
    by_cell = {}
    for key, payload in stores["b_pool"].payloads():
        c = payload["extras"]["campaign"]["cell"]
        by_cell[c["trace"], c["policy"], c["K"]] = payload["records"][0]
    for (ds, pol, reg), (K, metrics) in oracle.items():
        rec = by_cell[first[ds], pol, reg]
        if rec["K"] != K or rec["metrics"] != metrics:
            raise Mismatch(f"campaign B {ds} {pol} {reg} (K {rec['K']}): "
                           f"card {rec['metrics']} vs the oracle K {K} "
                           f"{metrics}")

    # 4. spawned workers vs crash and resume: equal bytes, no cell twice
    pool_tree, resume_tree = (cells_tree(stores[n])
                              for n in ("b_pool", "b_resume"))
    if len(resume_tree) != n_r or any(pool_tree.get(name) != data
                                      for name, data in resume_tree.items()):
        raise Mismatch("campaign B: store 2 (crash and resume) differs from "
                       "store 1 (2 spawned workers) on its cells")
    executed_once(stores["b_pool"], n_b)
    executed_once(stores["b_resume"], n_r)

    # 5. the report: the card's store A against the CPU's
    rep_card, rep_cpu = render_report(card), render_report(cpu)
    if rep_card != rep_cpu:
        raise Mismatch("campaign A: the card's report differs from the "
                       "CPU's")

    want_a, want_b = (rank_launches(m, ingest.DEFAULT_CHUNK)
                      for m in (m_a, m_r))
    if (a_launches, b_launches) != (want_a, want_b):
        raise AssertionError(f"campaign: B1 launched {a_launches} (A) and "
                             f"{b_launches} (B, crash and resume) times; "
                             f"expected {want_a} and {want_b}")
    K = sorted({r["K"] for _, p in card.payloads() for r in p["records"]})
    return ({"phase": "campaign",
             "corpus": {"datasets": [d.name for d in m_b.datasets],
                        "traces": sum(len(d.traces) for d in m_b.datasets),
                        "requests_per_trace": CAMPAIGN_TRACE_T,
                        "csv_gz": "/".join(map(str, CAMPAIGN_CSV)),
                        "planted": CAMPAIGN_PLANTED,
                        "write_s": corpus_s, "scan_s": manifest_s},
             "cut": f"campaign A T {CAMPAIGN_A_T} of {CAMPAIGN_TRACE_T}; "
                    f"the resume over {n_r} of B's {n_b} cells",
             "a": {"cells": n_a, "quarantined": len(bad), "K": K,
                   "s": a_s, "policy_replay": a_launches,
                   "cells_equal_cpu": n_a, "report_equal_cpu": True,
                   "per_cell_s": timer_a.split(card, m_a),
                   "cpu_workers": cpu_n},
             "b": {"cells": n_b, "pool_workers": CAMPAIGN_POOL_WORKERS,
                   "pool_s": b_pool_s, "resume_s": b_resume_s,
                   "crash_after": CAMPAIGN_CRASH_AFTER,
                   "resume_cells": n_r,
                   "resume_datasets": list(CAMPAIGN_RESUME_DATASETS),
                   "policy_replay_resume": b_launches,
                   "stores_equal": True,
                   "oracle_cells_equal": len(oracle),
                   "per_cell_s": timer_b.split(stores["b_resume"], m_r)},
             "card_s": card_s, "cpu_wait_s": cpu_wait_s,
             "s": time.perf_counter() - t_phase},
            a_launches + b_launches, format_report(rep_card))


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

# (a) deepseek-7b at full width, its depth cut to TRAIN_LAYERS of 30 (the
# only cut), B = TRAIN_B sequences of TRAIN_S tokens from the token
# pipeline, TRAIN_STEPS steps with f32 moments and again with int8 ones
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 8, 2048, 6
# Adam's first, sign-like updates move every 4,096-wide matrix of this
# random model by a large share of its norm: at 3e-4 after the 2-step
# warm-up its loss rose far above where it started before it fell
TRAIN_LR = 5e-5
# the int8 run's last loss against the f32 run's: the reference's own
# bound (tests/test_train.py, test_adamw_int8_moments_track_f32)
TRAIN_INT8_GAP = 0.15
# (b) kill and resume at full width: RESUME_LAYERS deep, B = RESUME_B x
# RESUME_S, RESUME_STEPS steps, a checkpoint every RESUME_EVERY, int8
# moments, async saves; the run is killed inside step RESUME_KILL_AT
RESUME_LAYERS, RESUME_B, RESUME_S = 2, 2, 512
RESUME_STEPS, RESUME_EVERY, RESUME_KILL_AT = 8, 4, 6
# The resumed run recomputes steps 4-7 from the step-4 snapshot of its own
# first run, which recomputed steps 0-3 apart from the uninterrupted run.
# A CUDA kernel that accumulates with atomics (PyTorch does not promise a
# deterministic backward for indexing) would let the two first runs
# differ in the last bits of a gradient, which bf16 parameters and int8
# moments can carry into one rounding step; the losses must agree within
# this relative tolerance.  The gap measured on an H100 was 0 (PERF.md).
RESUME_RTOL = 2e-3
# (c) card against CPU: smoke configs in f32, TRAIN_VS_CPU_STEPS steps on
# B = 4 x 64 from one init and one batch stream.  The two devices sum in
# other orders (~1e-6 relative on a gradient), which Adam's first steps at
# eps = 1e-8 blow up for gradients near eps (see tests/test_torch_train.py,
# STEP_OPT): at eps = 1e-3 a parameter moves by at most lr * |dg| / eps.
TRAIN_VS_CPU = ("deepseek-7b", "mixtral-8x22b")
TRAIN_VS_CPU_STEPS = 3
TRAIN_VS_CPU_LOSS_RTOL = 1e-5
TRAIN_VS_CPU_PARAM_REL = 1e-4      # of each leaf's largest magnitude


class Killed(RuntimeError):
    pass


def train_run(dev, cfg, moments, B, S, steps, ckpt_dir=None, every=0,
              kill_at=None):
    """One ``Trainer`` run; returns (trainer, seconds)."""
    import torch
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=steps,
                      moment_dtype=moments)
    tcfg = TrainConfig(steps=steps, ckpt_dir=ckpt_dir,
                       ckpt_every=every or steps, global_batch=B, seq_len=S,
                       seed=SEED, async_ckpt=True)
    trainer = Trainer(cfg, opt, tcfg, device=dev)
    if kill_at is not None:
        step_fn, calls = trainer._step, []

        def killing(*a):
            calls.append(1)
            if len(calls) == kill_at + 1:
                raise Killed(f"killed inside step {kill_at}")
            return step_fn(*a)
        trainer._step = killing
    t0 = time.perf_counter()
    try:
        trainer.run()
    except Killed:
        pass
    torch.cuda.synchronize()
    return trainer, time.perf_counter() - t0


def train_full_width(dev):
    """(a): deepseek-7b, full width, ``TRAIN_LAYERS`` deep, bf16."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import param_count

    cfg = dataclasses.replace(ARCHS["deepseek-7b"], n_layers=TRAIN_LAYERS)
    out = {"arch": cfg.name, "layers": TRAIN_LAYERS,
           "layers_of_config": ARCHS["deepseek-7b"].n_layers,
           "params": param_count(cfg), "dtype": cfg.param_dtype,
           "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
           "lr": TRAIN_LR}
    for moments in ("float32", "int8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer, s = train_run(dev, cfg, moments, TRAIN_B, TRAIN_S,
                               TRAIN_STEPS)
        hist = trainer.history
        losses = [h["loss"] for h in hist]
        dts = [h["dt"] for h in hist[1:]]
        step_s = sum(dts) / len(dts)
        if len(hist) != TRAIN_STEPS or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"train {moments}: losses {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train {moments}: the loss did not fall: "
                                 f"{losses}")
        out[moments] = {"loss_first": losses[0], "loss_last": losses[-1],
                        "losses": losses, "step_s": step_s,
                        "first_step_s": hist[0]["dt"],
                        "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
                        "peak_bytes": torch.cuda.max_memory_allocated(),
                        "grad_norms": [h["grad_norm"] for h in hist],
                        "run_s": s}
        del trainer
    gap = abs(out["int8"]["loss_last"] - out["float32"]["loss_last"])
    out["int8_vs_f32_last_loss"] = gap
    if gap > TRAIN_INT8_GAP:
        raise AssertionError(f"int8 moments' last loss is {gap} from f32's "
                             f"(limit {TRAIN_INT8_GAP})")
    return out


def train_kill_resume(dev, tmp):
    """(b): an uninterrupted run against one killed inside step
    ``RESUME_KILL_AT`` and resumed from its step-``RESUME_EVERY``
    checkpoint, at full width."""
    import dataclasses
    import os

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS

    cfg = dataclasses.replace(ARCHS["deepseek-7b"], n_layers=RESUME_LAYERS)
    d_kill = os.path.join(tmp, "kill")
    kw = dict(B=RESUME_B, S=RESUME_S, steps=RESUME_STEPS, every=RESUME_EVERY)
    # the uninterrupted run writes no checkpoints: only its losses are read
    full, full_s = train_run(dev, cfg, "int8", **kw)
    killed, kill_s = train_run(dev, cfg, "int8", ckpt_dir=d_kill,
                               kill_at=RESUME_KILL_AT, **kw)
    kept = CheckpointManager(d_kill).steps()
    resumed, res_s = train_run(dev, cfg, "int8", ckpt_dir=d_kill, **kw)
    want = [h["loss"] for h in full.history]
    got = [h["loss"] for h in resumed.history]
    first = resumed.history[0]["step"] if got else None
    if len(killed.history) != RESUME_KILL_AT or kept != [RESUME_EVERY] or \
            first != RESUME_EVERY or len(got) != RESUME_STEPS - RESUME_EVERY:
        raise AssertionError(f"kill and resume: killed run "
                             f"{len(killed.history)} steps, checkpoints "
                             f"{kept}, resumed from {first} for {len(got)} "
                             f"steps")
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want[RESUME_EVERY:])]
    if max(gaps) > RESUME_RTOL:
        raise AssertionError(f"resumed losses {got} against {want}: "
                             f"relative gap {max(gaps)} > {RESUME_RTOL}")
    ckpt = os.path.join(d_kill, f"step_{RESUME_STEPS:010d}", "state.npz")
    return {"layers": RESUME_LAYERS, "batch": RESUME_B, "seq": RESUME_S,
            "steps": RESUME_STEPS, "ckpt_every": RESUME_EVERY,
            "killed_inside_step": RESUME_KILL_AT, "moments": "int8",
            "async": True, "checkpoints_after_kill": kept,
            "resumed_from": first, "losses": want, "resumed_losses": got,
            "last_loss_rel_gap": gaps[-1], "max_rel_gap": max(gaps),
            "rtol": RESUME_RTOL, "checkpoint_bytes": os.path.getsize(ckpt),
            "full_s": full_s, "killed_s": kill_s, "resumed_s": res_s}


def train_vs_cpu(dev):
    """(c): the same train steps on the card and on the CPU."""
    import dataclasses

    import torch
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import (init_params, params_from_reference,
                                    params_to_reference, stacked_view)
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step

    out = []
    for name in TRAIN_VS_CPU:
        cfg = dataclasses.replace(SMOKE_ARCHS[name], param_dtype="float32")
        opt = AdamWConfig(lr=1e-3, warmup_steps=1,
                          total_steps=TRAIN_VS_CPU_STEPS, eps=1e-3)
        cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        # (device, parameters, optimizer state): the card's, then the CPU's
        sides = [[d, p, adamw.init(stacked_view(p, cfg), opt)] for d, p in (
            (dev, params_from_reference(params_to_reference(cpu, cfg), cfg,
                                        dev)), ("cpu", cpu))]
        step = make_train_step(cfg, opt)
        pipe = TokenPipeline(cfg.vocab, 4, 64, seed=SEED)
        loss_gap = 0.0
        for t in range(TRAIN_VS_CPU_STEPS):
            batch = pipe.batch(t)
            loss = []
            for side in sides:
                d = side[0]
                side[1], side[2], m = step(side[1], side[2], {
                    k: torch.from_numpy(v).to(d) for k, v in batch.items()})
                loss.append(float(m["loss"]))
            gap = abs(loss[0] - loss[1]) / abs(loss[1])
            loss_gap = max(loss_gap, gap)
            if gap > TRAIN_VS_CPU_LOSS_RTOL:
                raise AssertionError(f"{name} step {t}: loss card, CPU "
                                     f"{loss}")
        got, want = (params_to_reference(side[1], cfg) for side in sides)
        worst = 0.0
        for path, w in flat_leaves(want):
            g = flat_get(got, path).cpu()
            rel = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            worst = max(worst, rel)
            if rel > TRAIN_VS_CPU_PARAM_REL:
                raise AssertionError(f"{name} {path}: card and CPU "
                                     f"parameters differ by {rel} of the "
                                     f"leaf's largest")
        out.append({"arch": name, "dtype": "float32", "batch": 4, "seq": 64,
                    "steps": TRAIN_VS_CPU_STEPS, "max_loss_rel_gap": loss_gap,
                    "max_param_rel_gap": worst})
    return out


def flat_leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from flat_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def flat_get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def train_guard(dev):
    """(d): a grad-mode call of B2 raises on the card (no backward)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    q = torch.randn(1, 64, 4, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 64, 4, 64, device=dev)
    try:
        fa.flash_attention(q, k, k)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        return str(e)
    raise AssertionError("B2 ran under autograd with an input that "
                         "requires grad")


def phase_train(dev):
    """Phase 14: training through ``repro_torch.train`` on the card (plain
    attention: B2 has no backward, as the reference's Pallas kernel has
    none), B2's and B3's launch counts unchanged across the phase."""
    import tempfile

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    launches = (fa.LAUNCHES, da.LAUNCHES)
    res = {"phase": "train", "nvidia_smi": nvidia_smi_line()}
    res["full_width"] = train_full_width(dev)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        res["kill_resume"] = train_kill_resume(dev, tmp)
    res["card_vs_cpu"] = train_vs_cpu(dev)
    res["b2_guard"] = train_guard(dev)
    if (fa.LAUNCHES, da.LAUNCHES) != launches:
        raise AssertionError(f"training launched B2/B3: "
                             f"{launches} -> {(fa.LAUNCHES, da.LAUNCHES)}")
    res["b2_b3_launches_in_phase"] = 0
    res["s"] = time.perf_counter() - t0
    return res


# -- phase 16: the analysis layer --------------------------------------------

def analysis_toys():
    """Three toy slot policies over one ``cache`` row for phase 16's
    controls: a clean step, one that reads a value to the host
    (``.item()``), and one that bakes a host counter into its output
    (equal to the eager step until it is captured)."""
    import torch

    from repro_torch.core import Policy, padded_row, step_info

    class Toy(Policy):
        name = "toy"

        def init(self, K, lanes=1, device="cuda"):
            return {"cache": padded_row(K, lanes, device)}

        def step(self, state, req):
            cache = state["cache"]
            hit = (cache == req.key.unsqueeze(-1)).any(-1)
            first = torch.where(hit, cache[:, 0], req.key)
            cache = torch.cat([first.unsqueeze(-1), cache[:, 1:]], -1)
            return {"cache": cache}, step_info(hit, req)

    class HostRead(Toy):
        name = "hostread"

        def step(self, state, req):
            if int(req.key[0]) < 0:         # reads the key on the host
                req = req._replace(key=req.key + 1)
            return super().step(state, req)

    class HostCounter(Toy):
        name = "hostcounter"

        def __init__(self):
            self.calls = 0

        def step(self, state, req):
            self.calls += 1
            new, info = super().step(state, req)
            return {"cache": new["cache"] + 2 * (self.calls // 2)}, info

    return Toy(), HostRead(), HostCounter()


def phase_analysis(dev):
    """Phase 16: the port's analysis layer (``repro_torch.analysis``) on the
    card.  The contract pass over the 30 registry specs, the budgeted DAC
    and ``admit(dac)``, the tier and the fleet, each step also captured
    into a CUDA graph and its replay held equal to the eager step bit for
    bit; the float64-default-dtype sub-pass; the retrace audit of dac (B1)
    and lru (the graph loop) on ``Engine(device="cuda")``; the linter over
    the checkout.  None may give a finding.  Then three toy steps: a clean
    one gives none, a host read and a host counter baked into the graph
    are caught.  Returns the phase's line and B1's launches in it."""
    from repro_torch.analysis import contracts, lint, retrace
    from repro_torch.core import RankPolicy, make_policy
    from repro_torch.core.simulator import GRAPH_CHUNK
    from repro_torch.kernels import policy_step

    t_phase = time.perf_counter()
    b1 = policy_step.LAUNCHES
    captured = {"calls": 0, "equal": 0}
    check = contracts._capture_check

    def counted(*args, **kwargs):
        ok = check(*args, **kwargs)
        captured["calls"] += 1
        captured["equal"] += ok
        return ok

    contracts._capture_check = counted
    try:
        t0 = time.perf_counter()
        found = contracts.verify_contracts(devices=(dev,))
        s_contracts = time.perf_counter() - t0
    finally:
        contracts._capture_check = check
    specs = contracts.registry_specs()
    n_main, n_sub = len(specs) + 4, len(specs)
    sub = [f for f in found if "/default=float64" in f.where]
    res = {"phase": "analysis",
           "contracts": {"targets": n_main, "findings": len(found) - len(sub)},
           "dtype_subpass": {"targets": n_sub, "findings": len(sub)},
           "captured_equal_to_eager": captured["equal"],
           "contracts_s": s_contracts}

    t0 = time.perf_counter()
    b1_audit = policy_step.LAUNCHES
    res["retrace"] = {"T": 2 * GRAPH_CHUNK + 3}
    for policy in ("dac", "lru"):
        fs, report = retrace.audit_engine(policy, device=dev)
        found += fs
        res["retrace"][policy] = {"findings": len(fs), "counts": report}
    b1_audit = policy_step.LAUNCHES - b1_audit
    res["retrace"]["s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fs = lint.lint_tree(ROOT)
    found += fs
    files = [p for d in ("src", "benchmarks", "tools")
             for p in (ROOT / d).rglob("*.py") if "__pycache__" not in p.parts]
    res["lint"] = {"files": len(files), "findings": len(fs),
                   "s": time.perf_counter() - t0}
    if found:
        raise AssertionError("phase 16 found:\n" + "\n".join(map(str, found)))
    if dev == "cuda" and captured != {"calls": n_main + n_sub,
                                      "equal": n_main + n_sub}:
        raise AssertionError(f"phase 16 captured {captured}, expected every "
                             f"one of {n_main + n_sub} steps equal")

    # controls: the checks catch what they exist to catch
    toy, read, counter = analysis_toys()
    controls = {name: contracts.check_policy(pol, device=dev)
                for name, pol in (("clean", toy), ("host_read", read),
                                  ("host_counter", counter))}
    on_card = dev == "cuda"
    want = {"clean": [], "host_read": ["forbidden-primitive"] * (1 + on_card),
            "host_counter": ["forbidden-primitive"] * on_card}
    got = {k: [f.rule for f in v] for k, v in controls.items()}
    if got != want:
        raise AssertionError(f"phase 16's controls gave {controls}")
    res["controls"] = {k: [f.message for f in v]
                       for k, v in controls.items()}

    # B1 runs in every rank target of both contract passes (the three rank
    # specs and their admit(...) wrappers), the two budgeted DAC targets,
    # the tier and the fleet: once eagerly, once at capture; and once a
    # CUDA replay of dac in the audit (7 canonical calls, 6 variants each
    # beside its canonical call)
    rank = sum(isinstance(getattr(make_policy(s), "base", make_policy(s)),
                          RankPolicy) for s in specs)
    launches = policy_step.LAUNCHES - b1
    want_b1 = 2 * (2 * rank + 4) + 7 + 2 * 6
    if on_card and (launches != want_b1 or b1_audit != 7 + 2 * 6):
        raise AssertionError(f"phase 16 launched B1 {launches} times "
                             f"(the audit {b1_audit}), expected {want_b1}")
    res["b1_launches"] = launches
    res["s"] = time.perf_counter() - t_phase
    return res, launches


# -- phase 17: the dry run against the card ---------------------------------

# the caching allocator rounds every block up to a multiple of 512 bytes
# (c10/cuda/CUDACachingAllocator.cpp, kMinBlockSize), so the card holds
# each storage of the step's arguments with 0-511 bytes more than its size
ALLOC_ROUND = 512
DRYRUN_ARCH = "deepseek-7b"


def phase_dryrun(dev, serve, slot):
    """Phase 17: the dry run (``repro_torch.launch.dryrun``) against what
    the card holds and how long a step took, traced on fake tensors on
    ``dev`` (nothing on the card).  The decode step at phase 6's shape
    (B = 8, ``max_len`` slots, full width) on one rank: its argument bytes
    (parameters, the state, the token) equal to what phase 6's allocator
    held for them, within its rounding; its modelled roofline terms beside
    phase 6's measured ms a step and device-busy ms.  ``decode_32k`` on the
    (16, 16) pod mesh in a fake world of 256 ranks: bytes a rank and the
    dominant term.  Phase 15's world (c) (``slot``: its rank 0's step
    arguments): qwen1.5-110b's 1-layer rank on the (data 1, model 16)
    mesh in a fake world of 16, its argument bytes equal to what the
    rank's allocator held, within its rounding, and its KV bytes (a 16th
    of the slots) equal.  The phase's seconds include torch's first use of
    ``FakeTensorMode`` (it imports ``torch._dynamo``), timed apart as
    ``first_use_s``.  No step runs on the card."""
    t_phase = time.perf_counter()
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ARCHS, SHAPES, ShapeCell
    from repro_torch.launch import dryrun

    FakeTensorMode()                 # torch's first use, timed on its own
    first_use_s = time.perf_counter() - t_phase
    cfg = ARCHS[DRYRUN_ARCH]
    held = serve["step_args"]
    cell = ShapeCell("phase6_decode", held["max_len"], SERVE_B, "decode")
    t1 = time.perf_counter()
    ana, n, meta, mem = dryrun.trace_cell(DRYRUN_ARCH, cell, "single",
                                          device=dev)
    single_s = time.perf_counter() - t1
    got, want = mem["argument_bytes"], held["allocated_bytes"]
    storages = mem["argument_storages"]
    slack = (ALLOC_ROUND - 1) * storages
    if not 0 <= want - got <= slack:
        raise AssertionError(
            f"phase 17: the dry run reckons {got} argument bytes, the card "
            f"held {want} (allowed: 0 to {slack} more)")
    rf = dryrun.summarize(ana, n, meta, mem, cell, cfg)["roofline"]
    unb = serve["unbounded"]
    t1 = time.perf_counter()
    shape = SHAPES["decode_32k"]
    ana, n, meta, mem = dryrun.trace_cell(DRYRUN_ARCH, shape, "pod",
                                          device=dev)
    pod_s = time.perf_counter() - t1
    pod = dryrun.summarize(ana, n, meta, mem, shape, cfg)
    credited = pod["roofline"]["kernel_credited"]
    t1 = time.perf_counter()
    slot_rank = dryrun_slot_rank(dev, slot)
    slot_rank["s"] = time.perf_counter() - t1
    return {"phase": "dryrun",
            "step_args": {"dryrun_bytes": got, "allocated_bytes": want,
                          "difference": want - got, "allowed": slack,
                          "storages": storages},
            "phase6_decode": {
                "modelled_ms": {k[:-2]: rf[k] * 1e3 for k in
                                ("compute_s", "memory_s", "collective_s")},
                "modelled_memory_ms_kernel_credited":
                    rf["kernel_credited"]["memory_s"] * 1e3,
                "dominant": rf["dominant"],
                "measured_ms_per_step": unb["ms_per_step"],
                "measured_device_busy_ms":
                    unb["decode_step_profile"]["device_busy_ms"]},
            "pod_decode_32k": {
                "ranks": n, "argument_bytes_per_rank": mem["argument_bytes"],
                "total_nonaliased_gb": pod["memory"]["total_nonaliased_gb"],
                "dominant": pod["roofline"]["dominant"],
                "kernel_credited_dominant": credited["dominant"],
                "terms_ms": {k[:-2]: pod["roofline"][k] * 1e3 for k in
                             ("compute_s", "memory_s", "collective_s")},
                "kernel_credited_memory_ms": credited["memory_s"] * 1e3},
            "slot_rank": slot_rank,
            "first_use_s": first_use_s, "single_s": single_s,
            "pod_s": pod_s, "s": time.perf_counter() - t_phase}


def dryrun_slot_rank(dev, held):
    """Rank 0 of phase 15's world (c) reckoned by the dry run's means
    (``init_params_shape``, ``serve_state_specs`` with ``sctx=`` in a fake
    world of MG_SLOT_WORLD, ``dryrun.tree_bytes``): its argument bytes
    (the blocks, a fresh unbounded state, a token) within the allocator's
    rounding of what the rank held, its KV bytes equal."""
    import dataclasses

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params_shape
    from repro_torch.serving.serve_step import kv_bytes, serve_state_specs
    cfg = dataclasses.replace(ARCHS[MG_SLOT_ARCH], n_layers=1)
    with dryrun.fake_world(MG_SLOT_WORLD):
        mesh = M.make_test_mesh(1, MG_SLOT_WORLD,
                                device_type=torch.device(dev).type)
        sctx = M.shard_ctx(mesh, mode="serve")
        mode = FakeTensorMode()
        params = init_params_shape(cfg, sctx, dev, mode)
        state = serve_state_specs(cfg, held["B"], held["max_len"], sctx=sctx,
                                  device=dev, mode=mode)
        with mode:
            token = torch.zeros(held["B"], dtype=torch.int64, device=dev)
        args = (params, state, token)
        got, storages = dryrun.tree_bytes(args), len(dryrun._storages(args))
        kv = kv_bytes(state)
    want, slack = held["allocated_bytes"], (ALLOC_ROUND - 1) * storages
    if kv != held["kv_bytes"]:
        raise AssertionError(f"phase 17: the dry run reckons {kv} KV bytes "
                             f"for (c)'s rank, the rank held "
                             f"{held['kv_bytes']}")
    if want is not None and not 0 <= want - got <= slack:
        raise AssertionError(
            f"phase 17: the dry run reckons {got} argument bytes for (c)'s "
            f"rank, the rank held {want} (allowed: 0 to {slack} more)")
    return {"dryrun_bytes": got, "allocated_bytes": want,
            "difference": None if want is None else want - got,
            "allowed": slack, "storages": storages, "kv_bytes": kv}


# -- phase 15: multi-GPU ----------------------------------------------------

MG_WORLD = 4                 # gloo ranks that share the card in (b)
MG_TIMEOUT = 420             # seconds a world may take
MG_FAMILY = "alibaba"
MG_SEEDS, MG_T = 16, 200_000          # (a): the main path's lanes and T
MG_LANES, MG_LANES_T = 64, 50_000     # (b): Engine(mesh=) over 4 ranks
MG_SLOT = "fifo"                      # the slot policy, at SLOT_T
# the reference test's fleet (tests/test_fleet.py::
# test_sharded_fleet_conserves_and_rebalances) and phase 11's "pool" at
# FLEET_T, dac+auction, at the reference's default rebalance
MG_FLEET_TRACE = dict(N=128, T=2500, n_lanes=8, rate=0.02, mean_session=500,
                      lo=8, seed=0)
MG_FLEET_REBALANCE = (200, 256)
MG_SERVE_LAYERS, MG_SERVE_B, MG_SERVE_S = 4, 8, 512
# 8 decode steps (16 until phase 15 trained too)
MG_SERVE_STEPS, MG_SERVE_BUDGET = 8, 512
MG_F32_LAYERS, MG_F32_S, MG_F32_STEPS = 2, 256, 8
# the MoE, MLA and recurrent models on (data 2, model 2), full width, depth
# cut: deepseek-v2-236b's first 2 of 60 layers (MLA + MoE, 80 of its 160
# experts a model rank), jamba-1.5-large-398b's first 5 of 72 (Mamba, MoE
# and the attention layer at index 4), xlstm-125m whole; bf16, B = 8 x
# MG_SERVE_S, MG_ARCH_STEPS decode steps in both regimes; then each at 2
# layers in f32 (B = 8 x MG_F32_S, MG_ARCH_STEPS steps) against the
# unsharded port on rank 0.  4 steps, not 8: at 8 the three took 42 s of
# a 30 s target (PERF.md, PR 21)
MG_ARCHS = (("deepseek-v2-236b", 2), ("jamba-1.5-large-398b", 5),
            ("xlstm-125m", 12))
MG_ARCH_STEPS = 4
# a recurrent state leaf, sharded against unsharded: max |diff| within
# MG_STATE_TOL x max(1, max |unsharded|)
MG_STATE_TOL = 1e-4


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _empty(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _arrays(tree, prefix=""):
    """The tensors of a result (nested tuples and dicts) as numpy, by
    path."""
    import torch
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(getattr(tree, "_fields", range(len(tree))), tree)
    else:
        x = tree.detach().cpu()
        return {prefix: x.float().numpy() if x.dtype == torch.bfloat16
                else x.numpy()}
    out = {}
    for k, v in items:
        out.update(_arrays(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _digest(arrays):
    """A SHA-256 of named arrays' bytes (ranks that must hold the same
    result compare these)."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(arrays[k].tobytes())
    return h.hexdigest()


def _equal_arrays(a, b, what):
    import numpy as np
    if sorted(a) != sorted(b):
        raise Mismatch(f"{what}: fields {sorted(a)} vs {sorted(b)}")
    for k in a:
        if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            raise Mismatch(f"{what}: {k} differs")


def mg_fleet_cases(dev):
    """(name, tier, [T, N] requests, rebalance) of the sharded fleets."""
    from repro_torch.bench.runner import materialize
    from repro_torch.core import Request
    from repro_torch.data.traces import fleet_trace
    from repro_torch.fleet import FleetTier
    sc = fleet_sweep().scenarios[0]
    pool = materialize(sc, (0,), dev)
    return [("reference_test",
             FleetTier("dac(k_min=4)", n_lanes=8, budget=96,
                       arbiter="auction"),
             Request.of(fleet_trace(**MG_FLEET_TRACE), device=dev),
             MG_FLEET_REBALANCE[0]),
            ("pool", FleetTier(TIER_DAC, n_lanes=sc.n_lanes,
                               budget=sc.budgets()[0], arbiter="auction",
                               k0=sc.k0, util_decay=sc.util_decay),
             Request(*(x[0] for x in pool)), MG_FLEET_REBALANCE[1])]


def mg_fleets(dev, mesh, names=None):
    """The sharded fleets on this rank (those of ``names``, default all):
    each whole-fleet result (numpy), its seconds, B1 launches and its
    re-deals' ms (the all-gather and the share, between graph chunks)."""
    from repro_torch.fleet import replay_fleet
    from repro_torch.fleet import fleet as fleet_mod
    from repro_torch.kernels import policy_step as ps
    redeal_ms, redeal = [], fleet_mod._redeal

    def timed(tier, mesh_, axis):
        at_cut = redeal(tier, mesh_, axis)

        def at(carry, t):
            _sync(dev)
            t0 = time.perf_counter()
            out = at_cut(carry, t)
            _sync(dev)
            redeal_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return at

    out = {}
    fleet_mod._redeal = timed
    try:
        for name, tier, reqs, rebalance in mg_fleet_cases(dev):
            if names is not None and name not in names:
                continue
            del redeal_ms[:]
            ps.LAUNCHES = 0
            _sync(dev)
            t0 = time.perf_counter()
            res = replay_fleet(tier, reqs, observe=True, mesh=mesh,
                               rebalance=rebalance, device=dev)
            _sync(dev)
            s = time.perf_counter() - t0
            out[name] = {"arrays": _arrays(res), "s": s,
                         "T": reqs.key.shape[0], "b1_launches": ps.LAUNCHES,
                         "redeals": len(redeal_ms),
                         "redeal_ms": sorted(redeal_ms)}
    finally:
        fleet_mod._redeal = redeal
    return out


def mg_fleet_launches(T, rebalance, chunk):
    """B1 launches of a sharded fleet replay on the card: the graph loop
    captures once (one warm-up step, ``chunk`` captured, counted once)
    and each stretch between re-deals runs its ``len % chunk`` tail
    eagerly."""
    from repro_torch.core.simulator import _segments
    segments = _segments(T, range(0, T, rebalance))
    tails = sum((hi - lo) % chunk for lo, hi in segments)
    full = any(hi - lo >= chunk for lo, hi in segments)
    return tails + (1 + chunk if full else 0)


def mg_world_a(dev):
    """(a) One rank (NCCL on the card): ``Engine(mesh=)`` for dac, ac and
    climb on the main path's 16 seeds x T and for one slot policy at
    SLOT_T, and the reference test's sharded fleet at n = 1, each against
    the unsharded run on the same device.  The replays' seconds are a
    second run of each side, unsharded first, after the compared runs
    (sharded first), so that neither side's time holds a first call's
    set-up."""
    import torch
    from repro_torch.core import Engine
    from repro_torch.data.traces import family_footprint, k_for
    from repro_torch.fleet import replay_fleet
    from repro_torch.kernels import policy_step as ps
    from repro_torch.launch import mesh as M
    mesh = M.make_test_mesh(1, 1)
    keys, sizes, costs = replay_inputs(MG_SEEDS, MG_T, dev, MG_FAMILY)
    K = k_for(family_footprint(MG_FAMILY), "L")
    out = {"backend": torch.distributed.get_backend(), "replay": {},
           "b1_launches": 0}
    for spec in ("dac", "ac", "climb", MG_SLOT):
        T = MG_T if spec != MG_SLOT else SLOT_T
        req = (keys[:, :T], sizes[:, :T], costs[:, :T])
        kw = dict(sizes=req[1], costs=req[2], **main_mode(spec))
        sharded, whole = Engine(device=dev, mesh=mesh), Engine(device=dev)
        ps.LAUNCHES = 0
        got = sharded.replay(spec, req[0], K, **kw)
        launches = ps.LAUNCHES
        out["b1_launches"] += launches
        want = whole.replay(spec, req[0], K, **kw)
        _equal_arrays(_arrays(got), _arrays(want), f"(a) {spec}")
        secs = {}
        for side, eng in (("unsharded_s", whole), ("s", sharded)):
            _sync(dev)
            t0 = time.perf_counter()
            eng.replay(spec, req[0], K, **kw)
            _sync(dev)
            secs[side] = time.perf_counter() - t0
        out["replay"][spec] = {"T": T, "lanes": MG_SEEDS, **secs,
                               "launches": launches}
    fleets = mg_fleets(dev, mesh, ("reference_test",))
    for name, tier, reqs, rebalance in mg_fleet_cases(dev)[:1]:
        want = _arrays(replay_fleet(tier, reqs, observe=True, device=dev))
        _equal_arrays(fleets[name].pop("arrays"), want, f"(a) fleet {name}")
        out["b1_launches"] += fleets[name]["b1_launches"]
    out["fleet"] = fleets
    return out


def mg_world_cpu():
    """(b)'s fleets on the CPU: the same world size, the plain versions.
    One thread a rank (these small fleets run no faster on more: 19.9 s
    with one or two a rank on an 8-core host), leaving the host's other
    cores to (a)."""
    import torch
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    mesh = M.make_test_mesh(MG_WORLD, 1)
    out = {k: v["arrays"] for k, v in mg_fleets("cpu", mesh).items()}
    return out, time.perf_counter() - t0


def mg_serve_run(params, cfg, sctx, toks, S, steps, budget, impl="kernel",
                 margins=None, max_len=None):
    """Prefill ``toks[:, :S]`` and ``steps`` teacher-forced decode steps
    (``max_len`` slots unbounded, ``S + steps`` by default):
    logits, the pooled layers' control state after each step (under a
    mesh its rows gathered over ``data``), prefill seconds and decode ms a
    step (host clock, each ending in a synchronise), and the state after
    the last step.  ``margins`` gets each step's least top-2 mass margin
    (under a mesh, the least over the ``data`` ranks)."""
    import torch
    from repro_torch.launch import mesh as M
    from repro_torch.serving import decode_step, prefill
    dev = toks.device
    _sync(dev)
    t0 = time.perf_counter()
    state, last = prefill(params, cfg, tokens=toks[:, :S], budget=budget,
                          max_len=max_len or S + steps, impl=impl, sctx=sctx)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    logs, ctrls = [last], []
    t0 = time.perf_counter()
    for t in range(S, S + steps):
        if margins is not None:
            margins.append([])
        state, lg = decode_step(params, cfg, state, token=toks[:, t],
                                impl=impl, sctx=sctx)
        logs.append(lg)
        if budget:
            ctrls.append([{k: x.clone() if sctx is None else
                           M.cat(x, sctx.mesh, ("data",))
                           for k, x in st["ctrl"].items()}
                          for st in state["layers"] if "ctrl" in st])
        if margins is not None and sctx is not None:
            least = torch.tensor([min(margins[-1], default=float("inf"))])
            margins[-1] = [float(torch.cat(M.gather(least, sctx.mesh,
                                                    "data")).min())]
    _sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"logits": logs, "ctrl": ctrls, "prefill_s": prefill_s,
            "step_ms": step_ms, "state": state}


def mg_serve(dev, mesh):
    """deepseek-7b at full width on the (data 2, model 2) mesh: bf16 at
    MG_SERVE_LAYERS layers in both regimes (the timed run, B2/B3 counted);
    then f32 at MG_F32_LAYERS layers, the sharded path with the kernels
    against the sharded plain versions on every rank and against the
    unsharded path on rank 0 (every rank's logits are rank 0's: the
    digests)."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import param_specs, shard_tree
    from repro_torch.serving import serve_step as ss
    sctx = M.shard_ctx(mesh, mode="serve")
    out = {"b2_launches": 0, "b3_launches": 0}

    def local_params(cfg):
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
        local = shard_tree(full, param_specs(param_shapes(cfg), cfg, sctx),
                           mesh)
        return full, local

    cfg = dataclasses.replace(ARCHS["deepseek-7b"], n_layers=MG_SERVE_LAYERS)
    full, local = local_params(cfg)
    del full
    _empty(dev)
    toks = prompt_tokens(cfg, MG_SERVE_B, MG_SERVE_S + MG_SERVE_STEPS, dev,
                         n=15)
    for budget in (0, MG_SERVE_BUDGET):
        fa.LAUNCHES = da.LAUNCHES = 0
        run = mg_serve_run(local, cfg, sctx, toks, MG_SERVE_S,
                           MG_SERVE_STEPS, budget)
        launches = (fa.LAUNCHES, da.LAUNCHES)
        want = (MG_SERVE_LAYERS, MG_SERVE_LAYERS * MG_SERVE_STEPS)
        if launches != want:
            raise AssertionError(f"sharded serve {budget}: B2/B3 launches "
                                 f"{launches}, expected {want}")
        out["b2_launches"] += launches[0]
        out["b3_launches"] += launches[1]
        if not all(bool(torch.isfinite(x).all()) for x in run["logits"]):
            raise AssertionError(f"sharded serve {budget}: logits not finite")
        out["bounded" if budget else "unbounded"] = {
            "prefill_s": run["prefill_s"], "step_ms": run["step_ms"],
            "logits_shape": list(run["logits"][-1].shape)}
    del local
    _empty(dev)

    # f32: sharded with kernels against unsharded with kernels and against
    # sharded with the plain versions
    cfg = dataclasses.replace(ARCHS["deepseek-7b"], n_layers=MG_F32_LAYERS,
                              param_dtype="float32")
    full, local = local_params(cfg)
    toks = prompt_tokens(cfg, MG_SERVE_B, MG_F32_S + MG_F32_STEPS, dev, n=16)
    top_slot = ss._top_slot
    margins = []

    def recording_top(mass, valid):
        if margins and rec[0]:
            top2 = mass.masked_fill(~valid, float("-inf")).topk(2).values
            margins[-1].append(float((top2[:, 0] - top2[:, 1]).min()))
        return top_slot(mass, valid)

    rec = [False]
    ss._top_slot = recording_top
    checks, rank = {}, torch.distributed.get_rank()
    try:
        for budget in (0, MG_SERVE_BUDGET):
            row = {}
            got = mg_serve_run(local, cfg, sctx, toks, MG_F32_S,
                               MG_F32_STEPS, budget)
            del margins[:]
            rec[0] = True
            plain = mg_serve_run(local, cfg, sctx, toks, MG_F32_S,
                                 MG_F32_STEPS, budget, impl="plain",
                                 margins=margins)
            rec[0] = False
            row["vs_plain"] = mg_compare(
                got, plain, [min(m, default=float("inf")) for m in margins],
                budget, f"sharded serve f32 {budget} vs plain")
            if rank == 0:           # every rank's logits are rank 0's
                del margins[:]
                rec[0] = True
                want = mg_serve_run(full, cfg, None, toks, MG_F32_S,
                                    MG_F32_STEPS, budget, margins=margins)
                rec[0] = False
                row["vs_unsharded"] = mg_compare(
                    got, want,
                    [min(m, default=float("inf")) for m in margins],
                    budget, f"sharded serve f32 {budget} vs unsharded")
            row["digest"] = _digest({str(i): x.cpu().numpy() for i, x in
                                     enumerate(got["logits"])})
            checks["bounded" if budget else "unbounded"] = row
    finally:
        ss._top_slot = top_slot
    del full, local
    _empty(dev)
    out["f32"] = checks
    return out


def mg_compare(got, want, margins, budget, what):
    """Whole-batch logits within SERVE_LOGIT_TOL up to the first step whose
    control state differs, which only a near-tie (the reference run's
    top-2 mass margin within MASS_TOL) may explain."""
    import torch
    errs = [float((a - b).abs().max()) for a, b in zip(got["logits"],
                                                       want["logits"])]
    diff = [t for t, (a, b) in enumerate(zip(got["ctrl"], want["ctrl"]))
            if any(not torch.equal(x[k], y[k]) for x, y in zip(a, b)
                   for k in x)]
    near = [t for t in diff if margins[t] <= MASS_TOL]
    if diff and diff[0] not in near:
        raise Mismatch(f"{what}: ctrl differs at step {diff[0]} with a "
                       f"top-2 margin {margins[diff[0]]} > {MASS_TOL}")
    first = diff[0] + 1 if diff else len(errs)
    if max(errs[:first]) > SERVE_LOGIT_TOL:
        raise Mismatch(f"{what}: logits differ by {max(errs[:first])} > "
                       f"{SERVE_LOGIT_TOL}")
    row = {"logits_max_abs_err": max(errs[:first]),
           "logits_compared": first, "tol": SERVE_LOGIT_TOL}
    if budget:
        row.update(ctrl_steps_differing=diff, near_tie_steps=near,
                   min_top2_margin=min(margins))
    return row


class MgRouting:
    """Records every MoE routing (the experts chosen) and dispatch (the
    choices kept), on the host, while entered."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []
        self.route, self.dispatch = moe.route, moe.dispatch

        def route(*a, **k):
            out = self.route(*a, **k)
            self.calls.append(out[0].cpu())
            return out

        def dispatch(*a, **k):
            out = self.dispatch(*a, **k)
            self.calls.append(out[1].cpu())
            return out

        moe.route, moe.dispatch = route, dispatch
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch = self.route, self.dispatch


# the channel dimension of a split recurrent state leaf, by layer kind
MG_CHANNEL_DIM = {"mamba": {"conv": 2, "h": 1},
                  "mlstm": {"conv": 2, "C": 1, "n": 1, "m": 1}}


def mg_whole_states(loc, state):
    """Every recurrent layer's state of this rank gathered over its channel
    blocks and the batch, on the host (a collective on every rank)."""
    out = {}
    for layer, st in enumerate(state["layers"]):
        kind = loc.kinds[layer]
        if kind in ("attn", "mla"):
            continue
        c = loc.chan[layer]
        rest = tuple(a for a in loc.b_axes if a not in c)
        for k, x in st.items():
            dim = MG_CHANNEL_DIM.get(kind, {}).get(k)
            if dim is not None and c:
                x = loc.cat(x, c, dim)
            out[f"{layer}.{k}"] = (loc.cat(x, rest) if rest else x).cpu()
    return out


def mg_arch_f32(dev, sctx, name):
    """``name`` at MG_F32_LAYERS layers in f32, B = 8 x MG_F32_S and
    MG_ARCH_STEPS steps, on the mesh against the unsharded port on rank 0
    (which builds and runs it alone first, then frees it, so that the
    card holds one whole model at a time): logits within SERVE_LOGIT_TOL,
    DAC's control equal unless a near-tie explains it, every MoE routing
    and drop equal, the recurrent states within MG_STATE_TOL; the sharded
    logits' digest (every rank's must be rank 0's)."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.models.model import local_view
    from repro_torch.serving import serve_step as ss
    cfg = dataclasses.replace(ARCHS[name], n_layers=MG_F32_LAYERS,
                              param_dtype="float32")
    toks = prompt_tokens(cfg, MG_SERVE_B, MG_F32_S + MG_ARCH_STEPS, dev,
                         n=17)
    rank = torch.distributed.get_rank()
    regimes = (("unbounded", 0), ("bounded", MG_SERVE_BUDGET))
    top_slot, margins, wants = ss._top_slot, [], {}
    t0 = time.perf_counter()

    def recording_top(mass, valid):
        if margins:
            top2 = mass.masked_fill(~valid, float("-inf")).topk(2).values
            margins[-1].append(float((top2[:, 0] - top2[:, 1]).min()))
        return top_slot(mass, valid)

    if rank == 0:
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
        ss._top_slot = recording_top
        try:
            for regime, budget in regimes:
                del margins[:]
                with MgRouting() as routing:
                    run = mg_serve_run(full, cfg, None, toks, MG_F32_S,
                                       MG_ARCH_STEPS, budget, margins=margins)
                states = {f"{i}.{k}": x.cpu()
                          for i, st in enumerate(run["state"]["layers"])
                          if cfg.period[i % len(cfg.period)].kind
                          not in ("attn", "mla") for k, x in st.items()}
                run["state"] = None
                wants[regime] = (run, routing.calls, states,
                                 [min(m, default=float("inf"))
                                  for m in margins])
        finally:
            ss._top_slot = top_slot
        del full, run
        _empty(dev)
    torch.distributed.barrier()
    rows = {"unsharded_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    local = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, sctx=sctx)
    _empty(dev)                         # the draws' slices
    _sync(dev)
    rows["build_s"] = time.perf_counter() - t0
    loc = local_view(cfg, sctx, MG_SERVE_B)
    for regime, budget in regimes:
        with MgRouting() as routing:
            got = mg_serve_run(local, cfg, sctx, toks, MG_F32_S,
                               MG_ARCH_STEPS, budget)
        states = mg_whole_states(loc, got["state"])
        got["state"] = None
        row = {"digest": _digest({str(i): x.cpu().numpy() for i, x in
                                  enumerate(got["logits"])})}
        if rank == 0:
            want, calls, want_states, least = wants[regime]
            row.update(mg_compare(got, want, least, budget,
                                  f"{name} f32 {regime} vs unsharded"))
            if len(calls) != len(routing.calls) or not all(
                    torch.equal(a, b) for a, b in zip(calls, routing.calls)):
                raise Mismatch(f"{name} f32 {regime}: MoE routing or drops "
                               "differ from the unsharded port's")
            row["moe_routings_equal"] = len(calls) // 2
            err = 0.0
            for k, w in want_states.items():
                e = float((states[k] - w).abs().max())
                if e > MG_STATE_TOL * max(1.0, float(w.abs().max())):
                    raise Mismatch(f"{name} f32 {regime}: state {k} differs "
                                   f"by {e}")
                err = max(err, e)
            row.update(state_max_abs_err=err, states=len(want_states),
                       state_tol=MG_STATE_TOL)
        rows[regime] = row
    del local, got
    _empty(dev)
    torch.distributed.barrier()
    rows["s"] = rows["unsharded_s"] + time.perf_counter() - t0
    return rows


def mg_serve_archs(dev, mesh):
    """MG_ARCHS on the (data 2, model 2) mesh: each rank builds only its
    blocks (``init_params(sctx=)``); bf16 in both regimes (timed, B2/B3
    counted on each rank), then the f32 check (``mg_arch_f32``).  Each
    model is freed before the next is built."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params
    sctx = M.shard_ctx(mesh, mode="serve")
    out = {}
    for name, layers in MG_ARCHS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(ARCHS[name], n_layers=layers)
        kinds = [cfg.period[i % len(cfg.period)].kind for i in range(layers)]
        attend = sum(k in ("attn", "mla") for k in kinds)
        want = (attend, kinds.count("attn") * MG_ARCH_STEPS)
        local = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev, sctx=sctx)
        _empty(dev)                     # the draws' slices
        _sync(dev)
        row = {"layers": layers, "build_s": time.perf_counter() - t0,
               "b2_launches": 0, "b3_launches": 0}
        toks = prompt_tokens(cfg, MG_SERVE_B, MG_SERVE_S + MG_ARCH_STEPS, dev,
                             n=18)
        for regime, budget in (("unbounded", 0), ("bounded",
                                                  MG_SERVE_BUDGET)):
            fa.LAUNCHES = da.LAUNCHES = 0
            run = mg_serve_run(local, cfg, sctx, toks, MG_SERVE_S,
                               MG_ARCH_STEPS, budget)
            launches = (fa.LAUNCHES, da.LAUNCHES)
            if launches != want:
                raise AssertionError(f"sharded {name} {regime}: B2/B3 "
                                     f"launches {launches}, expected {want}")
            if not all(bool(torch.isfinite(x).all()) for x in run["logits"]):
                raise AssertionError(f"sharded {name} {regime}: logits not "
                                     "finite")
            row["b2_launches"] += launches[0]
            row["b3_launches"] += launches[1]
            row[regime] = {"prefill_s": run["prefill_s"],
                           "step_ms": run["step_ms"],
                           "logits_shape": list(run["logits"][-1].shape)}
            del run
        del local
        _empty(dev)
        row["f32"] = mg_arch_f32(dev, sctx, name)
        row["s"] = time.perf_counter() - t0
        out[name] = row
    return out


# (b)'s training sub-phase (ROADMAP A13.3) on the (data 2, model 2) mesh of
# the 4 gloo ranks sharing the card, each rank building its blocks only:
# (a) deepseek-7b at full width, its depth cut to MG_TRAIN_LAYERS of 30
# (the only cut), bf16, B = MG_TRAIN_B x MG_TRAIN_S from the token
# pipeline, MG_TRAIN_STEPS steps through Trainer(sctx=) with f32 moments
MG_TRAIN_LAYERS, MG_TRAIN_B, MG_TRAIN_S, MG_TRAIN_STEPS = 2, 4, 512, 3
# (b) the same model in f32 at MG_TRAIN_F32_LAYERS layers, B =
# MG_TRAIN_F32_B x MG_TRAIN_F32_S, MG_TRAIN_F32_STEPS sharded steps against
# the unsharded port's on rank 0 (run first and alone): the loss within
# MG_TRAIN_LOSS_RTOL, rank 0's parameter blocks within
# TRAIN_VS_CPU_PARAM_REL of each leaf's largest magnitude (Adam's eps at
# 1e-3, as phase 14's card-against-CPU check, for the same reason); remat
# "none", which moves no weight twice ((a) runs the trainer's "full")
MG_TRAIN_F32_LAYERS, MG_TRAIN_F32_B, MG_TRAIN_F32_S = 1, 4, 128
MG_TRAIN_F32_STEPS = 2
MG_TRAIN_LOSS_RTOL = 1e-5
# (c) the compressed step at the smoke config on (pod 2, data 2, model 1),
# MG_COMP_STEPS steps beside the uncompressed sharded step; its last loss
# within MG_COMP_TRACK of the uncompressed one's (the reference test's
# bound); ef_allgather_mean on fixed inputs on the card and on the CPU
MG_COMP_STEPS, MG_COMP_TRACK = 8, 0.01
# ... and the cost of ef_allgather_mean's f64 pod sum (compression._pod_sum,
# there to equal XLA's CPU fused multiply-adds bit for bit) against an f32
# pass, at one full-width leaf of deepseek-7b (an MLP weight, d_model x
# d_ff) over 2 pods, on rank 0 while the others wait
MG_EF_SUM_SHAPE, MG_EF_SUM_REPS = (4096, 11008), 10
# (d) an elastic restart at the smoke config: MG_ELASTIC_SAVE steps on
# (data 2, model 2) with a checkpoint, resumed on (data 1, model 2) (ranks
# 0 and 1) to MG_ELASTIC_STEPS
MG_ELASTIC_SAVE, MG_ELASTIC_STEPS = 4, 8


def mg_train_full(dev, sctx):
    """(a): ``Trainer(sctx=)`` at full width, bf16, timed a step."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import param_count
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    cfg = dataclasses.replace(ARCHS["deepseek-7b"], n_layers=MG_TRAIN_LAYERS)
    _empty(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=MG_TRAIN_STEPS)
    tcfg = TrainConfig(steps=MG_TRAIN_STEPS, ckpt_dir=None,
                       global_batch=MG_TRAIN_B, seq_len=MG_TRAIN_S, seed=SEED)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, opt, tcfg, sctx=sctx)
    trainer.run()
    _sync(dev)
    run_s = time.perf_counter() - t0
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if len(hist) != MG_TRAIN_STEPS or not all(math.isfinite(x)
                                              for x in losses):
        raise AssertionError(f"sharded train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"sharded train: the loss did not fall: "
                             f"{losses}")
    dts = [h["dt"] for h in hist]
    out = {"arch": cfg.name, "layers": MG_TRAIN_LAYERS,
           "layers_of_config": ARCHS["deepseek-7b"].n_layers,
           "params": param_count(cfg), "dtype": cfg.param_dtype,
           "batch": MG_TRAIN_B, "seq": MG_TRAIN_S, "moments": "float32",
           "losses": losses, "step_s": dts, "run_s": run_s,
           "grad_norms": [h["grad_norm"] for h in hist],
           "peak_bytes": (torch.cuda.max_memory_allocated()
                          if dev == "cuda" else None)}
    del trainer
    _empty(dev)
    return out


def mg_train_f32(dev, sctx):
    """(b): the sharded f32 steps against the unsharded port's on rank 0,
    which runs first and alone, keeps the cut of its final parameters to
    its own blocks (on the host) and frees the card's copy."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import init_params, stacked_view
    from repro_torch.models.model import param_shapes
    from repro_torch.models.sharding import cuts, param_specs
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step
    from repro_torch.train.train_step import placement
    cfg = dataclasses.replace(ARCHS["deepseek-7b"],
                              n_layers=MG_TRAIN_F32_LAYERS,
                              param_dtype="float32")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1,
                      total_steps=MG_TRAIN_F32_STEPS, eps=1e-3)
    pipe = TokenPipeline(cfg.vocab, MG_TRAIN_F32_B, MG_TRAIN_F32_S,
                         seed=SEED)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch(t).items()}
               for t in range(MG_TRAIN_F32_STEPS)]
    rank = torch.distributed.get_rank()
    specs = param_specs(param_shapes(cfg), cfg, sctx)
    mine = cuts(param_shapes(cfg), specs, sctx.mesh)
    out = {"layers": MG_TRAIN_F32_LAYERS, "batch": MG_TRAIN_F32_B,
           "seq": MG_TRAIN_F32_S, "steps": MG_TRAIN_F32_STEPS}
    t0 = time.perf_counter()
    if rank == 0:
        whole = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        state = adamw.init(stacked_view(whole, cfg), opt)
        step = make_train_step(cfg, opt, remat="none")
        _sync(dev)
        out["unsharded_init_s"] = time.perf_counter() - t0
        want_losses, want_step_s = [], []
        for b in batches:
            t1 = time.perf_counter()
            whole, state, m = step(whole, state, b)
            want_losses.append(float(m["loss"]))
            want_step_s.append(time.perf_counter() - t1)
        cut_of = dict(flat_leaves(mine))
        want = {path: cut_of[path](x.detach()).cpu()
                for path, x in flat_leaves(whole)}
        del whole, state, step
        _empty(dev)
        out.update(unsharded_s=time.perf_counter() - t0,
                   unsharded_step_s=want_step_s)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    local = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, sctx=sctx)
    state = adamw.init(stacked_view(local, cfg), opt, placement(cfg, sctx))
    step = make_train_step(cfg, opt, sctx=sctx, remat="none")
    _sync(dev)
    out["sharded_init_s"] = time.perf_counter() - t0
    losses, step_s = [], []
    from repro_torch.models.sharding import _block
    for b in batches:
        _sync(dev)
        t1 = time.perf_counter()
        local, state, m = step(local, state, {
            k: _block(v, 0, sctx.mesh, sctx.batch_axes)
            for k, v in b.items()})
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t1)
    out.update(sharded_s=time.perf_counter() - t0, step_s=step_s,
               losses=losses,
               digest=_digest({"losses": __import__("numpy").array(losses)}))
    if rank == 0:
        gaps = [abs(g - w) / abs(w) for g, w in zip(losses, want_losses)]
        if max(gaps) > MG_TRAIN_LOSS_RTOL:
            raise Mismatch(f"sharded f32 train: losses {losses} against "
                           f"the unsharded {want_losses}")
        worst, worst_leaf = 0.0, None
        for path, x in flat_leaves(local):
            w = want[path]
            rel = float((x.detach().cpu() - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_leaf = rel, path
        if worst > TRAIN_VS_CPU_PARAM_REL:
            raise Mismatch(f"sharded f32 train: rank 0's {worst_leaf} "
                           f"differs by {worst} of the leaf's largest")
        out.update(unsharded_losses=want_losses, max_loss_rel_gap=max(gaps),
                   max_param_rel_gap=worst, worst_leaf=worst_leaf,
                   param_rel_tol=TRAIN_VS_CPU_PARAM_REL,
                   loss_rtol=MG_TRAIN_LOSS_RTOL)
    del local, state, step
    _empty(dev)
    torch.distributed.barrier()
    return out


def mg_train_compressed(dev):
    """(c): the compressed step and the uncompressed sharded step at the
    smoke config on (pod 2, data 2, model 1); ``ef_allgather_mean`` on
    fixed inputs on the card and on the CPU (the same gloo group)."""
    import numpy as np
    import torch
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params, stacked_view
    from repro_torch.models.sharding import _block
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import (compression, init_ef_state,
                                   make_compressed_train_step,
                                   make_train_step)
    from repro_torch.train.train_step import placement
    cfg = SMOKE_ARCHS["deepseek-7b"]
    mesh = M.make_test_mesh(data=2, model=1, pod=2)
    sctx = M.shard_ctx(mesh)
    inner = __import__("dataclasses").replace(sctx, pod=None)
    opt = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=0,
                      weight_decay=0.0)
    pipe = TokenPipeline(cfg.vocab, 8, 32)
    t0 = time.perf_counter()
    runs = {}
    for kind in ("plain", "compressed"):
        p = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, sctx=sctx)
        if kind == "plain":
            o = adamw.init(stacked_view(p, cfg), opt, placement(cfg, sctx))
            step = make_train_step(cfg, opt, sctx=sctx)
        else:
            place = placement(cfg, inner)
            o = adamw.init(stacked_view(p, cfg), opt, place)
            ef = init_ef_state(stacked_view(p, cfg), 2, place)
            step = make_compressed_train_step(cfg, opt, mesh, sctx=sctx)
        losses = []
        for t in range(MG_COMP_STEPS):
            b = {k: _block(torch.from_numpy(v).to(dev), 0, mesh,
                           sctx.batch_axes)
                 for k, v in pipe.batch(t).items()}
            if kind == "plain":
                p, o, m = step(p, o, b)
            else:
                p, o, ef, m = step(p, o, ef, b)
            losses.append(float(m["loss"]))
        runs[kind] = losses
    gap = abs(runs["plain"][-1] - runs["compressed"][-1])
    if gap > MG_COMP_TRACK or not all(math.isfinite(x)
                                      for x in runs["compressed"]):
        raise AssertionError(f"compressed step: last loss {gap} from the "
                             f"uncompressed step's ({runs})")
    rng = np.random.default_rng([SEED, M.axis_index(mesh, "pod"),
                                 M.axis_index(mesh, "data")])
    g = rng.standard_normal((3, 1000)).astype(np.float32)
    e = (rng.standard_normal((3, 1000)) * 1e-2).astype(np.float32)
    got = [compression.ef_allgather_mean(torch.from_numpy(g).to(d),
                                         torch.from_numpy(e).to(d), mesh,
                                         "pod") for d in (dev, "cpu")]
    for a, b, what in zip(got[0], got[1], ("mean", "error feedback")):
        if not torch.equal(a.cpu(), b):
            raise Mismatch(f"ef_allgather_mean's {what}: the card's differs "
                           "from the CPU's")
    out = {"arch": cfg.name, "dtype": cfg.param_dtype, "mesh": [2, 2, 1],
           "steps": MG_COMP_STEPS, "losses": runs, "last_loss_gap": gap,
           "track": MG_COMP_TRACK, "ef_mean_card_equals_cpu": True}
    if dev == "cuda" and torch.distributed.get_rank() == 0:
        out["pod_sum"] = ef_pod_sum_cost(dev)
    torch.distributed.barrier()
    out["s"] = time.perf_counter() - t0
    return out


def ef_pod_sum_cost(dev):
    """Milliseconds of ``compression._pod_sum`` (f64) and of an f32 pass
    over the same 2 pods' int8 blocks and scales, at MG_EF_SUM_SHAPE."""
    import torch
    from repro_torch.train import compression
    n = math.prod(MG_EF_SUM_SHAPE)
    blocks = -(-n // compression.BLOCK)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    qs = [torch.randint(-127, 128, (blocks, compression.BLOCK),
                        generator=gen, device=dev).to(torch.int8)
          for _ in range(2)]
    ss = [torch.rand(blocks, generator=gen, device=dev) for _ in range(2)]

    def f32():
        return qs[0].float() * ss[0][:, None] + qs[1].float() * ss[1][:, None]

    out = {"elements": n, "pods": 2,
           "f64_ms": cuda_ms(lambda: compression._pod_sum(qs, ss),
                             MG_EF_SUM_REPS),
           "f32_ms": cuda_ms(f32, MG_EF_SUM_REPS),
           "max_abs_diff": float((compression._pod_sum(qs, ss) - f32())
                                 .abs().max())}
    del qs, ss
    _empty(dev)
    return out


def mg_train_elastic(dev, ckpt_dir):
    """(d): a smoke-config run on (data 2, model 2) with a checkpoint,
    resumed on (data 1, model 2) by ranks 0 and 1."""
    import torch
    from repro_torch.configs import SMOKE_ARCHS
    from repro_torch.launch import mesh as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    cfg = SMOKE_ARCHS["deepseek-7b"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=MG_ELASTIC_STEPS)
    tcfg = TrainConfig(steps=MG_ELASTIC_STEPS, ckpt_dir=ckpt_dir,
                       ckpt_every=MG_ELASTIC_SAVE, global_batch=8,
                       seq_len=32, seed=SEED, async_ckpt=False)
    t0 = time.perf_counter()
    first = Trainer(cfg, opt, tcfg, sctx=M.shard_ctx(M.make_test_mesh(2, 2)))
    first.run(steps=MG_ELASTIC_SAVE)
    half = M.make_test_mesh(1, 2)       # every rank builds it; 0 and 1 run
    out = {"saved_on": [2, 2], "resumed_on": [1, 2],
           "first": [h["loss"] for h in first.history]}
    if torch.distributed.get_rank() < 2:
        second = Trainer(cfg, opt, tcfg, sctx=M.shard_ctx(half))
        second.run()
        hist = second.history
        out["resumed_from"] = hist[0]["step"] if hist else None
        out["resumed"] = [h["loss"] for h in hist]
        if out["resumed_from"] != MG_ELASTIC_SAVE or len(hist) != \
                MG_ELASTIC_STEPS - MG_ELASTIC_SAVE:
            raise AssertionError(f"elastic restart: resumed {out}")
        if not out["resumed"][-1] < out["first"][0]:
            raise AssertionError(f"elastic restart: the loss did not keep "
                                 f"falling: {out}")
    torch.distributed.barrier()
    out["s"] = time.perf_counter() - t0
    return out


def mg_train(dev, mesh, tmp):
    """(b)'s training sub-phase: (a)-(d) above; no B1, B2 or B3 launch.
    (a) runs first: a world's first full-width step takes ~10 s more
    than the next (the ranks' first kernel loads, pinned buffers and
    allocations, each rank waiting on the others' in the collectives),
    and (b)'s steps then find most of it done (PERF.md, PR 22)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import policy_step as ps
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    launches = (ps.LAUNCHES, fa.LAUNCHES, da.LAUNCHES)
    sctx = M.shard_ctx(mesh)
    out = {"full_width": mg_train_full(dev, sctx),
           "f32": mg_train_f32(dev, sctx),
           "compressed": mg_train_compressed(dev),
           "elastic": mg_train_elastic(dev, str(Path(tmp) / "train-ckpt"))}
    if (ps.LAUNCHES, fa.LAUNCHES, da.LAUNCHES) != launches:
        raise AssertionError("sharded training launched B1, B2 or B3")
    out["s"] = time.perf_counter() - t0
    return out


def mg_train_summary(rows):
    """(b)'s training sub-phase over the ranks: every rank's losses are
    rank 0's; rank 0's checks, each rank's step seconds and peak
    memory."""
    first = rows[0]
    for r, row in enumerate(rows):
        if row["f32"]["digest"] != first["f32"]["digest"]:
            raise Mismatch(f"(b) rank {r} sharded f32 train: losses not "
                           "rank 0's")
        for part in ("full_width", "compressed"):
            if row[part]["losses"] != first[part]["losses"]:
                raise Mismatch(f"(b) rank {r} {part} train: losses not "
                               "rank 0's")
    full = dict(first["full_width"])
    full["step_s"] = [row["full_width"]["step_s"] for row in rows]
    full["peak_bytes"] = [row["full_width"]["peak_bytes"] for row in rows]
    full["run_s"] = [row["full_width"]["run_s"] for row in rows]
    f32 = {k: v for k, v in first["f32"].items() if k != "digest"}
    f32["step_s"] = [row["f32"]["step_s"] for row in rows]
    return {"nvidia_smi": nvidia_smi_line(), "full_width": full,
            "f32": f32, "compressed": first["compressed"],
            "elastic": first["elastic"],
            "s": [row["s"] for row in rows]}


# (c) MG_SLOT_WORLD gloo ranks sharing the card on a (data 1, model 16)
# mesh: qwen1.5-110b at full width, its depth cut to 1 of 80 layers (the
# only cut): 8 KV heads do not split 16 ways, so its cache splits by slots
# (a rank holds 1/16 of them, every head), B3 runs as a partial on each
# rank's block and a merge over the ranks.  bf16, B = MG_SLOT_B x
# MG_SLOT_S, MG_SLOT_STEPS steps, both regimes (pool MG_SERVE_BUDGET),
# MG_SLOT_LEN slots unbounded (a multiple of 16); then f32, B = MG_SLOT_B x
# MG_SLOT_F32_S, MG_SLOT_F32_STEPS steps against the unsharded port on rank
# 0 (run first and alone), bounded in a pool of MG_SLOT_F32_BUDGET slots
# (3 a rank), fewer than the prompt's, so that every step evicts
MG_SLOT_WORLD, MG_SLOT_ARCH = 16, "qwen1.5-110b"
MG_SLOT_B, MG_SLOT_S, MG_SLOT_STEPS = 8, 128, 2
MG_SLOT_LEN = 144
MG_SLOT_F32_S, MG_SLOT_F32_STEPS, MG_SLOT_F32_LEN = 64, 2, 80
MG_SLOT_F32_BUDGET = 48


def mg_world_c(dev):
    """(c): the step's arguments on the card (rank 0's, which phase 17
    holds the dry run's reckoning to), the timed bf16 runs (B2 and B3's
    partial and merge counted on each rank; B3 whole never launches; KV
    bytes a rank against the unsharded cache's), then the f32 check
    (``mg_slot_f32``)."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as M
    from repro_torch.models import init_params
    from repro_torch.serving import serve_step as ss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = M.make_test_mesh(1, MG_SLOT_WORLD)
    sctx = M.shard_ctx(mesh, mode="serve")
    cfg = dataclasses.replace(ARCHS[MG_SLOT_ARCH], n_layers=1)
    cuda = torch.device(dev).type == "cuda"
    t0 = time.perf_counter()
    _sync(dev)
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    local = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, sctx=sctx)
    _empty(dev)                     # the draws' slices
    state = ss.init_serve_state(cfg, MG_SLOT_B, MG_SLOT_LEN, device=dev,
                                sctx=sctx)
    token = torch.zeros(MG_SLOT_B, dtype=torch.int64, device=dev)
    out = {"step_args": {
        "allocated_bytes": (torch.cuda.memory_allocated() - mem0 if cuda
                            else None),
        "B": MG_SLOT_B, "max_len": MG_SLOT_LEN,
        "kv_bytes": ss.kv_bytes(state)},
        "build_s": time.perf_counter() - t0, "launches": {}}
    del state, token
    toks = prompt_tokens(cfg, MG_SLOT_B, MG_SLOT_S + MG_SLOT_STEPS, dev, n=19)
    for regime, budget in (("unbounded", 0), ("bounded", MG_SERVE_BUDGET)):
        fa.LAUNCHES = da.LAUNCHES = 0
        da.PARTIAL_LAUNCHES = da.MERGE_LAUNCHES = 0
        run = mg_serve_run(local, cfg, sctx, toks, MG_SLOT_S, MG_SLOT_STEPS,
                           budget, max_len=MG_SLOT_LEN)
        launches = {"b2": fa.LAUNCHES, "b3": da.LAUNCHES,
                    "b3_partial": da.PARTIAL_LAUNCHES,
                    "b3_merge": da.MERGE_LAUNCHES}
        want = {"b2": 1, "b3": 0, "b3_partial": MG_SLOT_STEPS,
                "b3_merge": MG_SLOT_STEPS}
        if cuda and launches != want:
            raise AssertionError(f"(c) {regime}: launches {launches}, "
                                 f"expected {want}")
        for k, n in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + n
        if not all(bool(torch.isfinite(x).all()) for x in run["logits"]):
            raise AssertionError(f"(c) {regime}: logits not finite")
        L = budget or MG_SLOT_LEN
        whole = 2 * MG_SLOT_B * L * cfg.n_kv_heads * cfg.head_dim * \
            torch.empty((), dtype=cfg.dtype).element_size()
        mine = ss.kv_bytes(run["state"])
        if MG_SLOT_WORLD * mine != whole or not all(
                "slots" in st for st in run["state"]["layers"]):
            raise AssertionError(f"(c) {regime}: a rank holds {mine} KV "
                                 f"bytes of the whole cache's {whole}")
        out[regime] = {"prefill_s": run["prefill_s"],
                       "step_ms": run["step_ms"], "kv_bytes_rank": mine,
                       "kv_bytes_unsharded": whole, "slots": L,
                       "logits_shape": list(run["logits"][-1].shape)}
        del run
    del local
    _empty(dev)
    out["f32"] = mg_slot_f32(dev, sctx)
    return out


def mg_slot_f32(dev, sctx):
    """(c)'s model in f32 on the mesh against the unsharded port on rank 0
    (built and run alone first, then freed), both regimes (the bounded
    pool smaller than the prompt: its steps evict, checked): logits
    within SERVE_LOGIT_TOL, DAC's control equal unless a near-tie explains
    it; the sharded logits' digest (every rank's must be rank 0's)."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.models import init_params
    from repro_torch.serving import serve_step as ss
    cfg = dataclasses.replace(ARCHS[MG_SLOT_ARCH], n_layers=1,
                              param_dtype="float32")
    toks = prompt_tokens(cfg, MG_SLOT_B, MG_SLOT_F32_S + MG_SLOT_F32_STEPS,
                         dev, n=20)
    rank = torch.distributed.get_rank()
    regimes = (("unbounded", 0), ("bounded", MG_SLOT_F32_BUDGET))
    top_slot, margins, wants = ss._top_slot, [], {}
    run_kw = dict(max_len=MG_SLOT_F32_LEN)

    def recording_top(mass, valid):
        if margins:
            top2 = mass.masked_fill(~valid, float("-inf")).topk(2).values
            margins[-1].append(float((top2[:, 0] - top2[:, 1]).min()))
        return top_slot(mass, valid)

    t0 = time.perf_counter()
    if rank == 0:
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           device=dev)
        ss._top_slot = recording_top
        try:
            for regime, budget in regimes:
                del margins[:]
                run = mg_serve_run(full, cfg, None, toks, MG_SLOT_F32_S,
                                   MG_SLOT_F32_STEPS, budget, margins=margins,
                                   **run_kw)
                run["state"] = None
                wants[regime] = (run, [min(m, default=float("inf"))
                                       for m in margins])
        finally:
            ss._top_slot = top_slot
        del full, run
        _empty(dev)
    torch.distributed.barrier()
    rows = {"unsharded_s": time.perf_counter() - t0}
    local = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev, sctx=sctx)
    _empty(dev)
    for regime, budget in regimes:
        got = mg_serve_run(local, cfg, sctx, toks, MG_SLOT_F32_S,
                           MG_SLOT_F32_STEPS, budget, **run_kw)
        row = {"digest": _digest({str(i): x.cpu().numpy() for i, x in
                                  enumerate(got["logits"])})}
        if budget:
            row["evicting"] = pool_evicted(got["state"], budget,
                                           MG_SLOT_F32_S)
        got["state"] = None
        if rank == 0:
            want, least = wants[regime]
            row.update(mg_compare(got, want, least, budget,
                                  f"(c) f32 {regime} vs unsharded"))
        rows[regime] = row
    del local, got
    _empty(dev)
    torch.distributed.barrier()
    rows["s"] = time.perf_counter() - t0
    return rows


def pool_evicted(state, budget, S):
    """That every decode step after a prompt of ``S`` > ``budget`` tokens
    wrote over a live slot: each pooled layer's pool full at the end (its
    length the budget; DAC cannot shrink it in a few steps) and holding a
    decode step's token.  Raises otherwise; returns True."""
    for st in state["layers"]:
        ctrl = st.get("ctrl")
        if ctrl is None:
            continue
        if not (S > budget and bool((ctrl["length"] == budget).all())
                and bool((ctrl["slot_pos"].amax(-1) >= S).all())):
            raise AssertionError(f"the pool of {budget} slots did not "
                                 f"evict after a {S}-token prompt")
    return True


def mg_probe_gloo(dev):
    """Whether gloo's ``all_gather`` takes a tensor on ``dev`` (the one
    collective the port uses; the gloo ranks on the card rely on it)."""
    import torch
    x = torch.ones(4, device=dev)
    parts = [torch.empty_like(x) for _ in range(MG_WORLD)]
    try:
        torch.distributed.all_gather(parts, x)
    except RuntimeError as e:
        return f"refused: {str(e).splitlines()[0][:120]}"
    return "accepted"


def mg_wait(go, timeout=MG_TIMEOUT):
    """Wait for the file ``go`` (the parent's signal that (a) is done:
    (b)'s ranks start up while (a) runs, then measure alone)."""
    deadline = time.monotonic() + timeout
    while not Path(go).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"no start signal {go} after {timeout} s")
        time.sleep(0.02)


def mg_world_b(dev, go):
    """(b) MG_WORLD gloo ranks sharing the card: the sharded fleets,
    ``Engine(mesh=)`` at MG_LANES lanes, a small ``run_sweep(mesh=)``
    grid (rank 0 against the unsharded run on the card, every rank's
    result against rank 0's), and sharded serving on a (data 2, model 2)
    mesh: deepseek-7b, then MG_ARCHS."""
    import torch
    from repro_torch.bench import Scenario, Sweep, run_sweep
    from repro_torch.core import Engine
    from repro_torch.data.traces import family_footprint, k_for
    from repro_torch.kernels import policy_step as ps
    from repro_torch.launch import mesh as M
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.device(dev).type
    rank = torch.distributed.get_rank()
    line = torch.distributed.device_mesh.DeviceMesh(
        kind, torch.arange(MG_WORLD), mesh_dim_names=("data",))
    out = {"backend": torch.distributed.get_backend(), "b1_launches": 0,
           "gloo_cuda_all_gather": mg_probe_gloo(dev)}
    mg_wait(go)
    fleets = mg_fleets(dev, line)
    out["fleet"] = fleets
    out["b1_launches"] += sum(f["b1_launches"] for f in fleets.values())
    keys, sizes, costs = replay_inputs(MG_LANES, MG_LANES_T, dev, MG_FAMILY)
    K = k_for(family_footprint(MG_FAMILY), "L")
    out["replay"] = {}
    for spec in ("dac", "ac", "climb", MG_SLOT):
        T = MG_LANES_T if spec != MG_SLOT else SLOT_T
        kw = dict(sizes=sizes[:, :T], costs=costs[:, :T], **main_mode(spec))
        ps.LAUNCHES = 0
        _sync(dev)
        t0 = time.perf_counter()
        got = Engine(device=dev, mesh=line).replay(spec, keys[:, :T], K,
                                                   **kw)
        _sync(dev)
        s = time.perf_counter() - t0
        out["b1_launches"] += ps.LAUNCHES
        got = _arrays(got)
        row = {"T": T, "lanes": MG_LANES, "s": s, "launches": ps.LAUNCHES,
               "digest": _digest(got)}
        if rank == 0:                   # every rank's result is rank 0's
            want = Engine(device=dev).replay(spec, keys[:, :T], K, **kw)
            _equal_arrays(got, _arrays(want), f"(b) {spec}")
        out["replay"][spec] = row
    sw = Sweep("mesh", policies=("fifo", "lru", "dac", "ac", "climb"),
               seeds=tuple(range(MG_WORLD)),
               scenarios=(Scenario("zipf", trace="zipf(N=4096,alpha=0.9)",
                                   T=SLOT_T, K=("S", "L")),), observe=True)
    ps.LAUNCHES = 0
    got = run_sweep(sw, engine=Engine(device=dev), mesh=line)
    out["b1_launches"] += ps.LAUNCHES
    out["sweep_launches"] = ps.LAUNCHES
    out["sweep_records"] = [no_wall(r) for r in got.records]
    if rank == 0:
        want = run_sweep(sw, engine=Engine(device=dev))
        if out["sweep_records"] != [no_wall(r) for r in want.records]:
            raise Mismatch("(b) run_sweep(mesh=) records differ from the "
                           "unsharded grid's")
    out["sweep_cells"] = len(got.records)
    out["sweep_s"] = got.wall_s
    mesh = M.make_test_mesh(2, 2)
    out["serve"] = mg_serve(dev, mesh)
    archs = mg_serve_archs(dev, mesh)
    for k in ("b2_launches", "b3_launches"):
        out["serve"][k] += sum(row[k] for row in archs.values())
    out["serve"]["archs"] = archs
    out["train"] = mg_train(dev, mesh, Path(go).parent)
    return out


def phase_multi_gpu(dev, tmp):
    """Phase 15: the port's mesh, lane-sharded replay, the sharded fleet
    and sharded serving, in worlds of spawned ranks (the kernels are
    built already, so no rank builds one): (a) one NCCL rank, and beside
    it (b)'s fleets in MG_WORLD gloo ranks on the CPU; then (b) MG_WORLD
    gloo ranks sharing the card, which start up beside (a) and measure
    once (a) and the CPU world are done; then (c) MG_SLOT_WORLD gloo ranks
    sharing the card, slot-split KV caches (``mg_world_c``)."""
    from repro_torch.core.simulator import GRAPH_CHUNK
    from repro_torch.fleet import replay_fleet
    from repro_torch.launch import mesh as M
    t_phase = time.perf_counter()
    _empty(dev)
    tmp = Path(tmp)
    res = {"phase": "multi_gpu"}
    # four ranks share the card's 80 GB: the spawned ranks' allocators
    # grow segments instead of caching fixed blocks of freed models
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    go = tmp / "b-go"
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        b = pool.submit(M.launch_world, mg_world_b, MG_WORLD, (dev, str(go)),
                        init_file=str(tmp / "b"), backend="gloo",
                        device=dev, timeout=MG_TIMEOUT)
        t_cpu = time.perf_counter()
        cpu = pool.submit(M.launch_world, mg_world_cpu, MG_WORLD, (),
                          init_file=str(tmp / "cpu"), backend="gloo",
                          device="cpu", timeout=MG_TIMEOUT)
        t0 = time.perf_counter()
        try:
            a = M.launch_world(mg_world_a, 1, (dev,),
                               init_file=str(tmp / "a"),
                               backend="nccl" if dev == "cuda" else "gloo",
                               device=dev, timeout=MG_TIMEOUT)[0]
            a_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = cpu.result()
            cpu_s = time.perf_counter() - t_cpu
            cpu_after_a_s = time.perf_counter() - t0
        finally:
            go.touch()                  # (b) must not wait out its timeout
        t0 = time.perf_counter()
        b = b.result()
        b_s = time.perf_counter() - t0
    # (c) after (b), alone: starting its 16 ranks beside (a) and (b)
    # slowed both more than it saved
    t0 = time.perf_counter()
    slot = M.launch_world(mg_world_c, MG_SLOT_WORLD, (dev,),
                          init_file=str(tmp / "c"), backend="gloo",
                          device=dev, timeout=MG_TIMEOUT)
    slot_s = time.perf_counter() - t0
    for r, out in enumerate(slot):
        for regime in ("unbounded", "bounded"):
            if out["f32"][regime]["digest"] != \
                    slot[0]["f32"][regime]["digest"]:
                raise Mismatch(f"(c) rank {r} f32 {regime}: logits not "
                               "rank 0's")
    cpu_rank_s = [c[1] for c in cpu]
    cpu = [c[0] for c in cpu]
    for r, (out, want) in enumerate(zip(b, cpu)):
        for name, fl in out["fleet"].items():
            _equal_arrays(fl["arrays"], want[name],
                          f"(b) rank {r} fleet {name}: card vs CPU")
        # rank 0 held its results against the unsharded runs; the others
        # hold the same results
        for spec, row in out["replay"].items():
            if row["digest"] != b[0]["replay"][spec]["digest"]:
                raise Mismatch(f"(b) rank {r} {spec}: not rank 0's result")
        if out["sweep_records"] != b[0]["sweep_records"]:
            raise Mismatch(f"(b) rank {r}: run_sweep records not rank 0's")
        for regime, row in out["serve"]["f32"].items():
            if row["digest"] != b[0]["serve"]["f32"][regime]["digest"]:
                raise Mismatch(f"(b) rank {r} f32 {regime}: logits not "
                               "rank 0's")
        for name, arch in out["serve"]["archs"].items():
            for regime in ("unbounded", "bounded"):
                if arch["f32"][regime]["digest"] != \
                        b[0]["serve"]["archs"][name]["f32"][regime]["digest"]:
                    raise Mismatch(f"(b) rank {r} {name} f32 {regime}: "
                                   "logits not rank 0's")
    cases = mg_fleet_cases(dev)
    for name, tier, reqs, rebalance in cases:
        want = mg_fleet_launches(reqs.key.shape[0], rebalance, GRAPH_CHUNK)
        got = [out["fleet"][name]["b1_launches"] for out in b + [a]
               if name in out["fleet"]]
        if dev == "cuda" and any(n != want for n in got):
            raise AssertionError(f"fleet {name}: B1 launches {got} on the "
                                 f"ranks, expected {want} each")
    # the unsharded pool fleet on the card, beside the sharded one's step
    name, tier, reqs, rebalance = cases[1]
    _sync(dev)
    t0 = time.perf_counter()
    replay_fleet(tier, reqs, observe=True, device=dev)
    _sync(dev)
    unsharded_us = (time.perf_counter() - t0) * 1e6 / reqs.key.shape[0]
    fleet_rows = {}
    for name in b[0]["fleet"]:
        rows = [out["fleet"][name] for out in b]
        T = rows[0]["T"]
        fleet_rows[name] = {
            "T": T, "rebalance": dict((c[0], c[3]) for c in cases)[name],
            "us_a_step": [r["s"] * 1e6 / T for r in rows],
            "redeals": rows[0]["redeals"],
            "redeal_ms_median": [r["redeal_ms"][len(r["redeal_ms"]) // 2]
                                 if r["redeal_ms"] else None for r in rows],
            "b1_launches": [r["b1_launches"] for r in rows]}
    fleet_rows["pool"]["unsharded_us_a_step"] = unsharded_us
    for out in b:
        del out["sweep_records"]
        for row in out["replay"].values():
            del row["digest"]
        for row in out["serve"]["f32"].values():
            del row["digest"]
        for arch in out["serve"]["archs"].values():
            for regime in ("unbounded", "bounded"):
                del arch["f32"][regime]["digest"]
    # the summary of the MoE, MLA and recurrent models: over the ranks
    archs = {}
    for name, _ in MG_ARCHS:
        rows = [out["serve"]["archs"][name] for out in b]
        archs[name] = {
            "layers": rows[0]["layers"],
            **{f"{regime}_{k}": [r[regime][k] for r in rows]
               for regime in ("unbounded", "bounded")
               for k in ("prefill_s", "step_ms")},
            "b2_launches_a_rank": [r["b2_launches"] for r in rows],
            "b3_launches_a_rank": [r["b3_launches"] for r in rows],
            "f32_logits_max_abs_err": max(
                rows[0]["f32"][regime]["logits_max_abs_err"]
                for regime in ("unbounded", "bounded")),
            "f32": rows[0]["f32"], "s": [r["s"] for r in rows]}
    for out in b:
        del out["serve"]["archs"]
    for out in slot:
        for regime in ("unbounded", "bounded"):
            del out["f32"][regime]["digest"]
    res["c"] = {
        "world": MG_SLOT_WORLD, "arch": MG_SLOT_ARCH, "layers": 1,
        "mesh": {"data": 1, "model": MG_SLOT_WORLD}, "s": slot_s,
        "step_args": slot[0]["step_args"],
        **{f"{regime}_{k}": [out[regime][k] for out in slot]
           for regime in ("unbounded", "bounded")
           for k in ("prefill_s", "step_ms")},
        **{f"{regime}_kv_bytes": {
            "rank": slot[0][regime]["kv_bytes_rank"],
            "unsharded": slot[0][regime]["kv_bytes_unsharded"],
            "slots": slot[0][regime]["slots"]}
           for regime in ("unbounded", "bounded")},
        "launches_a_rank": [out["launches"] for out in slot],
        "build_s": [out["build_s"] for out in slot],
        "f32": slot[0]["f32"]}
    serve = [out["serve"] for out in b]
    train = mg_train_summary([out.pop("train") for out in b])
    a["fleet"] = {k: {f: v[f] for f in ("s", "T", "b1_launches", "redeals")}
                  for k, v in a["fleet"].items()}
    res["a"] = {"world": 1, **a, "s": a_s}
    res["b"] = {"world": MG_WORLD, "backend": b[0]["backend"],
                "s_after_a": b_s,
                "gloo_cuda_all_gather": b[0]["gloo_cuda_all_gather"],
                "fleet": fleet_rows,
                "replay": [out["replay"] for out in b],
                "sweep": {"cells": b[0]["sweep_cells"],
                          "s": [out["sweep_s"] for out in b],
                          "b1_launches": [out["sweep_launches"]
                                          for out in b]},
                "serve": serve, "serve_archs": archs, "train": train}
    # the CPU world's seconds: launch to result, the time it ran on after
    # (a) (holding (b) back), and each rank's fleets
    res["cpu_world"] = {"world": MG_WORLD, "s": cpu_s,
                        "after_a_s": cpu_after_a_s, "rank_s": cpu_rank_s}
    launches = {
        "b1": a["b1_launches"] + sum(out["b1_launches"] for out in b),
        "b2": sum(s["b2_launches"] for s in serve)
        + sum(out["launches"]["b2"] for out in slot),
        "b3": sum(s["b3_launches"] for s in serve),
        "b3_partial": sum(out["launches"]["b3_partial"] for out in slot),
        "b3_merge": sum(out["launches"]["b3_merge"] for out in slot)}
    if dev == "cuda" and not all(launches.values()):
        raise AssertionError(f"phase 15 launched a kernel no time: "
                             f"{launches}")
    res["launches"] = launches
    res["s"] = time.perf_counter() - t_phase
    if alloc is None:
        os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    else:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    return res, launches


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

    # f32 products in full f32 for the f32 comparisons (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    reports = _build.build(["policy_step", "flash_attention",
                            "decode_attention"])
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
    launches, main_ms, main_bound = phase_main(dev)
    emit({"phase": "main_path_launches", "policy_replay": launches,
          "ms_per_launch": main_ms, "bound_ms_per_launch": main_bound})
    emit(phase_large(dev))
    res, attn_err, attn = phase_attention(dev)
    emit(res)
    serve = phase_serve(dev)
    emit(serve)
    emit(phase_serve_vs_plain(dev))
    t0 = time.perf_counter()
    rows = phase_slot(dev)
    for row in rows:
        emit({"phase": "slot_policy", **row})
    emit({"phase": "slot_policies",
          "equal": "graph = cpu (T), graph = eager (eager_T)",
          "policies": len(SLOT_POLICIES), "groups": len(slot_groups()),
          "T": SLOT_T, "eager_T": SLOT_EAGER_T, "seeds": SLOT_SEEDS,
          "s": time.perf_counter() - t0})
    res, table_launches = phase_table(dev)
    emit(res)
    res, corpus_launches = phase_corpus(dev)
    emit(res)
    res, multi_launches = phase_multi(dev)
    emit(res)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-campaign-") as tmp:
        res, campaign_launches, report_text = phase_campaign(dev, tmp)
    emit(res)
    print(report_text, flush=True)
    res, arch_launches = phase_archs(dev)
    emit(res)
    emit(phase_train(dev))
    res, analysis_launches = phase_analysis(dev)
    emit(res)
    # the kernels are built: spawned ranks load them
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        res, mg_launches = phase_multi_gpu(dev, tmp)
    emit(res)
    emit(phase_dryrun(dev, serve, res["c"]["step_args"]))

    flash, dec = attn["flash"], attn["deepseek-7b unbounded"]
    part = attn["slot"][SLOT_TIMED]["partial"]
    merge = attn["slot"][SLOT_TIMED]["merge"]
    # every kernel was redesigned for the H100 after its port (B1, B2, B3
    # once each; the partial and the merge as one launch each)
    print(json.dumps({"kernels": [{
        "name": "policy_replay", "route": "cuda", "status": "redesigned",
        "source": "src/repro_torch/kernels/csrc/policy_step.cu",
        "replaces": "src/repro/kernels/policy_step.py:247",
        # the main path's replays, Table III's, the corpus sweeps', the
        # tier, fleet and admission sweeps' (counted at capture there),
        # the inline campaigns', phase 16's contract steps and audit and
        # phase 15's ranks' sharded replays
        "launches": launches + table_launches + corpus_launches
        + multi_launches + campaign_launches + analysis_launches
        + mg_launches["b1"],
        "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda", "status": "redesigned",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:107",
        # phase 6's prefills, phase 13's and phase 15's ranks'
        "launches": serve["unbounded"]["b2_launches"]
        + serve["bounded"]["b2_launches"] + arch_launches["b2"]
        + mg_launches["b2"],
        "max_abs_err": attn_err["flash"],
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"]}, {
        "name": "decode_attention", "route": "cuda", "status": "redesigned",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:136",
        # phase 6's decode steps, phase 13's and phase 15's ranks'
        "launches": serve["unbounded"]["b3_launches"]
        + serve["bounded"]["b3_launches"] + arch_launches["b3"]
        + mg_launches["b3"],
        "max_abs_err": attn_err["decode"],
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        # no single PyTorch call gives both o and the per-slot mass
        "library_ms": None}, {
        "name": "decode_attention_partial", "route": "cuda", "status": "redesigned",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:136",
        # phase 15's world (c): a step a layer on each of its ranks
        "launches": mg_launches["b3_partial"],
        "max_abs_err": attn_err["partial"],
        "ms": part["ms"], "plain_ms": part["plain_ms"],
        "bound_ms": part["bound_ms"], "bound_by": part["bound_by"],
        # no single PyTorch call gives a block's (acc, m, l) and scores
        "library_ms": None}, {
        "name": "decode_attention_merge", "route": "cuda", "status": "redesigned",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:161",
        "launches": mg_launches["b3_merge"],
        "max_abs_err": attn_err["merge"],
        "ms": merge["ms"], "plain_ms": merge["plain_ms"],
        "bound_ms": merge["bound_ms"], "bound_by": merge["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
