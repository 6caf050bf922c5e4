// Fused rank-policy step for Hopper (sm_90a): find + plan + shift + wipe.
//
// Replaces the TPU kernel `src/repro/kernels/policy_step.py`
// (`_batched_call`, `pl.pallas_call` at :247, body `_tiled_kernel`).  What it
// computes, per lane, over an int32 rank row of width W (a multiple of 128,
// EMPTY = -1 padding):
//
//   1. find       first rank m holding the key (m = W when absent; i = 0 then)
//   2. plan       the policy's control law (hit, i, scalars) ->
//                 (src, t, wipe_from, new scalars), a switch on a plan id:
//                 CLIMB, ADAPTIVECLIMB, DAC and DAC with an arbiter cap
//   3. evict      evicted = row[src] before the update
//   4. shift      ranks (t, src] move right by one
//   5. key        row[t] = key
//   6. wipe       ranks >= wipe_from become EMPTY
//
// The TPU kernel's float32 iota-min and 16-bit split sums worked around
// Mosaic's lack of integer vector reductions; here the find is an integer
// compare and a warp min.  The TPU's sequential (B, 2, n_tiles) grid with an
// SMEM carry becomes a loop over the row inside one warp or one block.
//
// One entry point, policy_replay: T steps over a [B, T] request block, the
// time loop inside the kernel (the engine's replacement for lax.scan);
// `evicted` is EMPTY on a hit, as the reference's StepInfo has it.  A
// single step (rank_step on CUDA tensors) is a replay of one request: on a
// hit src is the find's rank m, whose occupant is the key itself, so the
// wrapper gets the raw occupant row[src] back without a kernel of its own.
// Per-lane totals are summed one request at a time in the reference's order
// (simulator.py::_acc_step), so the float32 totals match it bit for bit.
//
// Bound on an H100: a step is a chain of dependent phases (find -> plan ->
// shift) over a few hundred ranks, so at the main path's widths it is bound
// by latency, not by bandwidth or the int32 rate (PERF.md gives the bound
// from the ranks this run's data needs, the find counted to the live
// width).  With one block per lane that latency goes to five or more block
// barriers a step.
//
// Design: a size dispatch (replay_path, exported as policy_replay_path).
//   * Rows of up to WARP_W ranks (Climb, AdaptiveClimb) or WARP_W_DAC (DAC):
//     one warp per lane (warp_step), every phase warp-synchronous, no block
//     barrier in the time loop.  The top 128 ranks live in registers, four
//     a lane; the rest of the row lives in shared memory for the whole
//     replay, one slice per warp.  The find tests the top chunk
//     in registers, then FIND_V 128-rank chunks a round from memory, 16
//     bytes a lane, with a vote per round on whether it holds the key; only
//     the round that does locates it (each lane's first match, then a
//     __reduce_min_sync).  For a key other than EMPTY the find stops at the
//     live width (n for Climb and AdaptiveClimb, k for DAC): ranks at and
//     past it are EMPTY after every step (the padding invariant, reference
//     core/policy.py:19-25), so no match lies there.  The key EMPTY still
//     scans the whole row, as the plain version does.  All 32 lanes
//     evaluate the plan from the same inputs, so nothing is broadcast.  The
//     shift moves a chunk at a time from the high end: 16-byte loads, the
//     rank below each lane's four by a rotation of the warp, __syncwarp,
//     16-byte stores; in the top chunk a rotation of registers.  The same
//     invariant makes the wipe a no-op except below max(live width,
//     src + 1).  Requests arrive 32 at a time, one per lane, the next 32 in
//     flight, and per-step outputs leave 32 at a time.  A lone warp issues
//     its instructions one after another, so its step costs in proportion
//     to the chunks it touches: that is why the warp path ends where it
//     does (PERF.md).
//   * Wider rows: one block of up to 1,024 threads per lane (block_step),
//     whose find is bounded the same way, with the row in shared memory up
//     to SMEM_ROW_LIMIT bytes and in device memory past it (the large
//     state: W = 419,456).
#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY_KEY (-1)
#define NO_MATCH 0x7fffffff
#define MAX_SC 5
#define SHIFT_V 4
#define SMEM_ROW_LIMIT (200 * 1024)
#define FIND_V 2          // warp path: chunks a find round compares
#define WARP_W 1024       // warp path: widest row, Climb and AdaptiveClimb
#define WARP_W_DAC 4096   // warp path: widest row, DAC
#define FULL_MASK 0xffffffffu

#define PLAN_CLIMB 0
#define PLAN_ADAPTIVECLIMB 1
#define PLAN_DAC 2
#define PLAN_DAC_BUDGETED 3

// floor(x / 2) for any sign, as jnp's `k // 2`
__device__ __forceinline__ int floor_half(int x) { return x >> 1; }

// DAC's shrink threshold -ceil(eps * (k // 2)) (control.py:82-117); eps
// arrives as float32 and the product is rounded once, as jnp computes it.
// It needs only k, so a step can have it before its find ends.
__device__ __forceinline__ int shrink_thresh(int pid, const int* sc,
                                             float eps) {
    return pid >= PLAN_DAC ? -(int)ceilf(eps * (float)floor_half(sc[2])) : 0;
}

// The policies' control laws.  Reads and updates sc in place.  Pure: every
// lane of a warp evaluates it on the same inputs and gets the same plan.
__device__ __forceinline__ void plan_eval(int pid, bool hit, int i, int* sc,
                                          int thresh, int k_min, int& src,
                                          int& t, int& wipe) {
    switch (pid) {
    case PLAN_CLIMB: {                       // baselines.py:171-177
        const int n = sc[0];
        src = hit ? i : n - 1;
        t = hit ? max(i - 1, 0) : n - 1;
        wipe = n;
        break;
    }
    case PLAN_ADAPTIVECLIMB: {               // adaptiveclimb.py:53-63
        const int jump = sc[0], n = sc[1];
        const int jump_h = max(jump - 1, 1);
        const int t_h = max(i - jump_h, 0);
        const int jump_m = min(jump + 1, n);
        const int t_m = n - jump_m;
        src = hit ? i : n - 1;
        t = hit ? t_h : t_m;
        wipe = n;
        sc[0] = hit ? jump_h : jump_m;
        break;
    }
    default: {                               // dynamicadaptiveclimb.py:135-169
        int jump = sc[0], jump2 = sc[1];
        const int k = sc[2], kmax = sc[3];
        const int half = floor_half(k);
        // hit_update (control.py:48-65)
        const int jump_h = jump > -half ? jump - 1 : jump;
        const int jump2_h = (i < half) ? (jump2 > -half ? jump2 - 1 : jump2)
                                       : (jump2 < 0 ? jump2 + 1 : jump2);
        const int actual_h = max(1, min(jump_h, i));
        const int t_h = i > 0 ? i - actual_h : 0;
        // miss_update (control.py:68-79)
        const int jump_m = min(jump + 1, 2 * k);
        const int jump2_m = jump2 < 0 ? jump2 + 1 : jump2;
        const int actual_m = max(1, min(k - 1, jump_m));
        const int t_m = k - actual_m;
        src = hit ? i : k - 1;
        t = hit ? t_h : t_m;
        jump = hit ? jump_h : jump_m;
        jump2 = hit ? jump2_h : jump2_m;
        // resize_update (control.py:82-117), with the shrink threshold
        // from shrink_thresh
        if (jump == 0) jump2 = 0;
        int k_grow;
        bool grow;
        if (pid == PLAN_DAC) {
            k_grow = 2 * k;
            grow = (jump >= 2 * k) && (2 * k <= kmax);
        } else {
            k_grow = min(2 * k, min(sc[4], kmax));
            grow = (jump >= 2 * k) && (k_grow > k);
        }
        const bool shrink = !grow && (jump <= -half) && (jump2 <= thresh) &&
                            (half >= k_min);
        const int k_new = grow ? k_grow : (shrink ? half : k);
        jump = shrink ? 0 : min(max(jump, -floor_half(k_new)), 2 * k_new);
        if (grow || shrink) jump2 = 0;
        wipe = shrink ? k_new : kmax;
        sc[0] = jump;
        sc[1] = jump2;
        sc[2] = k_new;
        break;
    }
    }
}

// Ranks at and past the live width are EMPTY (the padding invariant).
__device__ __forceinline__ int live_width(int pid, const int* sc, int W) {
    const int n = pid == PLAN_CLIMB ? sc[0]
                : pid == PLAN_ADAPTIVECLIMB ? sc[1] : sc[2];
    return min(max(n, 0), W);
}

// How far block_step's find must look: the whole row for the key EMPTY,
// else the live width rounded up to whole 16-byte words.
__device__ __forceinline__ int find_limit(int key, int pid, const int* sc,
                                          int W) {
    return key == EMPTY_KEY ? W : (live_width(pid, sc, W) + 3) & ~3;
}

struct StepOut {
    int hit, m, src, t, wipe, evicted;
};

// ---------------------------------------------------------------------------
// one warp per lane
// ---------------------------------------------------------------------------

__device__ __forceinline__ int shifted(int r, int t, int src, int key,
                                       int below, int cur) {
    return r == t ? key : (r > t && r <= src) ? below : cur;
}

// This lane's first match of `key` among its four ranks idx..idx+3 of a
// chunk, NO_MATCH if none.
__device__ __forceinline__ int first_match(int4 x, int key, int idx) {
    int c = x.w == key ? idx + 3 : NO_MATCH;
    c = x.z == key ? idx + 2 : c;
    c = x.y == key ? idx + 1 : c;
    return x.x == key ? idx : c;
}

// Whether this lane's four ranks hold `key`.
__device__ __forceinline__ bool has_key(int4 x, int key) {
    return (x.x == key) | (x.y == key) | (x.z == key) | (x.w == key);
}

__device__ __forceinline__ int component(int4 x, int j) {
    return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
}

// This lane's four ranks r0..r0+3 after the step: ranks in (t, src] take the
// rank below, rank t the key, the others stay.
__device__ __forceinline__ int4 shifted4(int4 x, int r0, int t, int src,
                                        int key, int below) {
    int4 y;
    y.x = shifted(r0, t, src, key, below, x.x);
    y.y = shifted(r0 + 1, t, src, key, x.x, x.y);
    y.z = shifted(r0 + 2, t, src, key, x.y, x.z);
    y.w = shifted(r0 + 3, t, src, key, x.z, x.w);
    return y;
}

// One step of one lane by one warp.  Every lane calls it with the same key
// and scalars `sc` (updated in place, in registers).  The top 128 ranks
// live in registers, four a lane (`top`); ranks 128 and up in `row`
// (shared memory, 16-byte aligned; its first 128 ranks are not
// read or written).  A lone warp issues its instructions one after another,
// so the step is kept short: a step that stays in the top chunk touches no
// memory, and below the top only the 128-rank chunks a phase needs are
// touched.
template <int PID>
__device__ __forceinline__ StepOut warp_step(int* row, int4& top, int W,
                                             int key, float eps, int k_min,
                                             int* sc, int lane) {
    int4* row4 = reinterpret_cast<int4*>(row);
    const int live = live_width(PID, sc, W);
    // the chunks below the live width (the whole row for the key EMPTY)
    const int n_find = key == EMPTY_KEY ? W >> 7 : (live + 127) >> 7;

    // DAC's shrink threshold needs only k: off the find's path
    const int thresh = shrink_thresh(PID, sc, eps);

    // 1. find: the top chunk in registers, then FIND_V chunks a round from
    //    memory; a vote on whether the round holds the key (four compares a
    //    lane), and only in the round that does, each lane's first match
    //    and the warp's least
    int m = W;
    if (__any_sync(FULL_MASK, has_key(top, key))) {
        m = __reduce_min_sync(FULL_MASK, first_match(top, key, lane * 4));
    } else {
        for (int c0 = 1; c0 < n_find; c0 += FIND_V) {
            int4 x[FIND_V];
            bool any = false;
#pragma unroll
            for (int u = 0; u < FIND_V; ++u) {
                x[u] = make_int4(~key, ~key, ~key, ~key);
                if (c0 + u < n_find) x[u] = row4[(c0 + u) * 32 + lane];
                any |= has_key(x[u], key);
            }
            if (__any_sync(FULL_MASK, any)) {
                int cand = NO_MATCH;
#pragma unroll
                for (int u = 0; u < FIND_V; ++u)
                    cand = min(cand, first_match(x[u], key,
                                                 (c0 + u) * 128 + lane * 4));
                m = __reduce_min_sync(FULL_MASK, cand);
                break;
            }
        }
    }

    // 2. plan (every lane, same result)
    StepOut o;
    o.hit = m < W;
    o.m = m;
    plan_eval(PID, o.hit, o.hit ? m : 0, sc, thresh, k_min, o.src, o.t,
              o.wipe);
    o.wipe = max(o.wipe, 0);
    const int src = o.src, t = o.t;

    // 3. evict
    if (src < 128)
        o.evicted = __shfl_sync(FULL_MASK, component(top, src & 3), src >> 2);
    else
        o.evicted = row[src];

    // 4-5. ranks (t, src] take the rank below, rank t the key: the chunks
    //      in memory one at a time from the high end (loads, the rank below
    //      each lane's four by a rotation of the warp, __syncwarp, stores),
    //      then the top chunk in registers
    if (src == t && t >= 128) {
        if (lane == 0) row[t] = key;
    } else {
        for (int c = src >> 7; c >= max(t >> 7, 1); --c) {
            const int4 x = row4[c * 32 + lane];
            // lane 0's rank below: the end of the chunk below
            const int edge = c == 1 ? __shfl_sync(FULL_MASK, top.w, 31)
                             : lane == 0 && c * 128 > t ? row[c * 128 - 1]
                                                        : 0;
            const int rot = __shfl_sync(FULL_MASK, x.w, (lane + 31) & 31);
            __syncwarp();
            row4[c * 32 + lane] =
                shifted4(x, c * 128 + lane * 4, t, src, key,
                         lane > 0 ? rot : edge);
        }
        if (t < 128) {
            const int rot = __shfl_sync(FULL_MASK, top.w, (lane + 31) & 31);
            top = shifted4(top, lane * 4, t, src, key, rot);
        }
    }

    // 6. wipe ranks >= wipe_from (over t too: the wipe wins, as in the
    //    reference).  Ranks at and past max(live, src + 1) were EMPTY before
    //    the step and were not written, so only the ranks below that need it
    //    (a DAC shrink); elsewhere the wipe is a no-op
    const int w_end = min(max(live, src + 1), W);
    if (o.wipe < w_end) {
        if (o.wipe < 128) {
            const int r0 = lane * 4;
            const int lo = o.wipe, hi = w_end;
            if (r0 >= lo && r0 < hi) top.x = EMPTY_KEY;
            if (r0 + 1 >= lo && r0 + 1 < hi) top.y = EMPTY_KEY;
            if (r0 + 2 >= lo && r0 + 2 < hi) top.z = EMPTY_KEY;
            if (r0 + 3 >= lo && r0 + 3 < hi) top.w = EMPTY_KEY;
        }
        __syncwarp();
        for (int r = max(o.wipe, 128) + lane; r < w_end; r += 32)
            row[r] = EMPTY_KEY;
    }
    __syncwarp();
    return o;
}

__device__ __forceinline__ void load_scalars(int* sc, const int* src,
                                             int n_sc) {
#pragma unroll
    for (int q = 0; q < MAX_SC; ++q) sc[q] = q < n_sc ? src[q] : 0;
}

__device__ __forceinline__ void store_scalars(int* dst, const int* sc,
                                              int n_sc) {
#pragma unroll
    for (int q = 0; q < MAX_SC; ++q)
        if (q < n_sc) dst[q] = sc[q];
}

template <int PID>
__global__ void __launch_bounds__(128) policy_replay_warp_kernel(
        int* __restrict__ rows, int* __restrict__ sc_io,
        const int* __restrict__ keys, const int* __restrict__ sizes,
        const float* __restrict__ costs, int B, int W, int T, int n_sc,
        float eps, int k_min, unsigned char* info_hit, int* info_ev,
        int* obs, long long* counts, float* sums, long long* work) {
    extern __shared__ int4 smem_rows[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;
    int4* grow = reinterpret_cast<int4*>(rows + (size_t)b * W);
    int4* row4 = smem_rows + (size_t)warp * (W / 4);
    for (int r = lane; r < W / 4; r += 32) row4[r] = grow[r];
    __syncwarp();
    int* row = reinterpret_cast<int*>(row4);
    int4 top = row4[lane];              // ranks 0..127, in registers
    int sc[MAX_SC];
    load_scalars(sc, sc_io + b * n_sc, n_sc);
    const size_t off = (size_t)b * T;

    // per-lane totals, kept alike by every lane, in the order of
    // simulator.py::_acc_step
    long long hits = 0, scanned = 0, moved = 0, wiped = 0;
    float bytes_total = 0.f, bytes_missed = 0.f, cost_total = 0.f,
          penalty = 0.f;
    // requests 32 at a time, one per lane; the next 32 are in flight
    int nk = 0, ns = 0;
    float nc = 0.f;
    if (lane < T) {
        nk = keys[off + lane];
        ns = sizes[off + lane];
        nc = costs[off + lane];
    }
    for (int g0 = 0; g0 < T; g0 += 32) {
        const int n = min(32, T - g0);
        const int ck = nk, cs = ns;
        const float cc = nc;
        if (g0 + 32 + lane < T) {
            nk = keys[off + g0 + 32 + lane];
            ns = sizes[off + g0 + 32 + lane];
            nc = costs[off + g0 + 32 + lane];
        }
        int my_hit = 0, my_ev = 0, my_obs[MAX_SC];
        // this group's counts: 32 steps of at most W ranks fit 32 bits
        int g_hits = 0, g_scanned = 0, g_moved = 0, g_wiped = 0;
        int key = __shfl_sync(FULL_MASK, ck, 0);
        for (int j = 0; j < n; ++j) {
            const int key_next = __shfl_sync(FULL_MASK, ck, (j + 1) & 31);
            const StepOut o = warp_step<PID>(row, top, W, key, eps, k_min,
                                             sc, lane);
            key = key_next;
            const int size = __shfl_sync(FULL_MASK, cs, j);
            const float cost = __shfl_sync(FULL_MASK, cc, j);
            g_hits += o.hit;
            bytes_total += (float)size;
            bytes_missed += o.hit ? 0.f : (float)size;
            cost_total += cost;
            penalty += o.hit ? 0.f : cost;
            g_scanned += o.hit ? o.m + 1 : W;
            g_moved += o.src - o.t;
            g_wiped += W - min(o.wipe, W);
            if (lane == j) {
                my_hit = o.hit;
                my_ev = o.hit ? EMPTY_KEY : o.evicted;
#pragma unroll
                for (int q = 0; q < MAX_SC; ++q) my_obs[q] = sc[q];
            }
        }
        hits += g_hits;
        scanned += g_scanned;
        moved += g_moved;
        wiped += g_wiped;
        if (lane < n) {
            const size_t at = off + g0 + lane;
            if (info_hit) {
                info_hit[at] = (unsigned char)my_hit;
                info_ev[at] = my_ev;
            }
            if (obs) store_scalars(obs + at * n_sc, my_obs, n_sc);
        }
    }
    row4[lane] = top;
    __syncwarp();
    for (int r = lane; r < W / 4; r += 32) grow[r] = row4[r];
    if (lane == 0) {
        store_scalars(sc_io + b * n_sc, sc, n_sc);
        counts[b * 2 + 0] = T;
        counts[b * 2 + 1] = hits;
        sums[b * 4 + 0] = bytes_total;
        sums[b * 4 + 1] = bytes_missed;
        sums[b * 4 + 2] = cost_total;
        sums[b * 4 + 3] = penalty;
        work[b * 3 + 0] = scanned;
        work[b * 3 + 1] = moved;
        work[b * 3 + 2] = wiped;
    }
}

// ---------------------------------------------------------------------------
// one block per lane (rows past the warp path), the row in shared memory up
// to SMEM_ROW_LIMIT bytes, in device memory past it
// ---------------------------------------------------------------------------

struct StepShared {
    int min_idx;        // find result (W = not found)
    int src, t, wipe;   // plan outputs
    int hit, evicted;
    int sc[MAX_SC];     // control scalars, carried across steps
};

// One step of one lane.  Every thread of the block calls it; `row` must be
// 16-byte aligned.  On return (after the final barrier) `s` holds the
// step's results and the new scalars.
__device__ void block_step(int* row, int W, int key, int pid, float eps,
                           int k_min, StepShared& s) {
    const int tid = threadIdx.x, nt = blockDim.x;

    // 1. find: strided int4 compares, chunk by chunk, stopping at the first
    //    chunk that holds the key, and for DAC at the live width k (see the
    //    header; the live width n of Climb and AdaptiveClimb is the row's
    //    capacity)
    if (tid == 0) s.min_idx = W;
    __syncthreads();
    const int lim = pid >= PLAN_DAC ? find_limit(key, pid, s.sc, W) : W;
    for (int base = 0; base < lim; base += nt * 4) {
        const int idx = base + tid * 4;
        int local = W;
        if (idx < lim) {
            const int4 v = *reinterpret_cast<const int4*>(row + idx);
            if (v.x == key) local = idx;
            else if (v.y == key) local = idx + 1;
            else if (v.z == key) local = idx + 2;
            else if (v.w == key) local = idx + 3;
        }
        if (local < W) atomicMin(&s.min_idx, local);
        if (__syncthreads_or(local < W)) break;
    }

    // 2-3. plan and evict, on one thread
    if (tid == 0) {
        const int m = s.min_idx;
        const bool hit = m < W;
        int src, t, wipe;
        plan_eval(pid, hit, hit ? m : 0, s.sc, shrink_thresh(pid, s.sc, eps),
                  k_min, src, t, wipe);
        s.src = src;
        s.t = t;
        s.wipe = wipe;
        s.hit = hit;
        s.evicted = row[src];
    }
    __syncthreads();
    const int src = s.src, t = s.t, wipe = max(s.wipe, 0);

    // 4. shift (t, src] right by one, high ranks first: each chunk reads,
    //    then writes, so no chunk reads what another has written
    for (int hi = src; hi > t; hi -= nt * SHIFT_V) {
        int v[SHIFT_V];
#pragma unroll
        for (int j = 0; j < SHIFT_V; ++j) {
            const int r = hi - tid - j * nt;
            if (r > t) v[j] = row[r - 1];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < SHIFT_V; ++j) {
            const int r = hi - tid - j * nt;
            if (r > t) row[r] = v[j];
        }
        __syncthreads();
    }

    // 5. key at t (a wipe over t wins, as in the reference)
    if (tid == 0 && t < wipe) row[t] = key;
    // 6. wipe
    for (int r = wipe + tid; r < W; r += nt) row[r] = EMPTY_KEY;
    __syncthreads();
}

// at most 1024 threads a block (threads_for), so at most 64 registers each
__global__ void __launch_bounds__(1024) policy_replay_block_kernel(
        int* __restrict__ rows, int* __restrict__ sc,
        const int* __restrict__ keys, const int* __restrict__ sizes,
        const float* __restrict__ costs, int W, int T, int n_sc, int pid,
        float eps, int k_min, int resident, unsigned char* info_hit,
        int* info_ev, int* obs, long long* counts, float* sums,
        long long* work) {
    extern __shared__ int4 smem_row[];
    __shared__ StepShared s;
    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    int* grow = rows + (size_t)b * W;
    int* row = grow;
    if (resident) {
        row = reinterpret_cast<int*>(smem_row);
        for (int r = tid; r < W; r += nt) row[r] = grow[r];
    }
    if (tid < n_sc) s.sc[tid] = sc[b * n_sc + tid];
    const size_t off = (size_t)b * T;

    // per-lane totals, one thread, in the order of simulator.py::_acc_step
    long long hits = 0, scanned = 0, moved = 0, wiped = 0;
    float bytes_total = 0.f, bytes_missed = 0.f, cost_total = 0.f,
          penalty = 0.f;
    for (int step = 0; step < T; ++step) {
        block_step(row, W, keys[off + step], pid, eps, k_min, s);
        if (tid == 0) {
            const int hit = s.hit;
            const int size = sizes[off + step];
            const float cost = costs[off + step];
            hits += hit;
            bytes_total += (float)size;
            bytes_missed += hit ? 0.f : (float)size;
            cost_total += cost;
            penalty += hit ? 0.f : cost;
            scanned += hit ? s.min_idx + 1 : W;
            moved += s.src - s.t;
            wiped += W - min(max(s.wipe, 0), W);
            if (info_hit) {
                info_hit[off + step] = (unsigned char)hit;
                info_ev[off + step] = hit ? EMPTY_KEY : s.evicted;
            }
            if (obs) {
                for (int q = 0; q < n_sc; ++q)
                    obs[(off + step) * n_sc + q] = s.sc[q];
            }
        }
    }
    if (resident) {
        for (int r = tid; r < W; r += nt) grow[r] = row[r];
    }
    if (tid < n_sc) sc[b * n_sc + tid] = s.sc[tid];
    if (tid == 0) {
        counts[b * 2 + 0] = T;
        counts[b * 2 + 1] = hits;
        sums[b * 4 + 0] = bytes_total;
        sums[b * 4 + 1] = bytes_missed;
        sums[b * 4 + 2] = cost_total;
        sums[b * 4 + 3] = penalty;
        work[b * 3 + 0] = scanned;
        work[b * 3 + 1] = moved;
        work[b * 3 + 2] = wiped;
    }
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

// The size dispatch.  The warp path takes rows of up to WARP_W ranks for
// Climb and AdaptiveClimb (their live width is the whole row) and
// WARP_W_DAC for DAC (whose active size k mostly sits well below the row's
// kmax); wider rows take the block path, with the row in shared memory up
// to SMEM_ROW_LIMIT bytes.  The two widths are not derived from a cost
// model: a warp's step costs in proportion to the live width and the
// chunks it touches, which W does not give.  They are set so that the main
// path's narrower groups (W = 896 for Climb and AdaptiveClimb, 3,328 for
// DAC) take the warp path and its wider ones (1,664 and 6,656) the block
// path; between and past those rows either path may be the faster
// (PERF.md).
enum ReplayPath { PATH_WARP = 0, PATH_BLOCK_SHARED = 1, PATH_BLOCK_DEVICE = 2 };

static ReplayPath replay_path(int W, int pid) {
    if (W <= (pid >= PLAN_DAC ? WARP_W_DAC : WARP_W)) return PATH_WARP;
    return (size_t)W * sizeof(int) <= SMEM_ROW_LIMIT ? PATH_BLOCK_SHARED
                                                     : PATH_BLOCK_DEVICE;
}

// The warp kernel's instantiation for a plan id.
static auto replay_warp_kernel(int pid) {
    return pid == PLAN_CLIMB ? policy_replay_warp_kernel<PLAN_CLIMB>
           : pid == PLAN_ADAPTIVECLIMB
               ? policy_replay_warp_kernel<PLAN_ADAPTIVECLIMB>
           : pid == PLAN_DAC ? policy_replay_warp_kernel<PLAN_DAC>
                             : policy_replay_warp_kernel<PLAN_DAC_BUDGETED>;
}

static int threads_for(int W) {
    int n = (W / 4 + 31) / 32 * 32;
    return n < 128 ? 128 : (n > 1024 ? 1024 : n);
}

static bool bad_args(int W, int n_sc, int pid) {
    return W <= 0 || W % 128 != 0 || n_sc < 0 || n_sc > MAX_SC ||
           pid < PLAN_CLIMB || pid > PLAN_DAC_BUDGETED;
}

// T steps on B lanes over keys/sizes/costs [B, T].  rows and sc are
// updated in place.  info_hit (uint8) / info_ev (int32) [B, T] are written
// when non-null, obs [B, T, n_sc] (the scalars after each step) when
// non-null; counts [B, 2] int64 (requests, hits), sums [B, 4] float32
// (bytes_total, bytes_missed, cost_total, penalty) and work [B, 3] int64
// (ranks scanned, moved, wiped) always.  Returns cudaGetLastError().
extern "C" int policy_replay(void* rows, void* sc, const void* keys,
                             const void* sizes, const void* costs, int B,
                             int W, int T, int n_sc, int pid, float eps,
                             int k_min, void* info_hit, void* info_ev,
                             void* obs, void* counts, void* sums, void* work,
                             void* stream) {
    if (bad_args(W, n_sc, pid) || B < 0 || T < 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t row_bytes = (size_t)W * sizeof(int);
    const ReplayPath path = replay_path(W, pid);
    if (path != PATH_WARP) {
        // one block per lane, the row in shared memory when it fits
        const int resident = path == PATH_BLOCK_SHARED;
        const size_t smem = resident ? row_bytes : 0;
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                policy_replay_block_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        policy_replay_block_kernel<<<B, threads_for(W), smem, st>>>(
            (int*)rows, (int*)sc, (const int*)keys, (const int*)sizes,
            (const float*)costs, W, T, n_sc, pid, eps, k_min, resident,
            (unsigned char*)info_hit, (int*)info_ev, (int*)obs,
            (long long*)counts, (float*)sums, (long long*)work);
        return (int)cudaGetLastError();
    }
    // one warp per lane, the row in shared memory; lanes per block: spread
    // over the SMs first, at most four a block
    int lpb = B / 132;
    lpb = lpb < 1 ? 1 : (lpb > 4 ? 4 : lpb);
    const size_t smem = lpb * row_bytes;
    auto kern = replay_warp_kernel(pid);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kern<<<(B + lpb - 1) / lpb, 32 * lpb, smem, st>>>(
        (int*)rows, (int*)sc, (const int*)keys, (const int*)sizes,
        (const float*)costs, B, W, T, n_sc, eps, k_min,
        (unsigned char*)info_hit, (int*)info_ev, (int*)obs,
        (long long*)counts, (float*)sums, (long long*)work);
    return (int)cudaGetLastError();
}

// Which path policy_replay takes for a row of W ranks under plan pid
// (enum ReplayPath); -1 for arguments policy_replay refuses.
extern "C" int policy_replay_path(int W, int pid) {
    return bad_args(W, 0, pid) ? -1 : (int)replay_path(W, pid);
}
